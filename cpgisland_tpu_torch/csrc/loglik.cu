// The scoring pass: each lane's share of a record's log-likelihood, log P(obs
// | model), for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (cpgisland_tpu_torch/ops/_kernels.py).  Plain versions of the same functions,
// used on the CPU and as the reference on the card, live in
// cpgisland_tpu_torch/ops/loglik.py (oh_loglik_plain, fb_loglik_plain).
//
// This is not one of the JAX package's Pallas kernels: there the score is a
// serial lax.scan over the whole record (cpgisland_tpu/ops/forward_backward.py
// ::sequence_loglik), which on this card would be one dependent chain of
// 64 Mi steps.  Here the record is cut into the posterior's lanes; each
// lane's exact entering alpha direction comes from the lane transfer products
// (B7 or B17) and a scan over the lanes, done by the caller; these kernels then
// run every lane's forward chain from its direction at once and write only
// sum_t log c_t per lane, where c_t = sum(alpha_{t-1} . M_t) with alpha_{t-1}
// normalized is P(o_t | o_<t).  The caller sums the lanes in float64.
//
// Steps: a stream entry marked PAD (pair >= S*S on the reduced engine, symbol
// >= S on the dense one) is an identity step: the chain carries, nothing is
// scored.  The caller marks the record's first scored position, every PAD
// symbol and everything at or past the record's length that way.  A step
// with c_t == 0 (an impossible observation) adds log 0 = -inf and carries
// the chain, so an impossible record scores -inf, never nan.
//
// oh_loglik (reduced one-hot models): the 2-component chain over the pair
// stream [Tp, NL] with the per-pair 2x2 tables (A * B) in shared memory, for
// M members of one alphabet over the one stream (blockIdx.y = the member; its
// table, directions [M, 2, NL] and sums [M, NL] member-major).  A member's
// sums do not depend on the others, so a stacked comparison group scores in
// one launch with the bits of M single-member launches.  fb_loglik (dense
// models, K <= 8): the K-state chain over the symbol stream [Tp, NL], raw_j =
// (sum_k v_k A[k, j]) * B[j, o_t], with A and B in shared memory.  Both: c =
// sum_j raw_j, v <- raw / c where c > 0; every product, sum and quotient an
// explicit round-to-nearest intrinsic in the plain version's order, so the
// chains equal the plain versions bit for bit and only the float64 log may
// differ in its last bit.
//
// Bound: each reads 4 B per step and writes 8 B per lane (0.27 GB for a 64 Mi
// record, 0.08 ms at 3.35 TB/s).  What bounded the first design was the chain:
// one thread a lane walked the lane's steps (8,192 on the posterior's lanes,
// and on every placed record of compare, PAD tails included) and every step
// waited on an IEEE division, at about two warps an SM.  The design, for a
// lane of ops/loglik.loglik_sublanes(Tp, K) = G > 1 sub-lanes (lanes of 8 Ki
// steps or more; K <= 4 on the dense chain): B7's layout, one launch, a
// block of 32 lanes with warp g on their sub-lane g, [g L, min((g + 1) L,
// Tp)), L = ceil(Tp / G) (fewer lanes a block where 32 would leave SMs
// idle: a lane's sub-lanes share one SM, so at compare's few lanes a block
// of 32 ran mostly dead threads on a few SMs), three phases joined by
// __syncthreads:
// 1. each sub-lane's product of its step matrices from the identity, the
//    identity at a PAD: the reduced chain's 2x2 group-coordinate product by
//    B4 / B7's sub_prod (renormalized every 8 steps), the dense chain's K x K
//    product by B16's contraction applied to each row (scaled every 8 steps
//    by an exact power of two); products and a flag "has a real step" go to
//    shared memory;
// 2. each thread composes, from its lane's entering direction, the products
//    of the sub-lanes before its own in order (B4's forward message
//    sub_message on the reduced chain, B16's power-of-two message on the
//    dense one; a sub-lane without a real step passes the message on
//    unchanged), then normalizes the result once, v / max(sum v, 1e-30): the
//    chain scores log c_t, which is right only from a v that sums to 1, and a
//    message that is zero (an impossible step before it) stays zero, not nan;
// 3. the one-chain kernel's chain over the sub-lane from that direction (a
//    sub-lane without a real step skips it and adds 0); each sub-lane's
//    float64 sum goes to shared memory and the lane's sub-lane 0 thread adds
//    its G sums in order g = 0 .. G-1.
// Both steps are degree 0 in v (c divides it out), so in exact arithmetic
// each sub-lane's c_t are the one chain's.  With G == 1 the launch is the
// one-thread-a-lane kernel (oh_loglik_kernel, fb_loglik_kernel<K>), whose
// loads run a group of LOOKAHEAD steps ahead of the chain.  What bounds
// the sub-lanes at the posterior's 8,192 lanes is instruction issue, not
// latency: each step's two IEEE divisions and float64 log, plus phase 1
// (on an H100, chip_smoke: 0.52 ms for the reduced kernel against 0.43
// for the one-chain kernel over the same record cut into 512-step lanes,
// which has no phase 1, and 2.56 in one chain a lane).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_steps.cuh"
#include "onehot_steps.cuh"

#define MAX_K 8
#define LL_THREADS 32     // lanes a block
#define SUB_LANES_MAX 32  // sub-lanes a lane at most: 32 warps a block
#define SUB_MAX_K 4       // the dense chain runs in sub-lanes up to this K
#define DENSE_AHEAD 8     // the dense sub-lane kernel's loads ahead (its K x K product
                          // and the lookahead share 64 registers a thread)

// q[r] = the entry at step first + r of a lane's stream, ``pad`` at or past end.
template <int N>
__device__ __forceinline__ void load_steps(const int32_t* p, size_t stride, int first, int end,
                                           int pad, int (&q)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int t = first + r;
    q[r] = t < end ? __ldg(p + (size_t)t * stride) : pad;
  }
}

// The reduced chain over steps [tb, te) of a lane (p: its pair column) from
// (v0, v1): sum of log c_t over the real steps, in order.
__device__ __forceinline__ double oh_chain(const int32_t* p, const float* s_tab, float v0,
                                           float v1, int tb, int te, size_t nl, int nreal) {
  double ll = 0.0;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_steps<LOOKAHEAD>(p, nl, tb, te, nreal, q);
  for (int t0 = tb; t0 < te; t0 += LOOKAHEAD) {
    load_steps<LOOKAHEAD>(p, nl, t0 + LOOKAHEAD, te, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      if (q[r] < nreal) {
        const float* m = s_tab + 4 * q[r];
        const float raw0 = __fadd_rn(__fmul_rn(v0, m[0]), __fmul_rn(v1, m[2]));
        const float raw1 = __fadd_rn(__fmul_rn(v0, m[1]), __fmul_rn(v1, m[3]));
        const float c = __fadd_rn(raw0, raw1);
        ll = __dadd_rn(ll, log((double)c));
        if (c > 0.0f) {
          v0 = __fdiv_rn(raw0, c);
          v1 = __fdiv_rn(raw1, c);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  return ll;
}

// The dense chain over steps [tb, te) of a lane (p: its symbol column) from
// v: sum of log c_t over the real steps, in order.
template <int K, int N>
__device__ __forceinline__ double fb_chain(const int32_t* p, const float* s_A, const float* s_B,
                                           int S, float (&v)[K], int tb, int te, size_t nl) {
  double ll = 0.0;
  int q[N], qn[N];
  load_steps<N>(p, nl, tb, te, S, q);
  for (int t0 = tb; t0 < te; t0 += N) {
    load_steps<N>(p, nl, t0 + N, te, S, qn);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int o = q[r];
      if (o < S) {
        float raw[K];
        fwd_contract<K>(s_A, s_B, S, o, v, raw);
        const float c = seq_sum<K>(raw);
        ll = __dadd_rn(ll, log((double)c));
        if (c > 0.0f) {
#pragma unroll
          for (int j = 0; j < K; ++j) v[j] = __fdiv_rn(raw[j], c);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < N; ++r) q[r] = qn[r];
  }
  return ll;
}

// ---------------------------------------------------------------------------
// G == 1: one thread a lane, 32 to a block so the warps spread over the SMs.

__global__ void __launch_bounds__(LL_THREADS)
oh_loglik_kernel(const int32_t* __restrict__ pair, const float* __restrict__ enter,
                 const float* __restrict__ tab, double* __restrict__ out, int Tp, int NL,
                 int nreal) {
  __shared__ float s_tab[MAX_TAB];
  const int mb = blockIdx.y;  // the member: its table, directions and sums
  const float* tab_m = tab + (size_t)mb * (nreal + 1) * 4;
  for (int i = threadIdx.x; i < (nreal + 1) * 4; i += blockDim.x) s_tab[i] = tab_m[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const float* e = enter + (size_t)mb * 2 * nl + n;
  out[(size_t)mb * nl + n] = oh_chain(pair + n, s_tab, e[0], e[nl], 0, Tp, nl, nreal);
}

template <int K>
__global__ void __launch_bounds__(LL_THREADS)
fb_loglik_kernel(const int32_t* __restrict__ sel, const float* __restrict__ enter,
                 const float* __restrict__ A, const float* __restrict__ B,
                 double* __restrict__ out, int Tp, int NL, int S) {
  __shared__ float s_A[MAX_K * MAX_K];
  __shared__ float s_B[MAX_K * MAX_S];
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) s_A[i] = A[i];
  for (int i = threadIdx.x; i < K * S; i += blockDim.x) s_B[i] = B[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = enter[(size_t)k * nl + n];
  out[n] = fb_chain<K, LOOKAHEAD>(sel + n, s_A, s_B, S, v, 0, Tp, nl);
}

// ---------------------------------------------------------------------------
// G > 1: the three phases above, a block of LB lanes (32, fewer where the
// lanes would not fill the card: ops/loglik._lanes_per_block), thread (j, g)
// = (threadIdx.x % LB, threadIdx.x / LB) on lane j's sub-lane g.  Dynamic
// shared memory, per block: the G sub-lanes' float64 sums [G][LB], their
// products [G][4 or K*K][LB] and their "has a real step" flags [G][LB]
// (slot (g, c) of lane j at (g * C + c) * LB + j).

// Phase 3's end: lane j's G sums, in order, by its sub-lane 0's thread.
__device__ __forceinline__ double lane_sum(const double* s_part, int G, int LB, int j) {
  double s = s_part[j];
  for (int k = 1; k < G; ++k) s = __dadd_rn(s, s_part[k * LB + j]);
  return s;
}

__global__ void __launch_bounds__(LL_THREADS * SUB_LANES_MAX)
oh_loglik_sub_kernel(const int32_t* __restrict__ pair, const float* __restrict__ enter,
                     const float* __restrict__ tab, double* __restrict__ out, int Tp, int NL,
                     int nreal, int G, int L, int LB) {
  __shared__ float s_tab[MAX_TAB];
  extern __shared__ double s_part[];
  float* s_prod = (float*)(s_part + G * LB);
  int* s_has = (int*)(s_prod + G * 4 * LB);
  const int mb = blockIdx.y;
  const float* tab_m = tab + (size_t)mb * (nreal + 1) * 4;
  for (int i = threadIdx.x; i < (nreal + 1) * 4; i += blockDim.x) s_tab[i] = tab_m[i];
  __syncthreads();
  const int j = threadIdx.x % LB;
  const int g = threadIdx.x / LB;
  const int n = blockIdx.x * LB + j;
  const bool live = n < NL;
  const size_t nl = (size_t)NL;
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  const int32_t* p = pair + n;
#define PROD(k, c) s_prod[((k) * 4 + (c)) * LB + j]
  if (live) {
    float P[4];
    s_has[g * LB + j] = sub_prod(p, s_tab, tb, te, 0, Tp, Tp, nl, nreal, P);
    for (int c = 0; c < 4; ++c) PROD(g, c) = P[c];
  }
  __syncthreads();
  if (live) {
    const float* e = enter + (size_t)mb * 2 * nl + n;
    float v0 = e[0], v1 = e[nl];
    if (g > 0) {
      for (int k = 0; k < g; ++k) {
        if (!s_has[k * LB + j]) continue;  // the message passes on
        const float P[4] = {PROD(k, 0), PROD(k, 1), PROD(k, 2), PROD(k, 3)};
        sub_message<true>(v0, v1, P);
      }
      const float d = fmaxf(__fadd_rn(v0, v1), 1e-30f);
      v0 = __fdiv_rn(v0, d);
      v1 = __fdiv_rn(v1, d);
    }
    s_part[g * LB + j] =
        s_has[g * LB + j] ? oh_chain(p, s_tab, v0, v1, tb, te, nl, nreal) : 0.0;
  }
#undef PROD
  __syncthreads();
  if (live && g == 0) out[(size_t)mb * nl + n] = lane_sum(s_part, G, LB, j);
}

template <int K>
__global__ void __launch_bounds__(LL_THREADS * SUB_LANES_MAX)
fb_loglik_sub_kernel(const int32_t* __restrict__ sel, const float* __restrict__ enter,
                     const float* __restrict__ A, const float* __restrict__ B,
                     double* __restrict__ out, int Tp, int NL, int S, int G, int L,
                     int LB) {
  __shared__ float s_A[MAX_K * MAX_K];
  __shared__ float s_B[MAX_K * MAX_S];
  extern __shared__ double s_part[];
  float* s_prod = (float*)(s_part + G * LB);
  int* s_has = (int*)(s_prod + G * K * K * LB);
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) s_A[i] = A[i];
  for (int i = threadIdx.x; i < K * S; i += blockDim.x) s_B[i] = B[i];
  __syncthreads();
  const int j = threadIdx.x % LB;
  const int g = threadIdx.x / LB;
  const int n = blockIdx.x * LB + j;
  const bool live = n < NL;
  const size_t nl = (size_t)NL;
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  const int32_t* p = sel + n;
#define PROD(k, x) s_prod[((k) * K * K + (x)) * LB + j]
  if (live) {
    // Phase 1: P over the real steps, t walking up; after every 8th step
    // counted from tb, P times 2^-e, e the binary exponent of its total
    // (row-major, in order).
    float P[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) P[i][k] = i == k ? 1.0f : 0.0f;
    bool any = false;
    int q[DENSE_AHEAD], qn[DENSE_AHEAD];
    load_steps<DENSE_AHEAD>(p, nl, tb, te, S, q);
    for (int t0 = tb; t0 < te; t0 += DENSE_AHEAD) {
      load_steps<DENSE_AHEAD>(p, nl, t0 + DENSE_AHEAD, te, S, qn);
#pragma unroll
      for (int r = 0; r < DENSE_AHEAD; ++r) {
        const int t = t0 + r;
        if (t < te) {
          const bool real = q[r] < S;
          const int o = real ? q[r] : S - 1;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float nv[K];
            fwd_contract<K>(s_A, s_B, S, o, P[i], nv);
            if (real) {
#pragma unroll
              for (int k = 0; k < K; ++k) P[i][k] = nv[k];
            }
          }
          any = any || real;
          if (((t - tb) & 7) == 7) {
            float tot = P[0][0];
#pragma unroll
            for (int x = 1; x < K * K; ++x) tot = __fadd_rn(tot, P[x / K][x % K]);
            const float sc = pow2f(-scale_exp(tot));
#pragma unroll
            for (int i = 0; i < K; ++i)
#pragma unroll
              for (int k = 0; k < K; ++k) P[i][k] = __fmul_rn(P[i][k], sc);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < DENSE_AHEAD; ++r) q[r] = qn[r];
    }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) PROD(g, i * K + k) = P[i][k];
    s_has[g * LB + j] = any;
  }
  __syncthreads();
  if (live) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = enter[(size_t)k * nl + n];
    if (g > 0) {
      // Phase 2: v <- v . P_h (each column's terms in order), times 2^-e of
      // its sum, over the earlier sub-lanes with a real step; then v / sum v.
      for (int h = 0; h < g; ++h) {
        if (!s_has[h * LB + j]) continue;  // the message passes on
        float r[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float acc = __fmul_rn(v[0], PROD(h, k));
#pragma unroll
          for (int i = 1; i < K; ++i) acc = __fadd_rn(acc, __fmul_rn(v[i], PROD(h, i * K + k)));
          r[k] = acc;
        }
        const float sc = pow2f(-scale_exp(seq_sum<K>(r)));
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = __fmul_rn(r[k], sc);
      }
      const float d = fmaxf(seq_sum<K>(v), 1e-30f);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = __fdiv_rn(v[k], d);
    }
    s_part[g * LB + j] =
        s_has[g * LB + j] ? fb_chain<K, DENSE_AHEAD>(p, s_A, s_B, S, v, tb, te, nl) : 0.0;
  }
#undef PROD
  __syncthreads();
  if (live && g == 0) out[n] = lane_sum(s_part, G, LB, j);
}

// Bytes of a sub-lane kernel's dynamic shared memory: C floats of product a
// sub-lane and lane, its float64 sum and its flag.
static inline size_t sub_smem(int G, int LB, int C) {
  return (size_t)G * LB * (sizeof(double) + C * sizeof(float) + sizeof(int));
}

template <int K>
static int launch_fb_loglik(const void* sel, const void* enter, const void* A, const void* B,
                            void* out, int Tp, int NL, int S, int G, int LB,
                            cudaStream_t st) {
  if (G == 1) {
    fb_loglik_kernel<K><<<(unsigned)((NL + LL_THREADS - 1) / LL_THREADS), LL_THREADS, 0, st>>>(
        (const int32_t*)sel, (const float*)enter, (const float*)A, (const float*)B,
        (double*)out, Tp, NL, S);
    return (int)cudaGetLastError();
  }
  if constexpr (K <= SUB_MAX_K) {
    const size_t smem = sub_smem(G, LB, K * K);  // past 48 KiB at K = 4, G = 32
    cudaError_t err = cudaFuncSetAttribute(
        fb_loglik_sub_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fb_loglik_sub_kernel<K><<<(unsigned)((NL + LB - 1) / LB), (unsigned)(LB * G), smem, st>>>(
        (const int32_t*)sel, (const float*)enter, (const float*)A, (const float*)B,
        (double*)out, Tp, NL, S, G, (Tp + G - 1) / G, LB);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;  // G > 1 only at K <= SUB_MAX_K
}

// The C interface: every pointer and the stream arrive as void*, sizes as int.
// Each function launches on the caller's stream and returns cudaGetLastError().
// G: the sub-lanes a lane (ops/loglik.loglik_sublanes), one launch either way;
// LB: the lanes a block where G > 1 (ops/loglik._lanes_per_block).
static inline bool bad_layout(int Tp, int NL, int G, int LB) {
  return Tp <= 0 || NL <= 0 || G < 1 || G > SUB_LANES_MAX || G > Tp || LB < 1 ||
         LB > LL_THREADS || (LB & (LB - 1)) != 0;
}

extern "C" {

int oh_loglik(const void* pair, const void* enter, const void* tab, void* out, int Tp, int NL,
              int nreal, int G, int LB, int M, void* stream) {
  if (nreal < 1 || nreal > MAX_S * MAX_S || M < 1 || M > 65535 || bad_layout(Tp, NL, G, LB))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (G == 1)
    oh_loglik_kernel<<<dim3((unsigned)((NL + LL_THREADS - 1) / LL_THREADS), (unsigned)M),
                       LL_THREADS, 0, st>>>(
        (const int32_t*)pair, (const float*)enter, (const float*)tab, (double*)out, Tp, NL,
        nreal);
  else
    oh_loglik_sub_kernel<<<dim3((unsigned)((NL + LB - 1) / LB), (unsigned)M),
                           (unsigned)(LB * G), sub_smem(G, LB, 4), st>>>(
        (const int32_t*)pair, (const float*)enter, (const float*)tab, (double*)out, Tp, NL,
        nreal, G, (Tp + G - 1) / G, LB);
  return (int)cudaGetLastError();
}

int fb_loglik(const void* sel, const void* enter, const void* A, const void* B, void* out,
              int Tp, int NL, int K, int S, int G, int LB, void* stream) {
  if (S < 1 || S > MAX_S || bad_layout(Tp, NL, G, LB)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_fb_loglik<1>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 2: return launch_fb_loglik<2>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 3: return launch_fb_loglik<3>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 4: return launch_fb_loglik<4>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 5: return launch_fb_loglik<5>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 6: return launch_fb_loglik<6>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 7: return launch_fb_loglik<7>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    case 8: return launch_fb_loglik<8>(sel, enter, A, B, out, Tp, NL, S, G, LB, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
