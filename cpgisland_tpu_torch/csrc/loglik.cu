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
// oh_loglik_kernel (reduced one-hot models): the 2-component chain over the
// pair stream [Tp, NL] with the per-pair 2x2 tables (A * B) in shared memory,
// for M members of one alphabet over the one stream (blockIdx.y = the
// member; its table, directions [M, 2, NL] and sums [M, NL] member-major).
// A member's sums do not depend on the others, so a stacked comparison group
// scores in one launch with the bits of M single-member launches.
// fb_loglik_kernel<K> (dense models, K <= 8): the K-state chain over the
// symbol stream [Tp, NL], raw_j = (sum_k v_k A[k, j]) * B[j, o_t], with A and
// B in shared memory.  Both: v <- raw / c where c > 0; every product, sum
// and quotient an explicit round-to-nearest intrinsic in the plain version's
// order, so the chains equal the plain versions bit for bit and only the
// float64 log may differ in its last bit.
//
// Bound: each reads 4 B per step and writes 8 B per lane (0.27 GB for a 64 Mi
// record, 0.08 ms at 3.35 TB/s); each lane is one dependent chain of lane_T
// steps whose every step waits on an IEEE division, so like B4 it is
// latency-bound well above that.  One thread per lane, 32 to a block so the
// warps spread over the SMs; each thread reads its stream a group of
// LOOKAHEAD steps ahead of the chain.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_K 8
#define MAX_S 16
#define MAX_TAB ((MAX_S * MAX_S + 1) * 4)
#define LL_THREADS 32
#define LOOKAHEAD 16

__device__ __forceinline__ void load_steps(const int32_t* p, size_t stride, int first, int Tp,
                                           int pad, int (&q)[LOOKAHEAD]) {
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = first + r;
    q[r] = t < Tp ? __ldg(p + (size_t)t * stride) : pad;
  }
}

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
  float v0 = enter[(size_t)mb * 2 * nl + n], v1 = enter[(size_t)mb * 2 * nl + nl + n];
  double ll = 0.0;
  const int32_t* p = pair + n;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_steps(p, nl, 0, Tp, nreal, q);
  for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
    load_steps(p, nl, t0 + LOOKAHEAD, Tp, nreal, qn);
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
  out[(size_t)mb * nl + n] = ll;
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
  double ll = 0.0;
  const int32_t* p = sel + n;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_steps(p, nl, 0, Tp, S, q);
  for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
    load_steps(p, nl, t0 + LOOKAHEAD, Tp, S, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int o = q[r];
      if (o < S) {
        float raw[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float acc = __fmul_rn(v[0], s_A[j]);
#pragma unroll
          for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], s_A[k * K + j]));
          raw[j] = __fmul_rn(acc, s_B[j * S + o]);
        }
        float c = raw[0];
#pragma unroll
        for (int j = 1; j < K; ++j) c = __fadd_rn(c, raw[j]);
        ll = __dadd_rn(ll, log((double)c));
        if (c > 0.0f) {
#pragma unroll
          for (int j = 0; j < K; ++j) v[j] = __fdiv_rn(raw[j], c);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  out[n] = ll;
}

template <int K>
static int launch_fb_loglik(const void* sel, const void* enter, const void* A, const void* B,
                            void* out, int Tp, int NL, int S, cudaStream_t st) {
  const unsigned blocks = (unsigned)((NL + LL_THREADS - 1) / LL_THREADS);
  fb_loglik_kernel<K><<<blocks, LL_THREADS, 0, st>>>(
      (const int32_t*)sel, (const float*)enter, (const float*)A, (const float*)B,
      (double*)out, Tp, NL, S);
  return (int)cudaGetLastError();
}

// The C interface: every pointer and the stream arrive as void*, sizes as int.
// Each function launches on the caller's stream and returns cudaGetLastError().
extern "C" {

int oh_loglik(const void* pair, const void* enter, const void* tab, void* out, int Tp, int NL,
              int nreal, int M, void* stream) {
  if (nreal < 1 || nreal > MAX_S * MAX_S || Tp <= 0 || NL <= 0 || M < 1 || M > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((NL + LL_THREADS - 1) / LL_THREADS), (unsigned)M);
  oh_loglik_kernel<<<grid, LL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pair, (const float*)enter, (const float*)tab, (double*)out, Tp, NL, nreal);
  return (int)cudaGetLastError();
}

int fb_loglik(const void* sel, const void* enter, const void* A, const void* B, void* out,
              int Tp, int NL, int K, int S, void* stream) {
  if (Tp <= 0 || NL <= 0 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_fb_loglik<1>(sel, enter, A, B, out, Tp, NL, S, st);
    case 2: return launch_fb_loglik<2>(sel, enter, A, B, out, Tp, NL, S, st);
    case 3: return launch_fb_loglik<3>(sel, enter, A, B, out, Tp, NL, S, st);
    case 4: return launch_fb_loglik<4>(sel, enter, A, B, out, Tp, NL, S, st);
    case 5: return launch_fb_loglik<5>(sel, enter, A, B, out, Tp, NL, S, st);
    case 6: return launch_fb_loglik<6>(sel, enter, A, B, out, Tp, NL, S, st);
    case 7: return launch_fb_loglik<7>(sel, enter, A, B, out, Tp, NL, S, st);
    case 8: return launch_fb_loglik<8>(sel, enter, A, B, out, Tp, NL, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
