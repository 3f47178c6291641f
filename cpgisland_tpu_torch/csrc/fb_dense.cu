// Dense forward-backward: the "pallas" engine's five kernels for Hopper
// (sm_90a), for any model with K <= 8 states and S <= 16 symbols, with a
// plain C interface loaded through ctypes (cpgisland_tpu_torch/ops/_kernels.py).
// Plain versions of the same functions, used on the CPU and as the reference
// on the card, live in cpgisland_tpu_torch/ops/fb_pallas.py (fb_*_plain).
//
// Layout: time-major streams, [Tp, NL] for the symbols, the scale factors and
// the confidence, [Tp, K, NL] for alphas and betas (lane n of step t, state k
// at (t * K + k) * NL + n).  Lanes are independent chunks of the training
// batch or consecutive stretches of one record (the posterior).  The
// one-thread chain kernels run one thread per lane, 32 to a block so the few
// warps spread over the SMs; neighbouring threads take neighbouring lanes, so
// every load and store of a warp is one coalesced row.  B17, and B16 / B18 at
// K >= 5, give a lane's K rows or states to K neighbouring threads instead
// (below).  A, B and the island mask sit in shared memory; the K-state
// vectors (a row of the K x K product for B17, one state for the
// state-split chains) stay in registers, sized by the template parameter K.
// Each chain thread reads its symbol stream (and B18's scale factors) a
// group of LOOKAHEAD steps ahead of the chain.
//
// Bit equality with the plain versions (B16-B19): every product and sum is an
// explicit round-to-nearest intrinsic (__fmul_rn / __fadd_rn), so nvcc
// contracts nothing into an FMA, every reciprocal or quotient is __fdiv_rn
// (IEEE), and every K-term sum runs j = 0, 1, ..., K-1 in sequence, as the
// plain version spells it.  The operand order is the JAX kernels': the raw
// forward contraction times B[k, o_t], then times 1 / sum(v_{t-1}); the
// backward's B[k, o_{t+1}] * (1 / c_{t+1}) first, then times beta_{t+1}.
//
// B16 fb_fwd_kernel replaces cpgisland_tpu/ops/fb_pallas.py::_fwd_kernel: the
// forward with deferred Rabiner scaling, v_t = ((sum_j v_{t-1}[j] A[j, k]) *
// B[k, o_t]) * (1 / sum v_{t-1}); v_0 = a0; carried where t >= len.  Bound:
// it reads 4 B and writes 4K B per step (2.4 GB at K = 8, NL = 1024, Tp =
// 65,536: 0.72 ms at 3.35 TB/s; 0.24 ms at K = 2).  What bounds one thread a
// chain is latency: a training batch of 1,024-1,390 lanes is one warp on
// each of 32-44 SMs, a step a chain of K dependent adds and a division (28x
// the bound at K = 2, 23x at K = 8).  What each K runs:
// - K <= 4, G = fb_pallas.fwd_sublanes > 1 (lanes of 8 Ki steps or more):
//   fb_fwd_sub_kernel runs each lane as G sub-lanes over a (lane block,
//   sub-lane) grid, B18's layout; the step is degree 0 in v_{t-1}, so a
//   sub-lane needs only the direction of the alpha before it (below).
//   Blocks of 64 or 128 threads, a 16-step lookahead and IEEE reciprocals
//   (__frcp_rn) ran no faster (cpgisland_tpu_torch/tools/kernel_variants.py),
//   which leaves the sub-lanes' scattered 128-byte row pieces, as in B18,
//   what bounds it.  A sub-lane's transfer product costs K^3 operations a
//   step against the chain's K^2, so sub-lanes stop at K = 4;
// - K <= 4 on shorter lanes: fb_fwd_kernel, one thread a chain;
// - K >= 5: fb_fwd_split_kernel, one chain split one thread a state (B17's
//   layout applied to the chain; below): every thread a K-th of the
//   arithmetic after a K-float exchange a step, each alpha formed by the
//   one-thread chain's operations in its order.
//
// B17 fb_prod_kernel replaces _prod_kernel: each lane's (+, x) product of its
// step matrices M_t[m, j] = A[m, j] * B[j, o_t] (the identity for PAD, o_t >=
// S), renormalized by the product's total after every 8th step counted from
// the lane's start, as the TPU kernel does, so only directions leave it.  The
// step matrices come from a [S + 1, K*K] table built by the caller.  Bound:
// K^3 multiplies and adds per real step, 0.96 ms of f32 operations at K = 8
// and 64 Mi steps.  What bounded the first design was its instruction
// stream: one thread a lane carried the 64-entry product and built its
// successor, 1,024 rounded operations a step from one thread, two warps an
// SM (24x the bound).  The design: a row of C.M_t needs only the same row
// of C, and the rows meet only in the total, so a lane's K rows go to K
// neighbouring threads (one row each, the total's row sums gathered in
// order by __shfl_sync): K times the warps, each thread a K-th of the
// instructions and registers, the operations and their order the first
// design's (bit for bit).  Contraction off keeps it above the ops bound:
// each multiply-add is two instructions.
// B18 replaces _bwd_kernel: beta_t[j] = sum_k A[j, k] * ((B[k, o_{t+1}] *
// (1 / c_{t+1})) * beta_{t+1}[k]) on the time-shifted streams
// (steps_next[t] = o_{t+1}, cs_next[t] = c_{t+1}), where t <= T-2 (T the
// chunk length) and t + 1 < len; carried elsewhere.  Bound: it reads 8 B
// and writes 4K B per step (0.32 ms at K = 2, 0.80 at K = 8, over 1,024 x
// 65,536).  What bounds one thread a chain (fb_bwd_kernel<K, false>) is
// latency: a training batch of 1,024 lanes is one warp on each of 32 SMs,
// 28x the bound at K = 2, 26x at K = 8.  What each K runs:
// - K <= 4, G = fb_pallas.bwd_sublanes > 1: fb_bwd_sub_kernel runs each
//   lane as G sub-lanes joined by exact boundary messages that carry the
//   betas' true magnitude (the recurrence is degree 1 and B20 reads the
//   Rabiner scale), over a (lane block, sub-lane) grid so the 1,024 lanes
//   spread over the card; below;
// - K <= 4 on shorter lanes: fb_bwd_kernel<K, false>, one thread a chain
//   (the sub-lane kernel's chain alone ran 6-7% slower there);
// - K >= 5: fb_bwd_split_kernel, one chain split one thread a state, as
//   B16's (below).
//
// B19 replaces _bwd_conf_kernel: B18's betas, in B18's layout at every K,
// emitting conf_t = (sum_k g_k * mask_k) * (1 / max(sum_k g_k, 1e-30)), g =
// alpha_t * beta_t, 0 past len, instead of storing the betas.  Reads 8 + 4K
// B, writes 4 B per step (0.40 ms at K = 2, 0.88 at K = 8 over 8,192 x
// 8,192).  The first port ran it one thread a chain at every K (32 threads a
// block: 256 warps on the whole card at 8,192 lanes, 6x its bound at K = 2,
// and one chain through each record's lane of up to 512 Ki steps in the
// posterior's batches).  What each K runs now:
// - K <= 4, G = fb_pallas.bwd_sublanes > 1: B18's phase 1 launch
//   (fb_bwd_sub_kernel<K, true>), then fb_bwd_sub_conf_kernel, B18's
//   phases 2 and 3 with the epilogue in place of the stores (below);
// - K <= 4 on shorter lanes: fb_bwd_kernel<K, true>, one thread a chain;
// - K >= 5: fb_bwd_split_conf_kernel, B18's state split with the epilogue
//   (below).
// In every layout the alphas of a group of steps load together at the
// group's start (a load issued at its step stalls the chain for its
// latency), and the betas are B18's bits, so B19's confidence is the
// epilogue of B18's betas.
//
// B20 fb_stats_part_kernel + fb_stats_reduce_kernel replace _stats_kernel:
// the per-lane counts macc[j*K + k] = sum_t ahat_{t-1}[j] * B[k, o_t] *
// beta_t[k] / c_t, emit[s*K + k] = sum_{o_t = s} gamma_t[k] and ll = sum_t
// log c_t over the valid steps.  No serial chain: ahat_{t-1} is read back
// from the alphas stream, so each lane's steps split into segments of Tt, one
// thread per (lane, segment) — enough threads to fill the card — with macc in
// registers and the emission bins in the thread's own column of shared
// memory; the second kernel sums each lane's segments in order (no atomics:
// the result is the same every run).  Bound: it reads 8K + 4 B per valid
// step (4.3 GB at K = 8 over the training batch: 1.3 ms).  Its sums run in
// another order than the plain version's, which agrees within a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_steps.cuh"

#define MAX_K 8
#define MAX_S 16
#define CHAIN_THREADS 32
#define LOOKAHEAD 8
#define STATS_THREADS 64
#define REDUCE_THREADS 128

// q[r] = the int at step first + step * r of a lane's stream, 0 outside [0, Tp).
template <int N>
__device__ __forceinline__ void load_ints(const int32_t* p, size_t stride, int first, int step,
                                          int Tp, int (&q)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int t = first + step * r;
    q[r] = (t >= 0 && t < Tp) ? __ldg(p + (size_t)t * stride) : 0;
  }
}

template <int N>
__device__ __forceinline__ void load_floats(const float* p, size_t stride, int first, int step,
                                            int Tp, float (&q)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int t = first + step * r;
    q[r] = (t >= 0 && t < Tp) ? __ldg(p + (size_t)t * stride) : 1.0f;
  }
}

// A [K, K] and B [K, S] into shared memory (s_A[j*K + k], s_B[k*S + s]).
template <int K>
__device__ __forceinline__ void load_tables(float* s_A, float* s_B, const float* __restrict__ A,
                                            const float* __restrict__ B, int S) {
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) s_A[i] = A[i];
  for (int i = threadIdx.x; i < K * S; i += blockDim.x) s_B[i] = B[i];
}

// ---------------------------------------------------------------------------
// B16: the forward chain.

// B16's chain over steps [tb, te) of a lane, 1 <= tb, from v, the alpha of
// step tb - 1: v_t = ((sum_j v[j] A[j, k]) * B[k, o_t]) * (1 / sum v) where
// t < len, carried elsewhere; stores v_t at rows (t K + k) nl of out (the
// lane's column).  p: the lane's steps column.  The callers store step 0
// (a0) themselves, so the chain tests only t < len.
template <int K>
__device__ __forceinline__ void fwd_range(const int32_t* p, const float* s_A, const float* s_B,
                                          int S, float (&v)[K], float* out, int len, int tb,
                                          int te, int Tp, size_t nl) {
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_ints(p, nl, tb, 1, Tp, q);
  for (int t0 = tb; t0 < te; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < te) {
        const int o = min(max(q[r], 0), S - 1);
        const float inv = __fdiv_rn(1.0f, seq_sum<K>(v));
        float nv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float acc = __fmul_rn(v[0], s_A[k]);
#pragma unroll
          for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], s_A[j * K + k]));
          nv[k] = __fmul_rn(__fmul_rn(acc, s_B[k * S + o]), inv);
        }
        // A plain copy under the condition compiles to selects, not a
        // branch the chain would wait on every step.
        if (t < len) {
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = nv[k];
        }
        float* o_row = out + (size_t)t * K * nl;
#pragma unroll
        for (int k = 0; k < K; ++k) o_row[k * nl] = v[k];
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

// Step 0 of a lane: v = a0 (the lane's column, rows nl apart), stored at
// row 0 of out (the lane's column).
template <int K>
__device__ __forceinline__ void fwd_start(const float* a0, float* out, size_t nl, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = a0[k * nl];
    out[k * nl] = v[k];
  }
}

// The whole lane's chain (B16 at K <= 4 on lanes under
// fb_pallas.FWD_SUBLANES_FROM steps).
template <int K>
__global__ void __launch_bounds__(CHAIN_THREADS)
fb_fwd_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
              const float* __restrict__ a0, const float* __restrict__ A,
              const float* __restrict__ B, float* __restrict__ alphas, int Tp, int NL, int S) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  float v[K];
  fwd_start<K>(a0 + n, alphas + n, nl, v);
  fwd_range<K>(steps + n, s_A, s_B, S, v, alphas + n, lens[n], 1, Tp, Tp, nl);
}

// ---------------------------------------------------------------------------
// B18 (CONF = false) and B19 (CONF = true): the backward chain.

// A backward step's column scale: bi[k] = B[k, o] * (1 / c), o the step's
// symbol (clamped into [0, S)) and c its c_{t+1}.
template <int K>
__device__ __forceinline__ void bwd_scale(const float* s_B, int S, int sym, float c,
                                          float (&bi)[K]) {
  const int o = min(max(sym, 0), S - 1);
  const float invc = __fdiv_rn(1.0f, c);
#pragma unroll
  for (int k = 0; k < K; ++k) bi[k] = __fmul_rn(s_B[k * S + o], invc);
}

// A backward step's contraction: nb[j] = sum_k A[j, k] * (bi[k] * v[k]), k
// in order.  The chain applies it to beta_{t+1}; B18's sub-lane product to
// each column of its matrix.
template <int K>
__device__ __forceinline__ void bwd_contract(const float* s_A, const float (&bi)[K],
                                             const float (&v)[K], float (&nb)[K]) {
  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = __fmul_rn(bi[k], v[k]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float acc = __fmul_rn(s_A[j * K], w[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(s_A[j * K + k], w[k]));
    nb[j] = acc;
  }
}

// B19's epilogue from the K products g_k = alpha_t[k] * beta_t[k], k in
// order: (sum_k g_k * mask_k) * (1 / max(sum_k g_k, 1e-30)) where valid, else
// 0.
template <int K>
__device__ __forceinline__ float conf_of(const float (&g)[K], const float* mask, bool valid) {
  float gm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) gm[k] = __fmul_rn(g[k], mask[k]);
  const float tot = fmaxf(seq_sum<K>(g), 1e-30f);
  return valid ? __fmul_rn(seq_sum<K>(gm), __fdiv_rn(1.0f, tot)) : 0.0f;
}

// A group's alphas, ag[r][k] = alpha_t[k] at t = first - r (0 where t < 0):
// the lane's column a, rows nl apart.
template <int K, int N>
__device__ __forceinline__ void load_alphas(const float* a, size_t nl, int first,
                                            float (&ag)[N][K]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int t = first - r;
    const float* row = a + (size_t)max(t, 0) * K * nl;
#pragma unroll
    for (int k = 0; k < K; ++k) ag[r][k] = t >= 0 ? __ldg(row + k * nl) : 0.0f;
  }
}

template <int K, bool CONF>
__global__ void __launch_bounds__(CHAIN_THREADS)
fb_bwd_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
              const float* __restrict__ cs_next, const float* __restrict__ beta0,
              const float* __restrict__ alphas, const float* __restrict__ mask,
              const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ out,
              int Tp, int NL, int S, int T) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_mask[K];
  load_tables<K>(s_A, s_B, A, B, S);
  if (CONF && threadIdx.x < K) s_mask[threadIdx.x] = mask[threadIdx.x];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int len = lens[n];
  float beta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) beta[k] = beta0[k * nl + n];
  const int32_t* p = steps_next + n;
  const float* c = cs_next + n;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cq[LOOKAHEAD], cqn[LOOKAHEAD];
  // B19: the group's alphas, all loaded at the group's start so that one
  // memory latency serves LOOKAHEAD steps instead of stalling every step.
  constexpr int AG = CONF ? LOOKAHEAD : 1;
  float ag[AG][K];
  load_ints(p, nl, Tp - 1, -1, Tp, q);
  load_floats(c, nl, Tp - 1, -1, Tp, cq);
  for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
    load_ints(p, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, qn);
    load_floats(c, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, cqn);
    if (CONF) load_alphas<K, AG>(alphas + n, nl, Tp - 1 - k0, ag);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0) {
        float bi[K], nb[K];
        bwd_scale<K>(s_B, S, q[r], cq[r], bi);
        bwd_contract<K>(s_A, bi, beta, nb);
        if (t <= T - 2 && t + 1 < len) {
#pragma unroll
          for (int k = 0; k < K; ++k) beta[k] = nb[k];
        }
        if (CONF) {
          float g[K];
#pragma unroll
          for (int k = 0; k < K; ++k) g[k] = __fmul_rn(ag[CONF ? r : 0][k], beta[k]);
          out[(size_t)t * nl + n] = conf_of<K>(g, s_mask, t < len);
        } else {
          float* o_row = out + (size_t)t * K * nl + n;
#pragma unroll
          for (int k = 0; k < K; ++k) o_row[k * nl] = beta[k];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      cq[r] = cqn[r];
    }
  }
}

// ---------------------------------------------------------------------------
// B18 in sub-lanes (K <= 4; fb_pallas.bwd_sublanes).  Each lane runs as G
// sub-lanes of L steps, [g L, min((g + 1) L, Tp)), one thread per (lane,
// sub-lane).  The chain is DEGREE 1 in beta (the betas carry the Rabiner
// scale B20 reads), so a sub-lane's message carries the true magnitude:
// 1. each sub-lane's transfer matrix Q_g (beta_tb = Q_g . beta_te over its
//    valid steps t < hi = min(T - 1, len - 1)), formed from the identity by
//    the chain's own step applied to each column, walking t down from the
//    sub-lane's end; after every 8th step counted from its padded end
//    (g + 1) L - 1, Q_g is scaled by 2^-e, e the binary exponent of its
//    total (scale_exp), and e is added to an int E_g.  Q_g (row-major)
//    and E_g (as a float: exact below 2^24) go to the scratch [G, K*K + 1,
//    NL];
// 2. each thread forms the message entering its sub-lane from beta0 and
//    the products of the sub-lanes after it, in order (v <- Q_h . v, then v
//    scaled by a power of two to a total near 1, the exponents summed; a
//    sub-lane with no valid step passes v on unchanged), and starts its
//    chain from v 2^E (two exact power-of-two products).  The same ops in
//    the same order in every thread, so the messages are a sequential
//    scan's, and the last valid sub-lane starts from beta0 exactly;
// 3. B18's chain over the sub-lane from that message.
// A product by a power of two is exact away from float32's subnormals, so
// in exact arithmetic the messages are the sequential chain's betas; the
// stored betas differ from it in the last bits.  Phase 1 is one launch and
// phases 2 and 3 another, each over a (32-lane block, sub-lane) grid, so
// one direction of 1,024 lanes runs on G times 32 blocks instead of 32
// (B4's layout, a lane's sub-lanes in one block, ran 1.1-1.8x slower on
// the H100).  Every operation is an explicit round-to-nearest intrinsic in
// fb_pallas._bwd_sublanes_plain's order.  B19 takes phase 1's launch as it
// is and then fb_bwd_sub_conf_kernel: phases 2 and 3 with the chain
// emitting the confidence (each group's alphas loaded at its start) in
// place of the betas' stores, so its betas are B18's bits.

#define SUB_LANES_MAX 32
#define SUB_MAX_K 4  // B16 and B18 run in sub-lanes up to this K

// Phase 1: Q_g and E_g of the sub-lane [tb, te) into dst (lane column, rows
// nl apart).  p and c: the lane's steps_next and cs_next columns.
template <int K>
__device__ __forceinline__ void bwd_sub_prod(const int32_t* p, const float* c, const float* s_A,
                                             const float* s_B, int S, int tb, int te, int hi,
                                             int L, int Tp, size_t nl, float* dst) {
  float Q[K][K];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) Q[j][i] = j == i ? 1.0f : 0.0f;
  int E = 0;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cq[LOOKAHEAD], cqn[LOOKAHEAD];
  load_ints(p, nl, te - 1, -1, Tp, q);
  load_floats(c, nl, te - 1, -1, Tp, cq);
  for (int k0 = 0; k0 < te - tb; k0 += LOOKAHEAD) {
    load_ints(p, nl, te - 1 - (k0 + LOOKAHEAD), -1, Tp, qn);
    load_floats(c, nl, te - 1 - (k0 + LOOKAHEAD), -1, Tp, cqn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = te - 1 - (k0 + r);
      if (t >= tb) {
        if (t < hi) {
          float bi[K];
          bwd_scale<K>(s_B, S, q[r], cq[r], bi);
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float v[K], nv[K];
#pragma unroll
            for (int k = 0; k < K; ++k) v[k] = Q[k][i];
            bwd_contract<K>(s_A, bi, v, nv);
#pragma unroll
            for (int j = 0; j < K; ++j) Q[j][i] = nv[j];
          }
        }
        if (((tb + L - 1 - t) & 7) == 7) {
          float tot = Q[0][0];
#pragma unroll
          for (int x = 1; x < K * K; ++x) tot = __fadd_rn(tot, Q[x / K][x % K]);
          const int e = scale_exp(tot);
          const float sc = pow2f(-e);
#pragma unroll
          for (int j = 0; j < K; ++j)
#pragma unroll
            for (int i = 0; i < K; ++i) Q[j][i] = __fmul_rn(Q[j][i], sc);
          E += e;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      cq[r] = cqn[r];
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) dst[(size_t)(j * K + i) * nl] = Q[j][i];
  dst[(size_t)(K * K) * nl] = (float)E;
}

// Phase 2: the beta entering sub-lane g (beta at its end), from beta0 (the
// lane's column, rows nl apart) and the products of sub-lanes G-1 .. g+1
// in qbuf (the lane's column).
template <int K>
__device__ __forceinline__ void bwd_sub_entry(const float* qbuf, const float* beta0, int g,
                                              int G, int L, int Tp, int hi, size_t nl,
                                              float (&beta)[K]) {
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = beta0[k * nl];
  int E = 0;
  for (int h = G - 1; h > g; --h) {
    const int hb = min(h * L, Tp), he = min(hb + L, Tp);
    if (hb >= min(he, hi)) continue;  // no valid step: the message passes on
    const float* Qh = qbuf + (size_t)h * (K * K + 1) * nl;
    float r[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float acc = __fmul_rn(Qh[(size_t)(j * K) * nl], v[0]);
#pragma unroll
      for (int i = 1; i < K; ++i)
        acc = __fadd_rn(acc, __fmul_rn(Qh[(size_t)(j * K + i) * nl], v[i]));
      r[j] = acc;
    }
    const int e = scale_exp(seq_sum<K>(r));
    const float sc = pow2f(-e);
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = __fmul_rn(r[j], sc);
    E += (int)Qh[(size_t)(K * K) * nl] + e;
  }
  const int e1 = E / 2, e2 = E - e1;
  const float s1 = pow2f(min(max(e1, -126), 126)), s2 = pow2f(min(max(e2, -126), 126));
#pragma unroll
  for (int k = 0; k < K; ++k) beta[k] = __fmul_rn(__fmul_rn(v[k], s1), s2);
}

// Phase 3: B18's chain over [tb, te) from beta (the beta at te), storing
// beta_t at rows (t K + k) nl of out (the lane's column); CONF (B19): B19's
// epilogue of beta_t and the alphas (al, the lane's column) at row t nl of
// out instead, 0 from len on.
template <int K, bool CONF>
__device__ __forceinline__ void bwd_range(const int32_t* p, const float* c, const float* s_A,
                                          const float* s_B, int S, float (&beta)[K], float* out,
                                          int tb, int te, int hi, int Tp, size_t nl,
                                          const float* al = nullptr,
                                          const float* s_mask = nullptr, int len = 0) {
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cq[LOOKAHEAD], cqn[LOOKAHEAD];
  constexpr int AG = CONF ? LOOKAHEAD : 1;
  float ag[AG][K];
  load_ints(p, nl, te - 1, -1, Tp, q);
  load_floats(c, nl, te - 1, -1, Tp, cq);
  for (int k0 = 0; k0 < te - tb; k0 += LOOKAHEAD) {
    load_ints(p, nl, te - 1 - (k0 + LOOKAHEAD), -1, Tp, qn);
    load_floats(c, nl, te - 1 - (k0 + LOOKAHEAD), -1, Tp, cqn);
    if (CONF) load_alphas<K, AG>(al, nl, te - 1 - k0, ag);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = te - 1 - (k0 + r);
      if (t >= tb) {
        float bi[K], nb[K];
        bwd_scale<K>(s_B, S, q[r], cq[r], bi);
        bwd_contract<K>(s_A, bi, beta, nb);
        if (t < hi) {
#pragma unroll
          for (int k = 0; k < K; ++k) beta[k] = nb[k];
        }
        if (CONF) {
          float g[K];
#pragma unroll
          for (int k = 0; k < K; ++k) g[k] = __fmul_rn(ag[CONF ? r : 0][k], beta[k]);
          out[(size_t)t * nl] = conf_of<K>(g, s_mask, t < len);
        } else {
          float* o_row = out + (size_t)t * K * nl;
#pragma unroll
          for (int k = 0; k < K; ++k) o_row[k * nl] = beta[k];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      cq[r] = cqn[r];
    }
  }
}

// PROD: phase 1 (the first launch); else phases 2 and 3 (the second).
// Sub-lane g = blockIdx.y.
template <int K, bool PROD>
__global__ void __launch_bounds__(CHAIN_THREADS)
fb_bwd_sub_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                  const float* __restrict__ cs_next, const float* __restrict__ beta0,
                  const float* __restrict__ A, const float* __restrict__ B, float* qbuf,
                  float* __restrict__ betas, int Tp, int NL, int S, int T, int G, int L) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  const int g = blockIdx.y;
  const int n = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int hi = min(T - 1, lens[n] - 1);
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  if (PROD) {
    bwd_sub_prod<K>(steps_next + n, cs_next + n, s_A, s_B, S, tb, te, hi, L, Tp, nl,
                    qbuf + (size_t)g * (K * K + 1) * nl + n);
  } else {
    float beta[K];
    bwd_sub_entry<K>(qbuf + n, beta0 + n, g, G, L, Tp, hi, nl, beta);
    bwd_range<K, false>(steps_next + n, cs_next + n, s_A, s_B, S, beta, betas + n, tb, te, hi,
                        Tp, nl);
  }
}

// B19 at K <= 4 in G > 1 sub-lanes, after B18's phase 1 launch
// (fb_bwd_sub_kernel<K, true>, the products in qbuf): B18's phases 2 and 3,
// the chain emitting B19's confidence (conf [Tp, NL]) instead of the betas.
// Sub-lane g = blockIdx.y.
template <int K>
__global__ void __launch_bounds__(CHAIN_THREADS)
fb_bwd_sub_conf_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                       const float* __restrict__ cs_next, const float* __restrict__ beta0,
                       const float* __restrict__ alphas, const float* __restrict__ mask,
                       const float* __restrict__ A, const float* __restrict__ B,
                       const float* qbuf, float* __restrict__ conf, int Tp, int NL, int S, int T,
                       int G, int L) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_mask[K];
  load_tables<K>(s_A, s_B, A, B, S);
  if (threadIdx.x < K) s_mask[threadIdx.x] = mask[threadIdx.x];
  __syncthreads();
  const int g = blockIdx.y;
  const int n = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int len = lens[n];
  const int hi = min(T - 1, len - 1);
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  float beta[K];
  bwd_sub_entry<K>(qbuf + n, beta0 + n, g, G, L, Tp, hi, nl, beta);
  bwd_range<K, true>(steps_next + n, cs_next + n, s_A, s_B, S, beta, conf + n, tb, te, hi, Tp,
                     nl, alphas + n, s_mask, len);
}

// ---------------------------------------------------------------------------
// B16 in sub-lanes (K <= 4; fb_pallas.fwd_sublanes).  Each lane runs as G
// sub-lanes of L steps, [g L, min((g + 1) L, Tp)), one thread per (lane,
// sub-lane), in three launches over a (32-lane block, sub-lane) grid.  The
// step divides by sum v_{t-1}, so it is DEGREE 0 in v_{t-1}: a sub-lane
// entered with any positive multiple of the alpha before it stores, in
// exact arithmetic, the sequential chain's alphas, and a power-of-two
// multiple changes no bit of them.  With last = max(min(len, Tp), 1) - 1,
// the last valid step, and gl = last / L its sub-lane:
// 1. each sub-lane g < gl forms its product P_g of M_t[j, k] = A[j, k] *
//    B[k, o_t] over its valid steps 1 <= t < len, from the identity, by the
//    chain's contraction applied to each row, t walking up; after every
//    8th step counted from g L, P_g is scaled by 2^-e, e the binary
//    exponent of its total (scale_exp; a power of two costs no division
//    and rounds nothing), into the scratch [G, K*K, NL].  The products of
//    sub-lanes gl and up are never read, so they are not formed;
// 2. each thread g <= gl forms the direction entering its sub-lane from a0
//    and P_0 .. P_{g-1}, in order (v <- v . P_h, then v times 2^-e of its
//    sum; a sub-lane with no valid step passes v on unchanged): the same
//    operations in the same order in every thread, so the messages are a
//    sequential scan's, and sub-lane 0 starts from a0 exactly.  Then B16's
//    chain (fwd_range) over the sub-lane, which in sub-lane gl carries the
//    alpha of step last to the sub-lane's end;
// 3. each sub-lane g > gl stores the alpha of step last, read back from
//    the alphas, at every step: past the last valid step every alpha is
//    that step's at its true magnitude, never a message's.
// Every operation is an explicit round-to-nearest intrinsic in
// fb_pallas._fwd_sublanes_plain's order.

// Phase 1: P_g of the sub-lane [tb, te) into dst (the lane's column, rows nl
// apart).  p: the lane's steps column.
template <int K>
__device__ __forceinline__ void fwd_sub_prod(const int32_t* p, const float* s_A, const float* s_B,
                                             int S, int tb, int te, int len, int Tp, size_t nl,
                                             float* dst) {
  float P[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k) P[i][k] = i == k ? 1.0f : 0.0f;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_ints(p, nl, tb, 1, Tp, q);
  for (int t0 = tb; t0 < te; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < te) {
        const int o = min(max(q[r], 0), S - 1);
        float N[K][K];
#pragma unroll
        for (int i = 0; i < K; ++i) fwd_contract<K>(s_A, s_B, S, o, P[i], N[i]);
        if (t >= 1 && t < len) {
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int k = 0; k < K; ++k) P[i][k] = N[i][k];
        }
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
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k) dst[(size_t)(i * K + k) * nl] = P[i][k];
}

// Phase 2's message: the direction entering sub-lane g, from a0 (the lane's
// column, rows nl apart) and the products of sub-lanes 0 .. g-1 in pbuf (the
// lane's column).
template <int K>
__device__ __forceinline__ void fwd_sub_entry(const float* pbuf, const float* a0, int g, int L,
                                              int Tp, int len, size_t nl, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = a0[k * nl];
  for (int h = 0; h < g; ++h) {
    const int hb = min(h * L, Tp), he = min(hb + L, Tp);
    if (max(hb, 1) >= min(he, len)) continue;  // no valid step: the message passes on
    const float* Ph = pbuf + (size_t)h * (K * K) * nl;
    float r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = __fmul_rn(v[0], Ph[(size_t)k * nl]);
#pragma unroll
      for (int i = 1; i < K; ++i) acc = __fadd_rn(acc, __fmul_rn(v[i], Ph[(size_t)(i * K + k) * nl]));
      r[k] = acc;
    }
    const float sc = pow2f(-scale_exp(seq_sum<K>(r)));
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __fmul_rn(r[k], sc);
  }
}

// PHASE 0: the products (the first launch); 1: the messages and chains (the
// second); 2: the alphas past the last valid step (the third).  Sub-lane g =
// blockIdx.y.
template <int K, int PHASE>
__global__ void __launch_bounds__(CHAIN_THREADS)
fb_fwd_sub_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
                  const float* __restrict__ a0, const float* __restrict__ A,
                  const float* __restrict__ B, float* alphas, float* pbuf, int Tp, int NL,
                  int S, int L) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  const int g = blockIdx.y;
  const int n = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int len = lens[n];
  const int last = max(min(len, Tp), 1) - 1;
  const int gl = last / L;
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  if (PHASE == 0) {
    if (g < gl)
      fwd_sub_prod<K>(steps + n, s_A, s_B, S, tb, te, len, Tp, nl,
                      pbuf + (size_t)g * (K * K) * nl + n);
  } else if (PHASE == 1) {
    if (g <= gl) {
      float v[K];
      if (g == 0) fwd_start<K>(a0 + n, alphas + n, nl, v);  // sub-lane 0 starts from a0
      else fwd_sub_entry<K>(pbuf + n, a0 + n, g, L, Tp, len, nl, v);
      fwd_range<K>(steps + n, s_A, s_B, S, v, alphas + n, len, max(tb, 1), te, Tp, nl);
    }
  } else if (g > gl) {
    float v[K];
    const float* src = alphas + (size_t)last * K * nl + n;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = src[k * nl];
    for (int t = tb; t < te; ++t) {
      float* o_row = alphas + (size_t)t * K * nl + n;
#pragma unroll
      for (int k = 0; k < K; ++k) o_row[k * nl] = v[k];
    }
  }
}

// ---------------------------------------------------------------------------
// B17: the per-lane transfer products, one thread per row.  A lane's K rows
// go to KP = K rounded up to a power of two neighbouring threads (32 / KP
// lanes a warp; threads K..KP-1 of a group carry a zero row and store
// nothing).  Thread i carries row i of C: N[i][j] = sum_m C[i][m] * M[m][j],
// m in order, needs no other row; every 8th step its row sum (in order) goes
// to the group by __shfl_sync and every thread adds the K sums in order i =
// 0..K-1, so the total, its reciprocal and the rescale are the one-thread
// kernel's bits.  Each step's K x K table loads as float4s from shared
// memory (one address a group, broadcast), rows PROD_STRIDE(K*K) floats
// apart: a multiple of 4, and an odd count of float4s, so the tables of
// different symbols start in different banks.

#define PROD_THREADS 128
#define PROD_STRIDE(KK) ((((KK) + 3) / 4 * 4) % 8 == 0 ? ((KK) + 3) / 4 * 4 + 4 : ((KK) + 3) / 4 * 4)

template <int K>
__global__ void __launch_bounds__(PROD_THREADS)
fb_prod_kernel(const int32_t* __restrict__ sel, const float* __restrict__ tab,
               float* __restrict__ out, int Tp, int NL, int S) {
  constexpr int KK = K * K;
  constexpr int KP = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
  constexpr int SP = PROD_STRIDE(KK);
  constexpr int NV = (KK + 3) / 4;  // float4s a table
  __shared__ __align__(16) float s_M[(MAX_S + 1) * PROD_STRIDE(MAX_K * MAX_K)];
  for (int i = threadIdx.x; i < (S + 1) * SP; i += blockDim.x) {
    const int r = i / SP, c = i % SP;
    s_M[i] = c < KK ? tab[r * KK + c] : 0.0f;
  }
  __syncthreads();
  const int i = threadIdx.x % KP;  // the row this thread carries
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) / KP;
  // Every thread of a warp runs the loop (the shuffles name them all); a
  // lane past NL reads lane NL - 1's stream and stores nothing.
  const size_t nl = (size_t)NL;
  float C[K];
#pragma unroll
  for (int m = 0; m < K; ++m) C[m] = (i == m) ? 1.0f : 0.0f;
  const int32_t* p = sel + min(n, NL - 1);
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_ints(p, nl, 0, 1, Tp, q);
  for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < Tp) {
        const float4* M4 =
            reinterpret_cast<const float4*>(s_M + min(max(q[r], 0), S) * SP);
        float M[NV * 4];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 x = M4[v];
          M[4 * v] = x.x;
          M[4 * v + 1] = x.y;
          M[4 * v + 2] = x.z;
          M[4 * v + 3] = x.w;
        }
        float N[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float acc = __fmul_rn(C[0], M[j]);
#pragma unroll
          for (int m = 1; m < K; ++m) acc = __fadd_rn(acc, __fmul_rn(C[m], M[m * K + j]));
          N[j] = acc;
        }
#pragma unroll
        for (int m = 0; m < K; ++m) C[m] = N[m];
        if ((t & 7) == 7) {
          // The total: row sums in order, then their sum in order.
          const float si = seq_sum<K>(C);
          float tot = __shfl_sync(0xffffffffu, si, 0, KP);
#pragma unroll
          for (int k = 1; k < K; ++k) tot = __fadd_rn(tot, __shfl_sync(0xffffffffu, si, k, KP));
          const float inv = __fdiv_rn(1.0f, fmaxf(tot, 1e-30f));
#pragma unroll
          for (int m = 0; m < K; ++m) C[m] = __fmul_rn(C[m], inv);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  if (n < NL && i < K) {
#pragma unroll
    for (int m = 0; m < K; ++m) out[(size_t)(i * K + m) * nl + n] = C[m];
  }
}

// ---------------------------------------------------------------------------
// B16, B18 and B19 at K >= 5: one chain, split one thread a state.  A lane's
// states go to SPLIT_KP = 8 neighbouring threads (4 lanes a warp; threads
// K..7 of a group carry zeros and store nothing), B17's layout applied to
// the chain.  Each step the group exchanges K floats by __shfl_sync of
// width SPLIT_KP:
// - B16: thread k forms inv = 1 / sum_j v_{t-1}[j] and its column's
//   ((sum_j v_{t-1}[j] A[j, k]) * B[k, o_t]) * inv, j in order; the group
//   exchanges the product before inv (fwd_split_step), so the exchange
//   and the division overlap;
// - B18: thread k forms w[k] = (B[k, o] * (1 / c)) * beta[k]; the group
//   exchanges w, and thread j sums A[j, k] * w[k], k in order.  The
//   divisions by c leave the chain: thread r of a group divides for step r
//   of each group of SPLIT_KP steps (split_scales);
// - B19: B18's chain (bwd_split_chain) and, at each step, thread k's g_k =
//   alpha_t[k] * beta_t[k] gathered in state order, each thread adding the
//   K values (and their masked products) in sequence; thread r keeps step
//   r's two sums, so each thread divides and stores once a group, one
//   store instruction writing the group's 8 steps (split_conf_sums,
//   split_conf_store), instead of a division and a 16-byte store a step.
// All read their streams (B19 each thread its state's alphas) a group of
// SPLIT_KP steps ahead.
// Each thread does a K-th of the one-thread chain's arithmetic, and every
// value it forms is formed by that chain's operations in its order (no
// shuffle tree: each thread adds the K exchanged values in sequence), so
// the streams are the sequential chains' (_fwd_chain_plain,
// _bwd_chain_plain) bit for bit.  A sub-lane's K x K transfer product
// (K^3 operations a step) would cost as much as the whole chain at K = 8,
// which is why K >= 5 splits the states instead.  The shuffles name every
// thread of the warp, so every thread runs every step: a lane past NL runs
// lane NL - 1's stream and stores nothing, the carry past len (B18: its
// keep) is a select, the stores are predicated and whole groups of steps
// run with no test of t, so no branch but the division's rare slow path
// interrupts a group.  A warp's store at a step is K rows of 4 lanes, 16 B
// each, a block's 64 B.
// What bounds it is the chain's latency (the division's in B16, the
// exchange's in B18) and, in B18, the stores' row pieces.  Layouts measured
// with cpgisland_tpu_torch/tools/kernel_variants.py (--group split): a
// warp a state (the exchange through shared memory, a barrier a step,
// whole-row stores) and stores staged in shared memory ran slower at both
// geometries; two or four states a thread (wider stores) ran faster on
// 8,192 lanes but slower on the training batch; blocks of 4 lanes ran 4-5x
// slower on 8,192 lanes (their 16-byte row pieces reach memory from
// different SMs); __frcp_rn ran slower than __fdiv_rn.

#define SPLIT_KP 8         // threads a lane: the states, padded to a power of two
#define SPLIT_THREADS 128  // a block: 16 lanes, so a store covers 64-byte row pieces

// (state k, lane n) of this thread; lanes past NL read lane NL - 1.
__device__ __forceinline__ void split_coords(int NL, int& k, int& n, int& ln) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  k = i % SPLIT_KP;
  n = i / SPLIT_KP;
  ln = min(n, NL - 1);
}

// *p = v where on, as a predicated store: a branch around the store would
// make the warp wait for its shuffles in flight at every step.
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.global.f32 [%0], %1;\n\t}"
               ::"l"(p), "f"(v), "r"((unsigned)on));
}

// The group's K values of x, state 0 first.
template <int K>
__device__ __forceinline__ void split_gather(float x, float (&all)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) all[j] = __shfl_sync(0xffffffffu, x, j, SPLIT_KP);
}

// The forward carries this thread's v_t as u * s: u its raw product (sum_j
// v_{t-1}[j] A[j, k]) * B[k, o_t] and s = 1 / sum v_{t-1}, the product the
// one-thread chain rounds last (v_0 = a0 * 1, exact).  The group exchanges
// u, and each thread forms v[j] = u[j] * s itself, so a step issues its
// exchange before its division and the two latencies overlap.  x: the
// group's u entering the step (the next step's on return); b: B[k, o_t].
template <int K>
__device__ __forceinline__ void fwd_split_step(const float (&a_col)[K], float b, bool live,
                                               float (&x)[K], float& u, float& s, float* dst,
                                               bool stores) {
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = __fmul_rn(x[j], s);
  float acc = __fmul_rn(v[0], a_col[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], a_col[j]));
  const float sum = seq_sum<K>(v);
  u = live ? __fmul_rn(acc, b) : u;
  split_gather<K>(u, x);
  const float inv = __fdiv_rn(1.0f, sum);
  s = live ? inv : s;
  store_if(dst, __fmul_rn(u, s), stores);
}

// A group's B[k, o_t], t = t0 + r (r < SPLIT_KP), from its symbols q.
__device__ __forceinline__ void split_emits(const float* b_row, int S, const int (&q)[SPLIT_KP],
                                            float (&bq)[SPLIT_KP]) {
#pragma unroll
  for (int r = 0; r < SPLIT_KP; ++r) bq[r] = b_row[min(max(q[r], 0), S - 1)];
}

template <int K>
__global__ void __launch_bounds__(SPLIT_THREADS)
fb_fwd_split_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
                    const float* __restrict__ a0, const float* __restrict__ A,
                    const float* __restrict__ B, float* __restrict__ alphas, int Tp, int NL,
                    int S) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  int k, n, ln;
  split_coords(NL, k, n, ln);
  const bool own = k < K;
  const bool stores = own && n < NL;
  const int kc = min(k, K - 1);
  const size_t nl = (size_t)NL;
  float a_col[K];  // column k of A
#pragma unroll
  for (int j = 0; j < K; ++j) a_col[j] = own ? s_A[j * K + kc] : 0.0f;
  const float* b_row = s_B + kc * S;
  float* out = alphas + (size_t)kc * nl + n;
  float u = own ? a0[(size_t)kc * nl + ln] : 0.0f, s = 1.0f;
  store_if(out, u, stores);
  float x[K];
  split_gather<K>(u, x);
  const int len = lens[ln];
  const int32_t* p = steps + ln;
  int q[SPLIT_KP], qn[SPLIT_KP];
  float bq[SPLIT_KP];
  load_ints(p, nl, 1, 1, Tp, q);
  int t0 = 1;
  // Whole groups with no test of t: one straight run of SPLIT_KP steps.
  for (; t0 + SPLIT_KP <= Tp; t0 += SPLIT_KP) {
    load_ints(p, nl, t0 + SPLIT_KP, 1, Tp, qn);
    split_emits(b_row, S, q, bq);
#pragma unroll
    for (int r = 0; r < SPLIT_KP; ++r) {
      const int t = t0 + r;
      fwd_split_step<K>(a_col, bq[r], t < len, x, u, s, out + (size_t)t * K * nl, stores);
    }
#pragma unroll
    for (int r = 0; r < SPLIT_KP; ++r) q[r] = qn[r];
  }
  split_emits(b_row, S, q, bq);
#pragma unroll
  for (int r = 0; r < SPLIT_KP; ++r) {
    const int t = t0 + r;
    if (t < Tp)
      fwd_split_step<K>(a_col, bq[r], t < len, x, u, s, out + (size_t)t * K * nl, stores);
  }
}

// A backward group's column scales B[k, o] * (1 / c), t = Tp - 1 - (k0 + r):
// thread r of the lane's group divides for step r (its c, cm) and the group
// reads each quotient by shuffle, one division a thread a group.
__device__ __forceinline__ void split_scales(const float* b_row, int S, const int (&q)[SPLIT_KP],
                                             float cm, float (&bq)[SPLIT_KP]) {
  const float inv = __fdiv_rn(1.0f, cm);
#pragma unroll
  for (int r = 0; r < SPLIT_KP; ++r)
    bq[r] = __fmul_rn(b_row[min(max(q[r], 0), S - 1)], __shfl_sync(0xffffffffu, inv, r, SPLIT_KP));
}

// B18's step: w[k] = bi[k] * beta[k] exchanged, thread j's nb[j] = sum_k
// A[j, k] * w[k], k in order; kept where ``keep``.  B18 stores beta_t (CONF
// false); B19 (CONF) stores nothing here.
template <int K, bool CONF>
__device__ __forceinline__ void bwd_split_step(const float (&a_row)[K], float bi, bool keep,
                                               float& beta, float* dst, bool stores) {
  float w[K];
  split_gather<K>(__fmul_rn(bi, beta), w);
  float acc = __fmul_rn(a_row[0], w[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(a_row[j], w[j]));
  beta = keep ? acc : beta;
  if (!CONF) store_if(dst, beta, stores);
}

// B19's epilogue on the state split: thread k forms g_k = alpha_t[k] *
// beta_t[k], the group gathers g in state order, and every thread forms
// the two K-term sums in sequence; thread r of the group keeps step r's
// (isl, tot), so each thread divides and stores once a group of SPLIT_KP
// steps (split_conf_store), as split_scales spreads B18's divisions.
template <int K>
__device__ __forceinline__ void split_conf_sums(float a, float beta, const float (&mask)[K],
                                                bool mine, float& isl, float& tot) {
  float g[K], gm[K];
  split_gather<K>(__fmul_rn(a, beta), g);
#pragma unroll
  for (int j = 0; j < K; ++j) gm[j] = __fmul_rn(g[j], mask[j]);
  const float s = seq_sum<K>(g), si = seq_sum<K>(gm);
  isl = mine ? si : isl;
  tot = mine ? s : tot;
}

// This thread's step of the group, t: conf_t = isl * (1 / max(tot, 1e-30))
// where t < len, 0 from len on; stored where ``on``.
__device__ __forceinline__ void split_conf_store(float* conf, size_t nl, int t, int len,
                                                 float isl, float tot, bool on) {
  const float v = t < len ? __fmul_rn(isl, __fdiv_rn(1.0f, fmaxf(tot, 1e-30f))) : 0.0f;
  store_if(conf + (size_t)max(t, 0) * nl, v, on && t >= 0);
}

// The state-split backward chain: CONF false, B18 (out = betas [Tp, K,
// NL]); CONF, B19 (out = conf [Tp, NL], from the alphas and the island mask).
template <int K, bool CONF>
__device__ __forceinline__ void bwd_split_chain(
    const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
    const float* __restrict__ cs_next, const float* __restrict__ beta0,
    const float* __restrict__ alphas, const float* __restrict__ mask, const float* __restrict__ A,
    const float* __restrict__ B, float* __restrict__ out, int Tp, int NL, int S, int T) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  int k, n, ln;
  split_coords(NL, k, n, ln);
  const bool own = k < K;
  const bool stores = own && n < NL;
  const int kc = min(k, K - 1);
  const size_t nl = (size_t)NL;
  float a_row[K];  // row k of A
#pragma unroll
  for (int j = 0; j < K; ++j) a_row[j] = own ? s_A[kc * K + j] : 0.0f;
  const float* b_row = s_B + kc * S;
  float* dst = out + (size_t)kc * nl + n;
  float beta = own ? beta0[(size_t)kc * nl + ln] : 0.0f;
  const int len = lens[ln];
  const int32_t* p = steps_next + ln;
  const float* c = cs_next + ln;
  // This thread's step of a group starting at k0: Tp - 1 - (k0 + k).
  const auto c_at = [&](int t) { return (t >= 0 && t < Tp) ? __ldg(c + (size_t)t * nl) : 1.0f; };
  int q[SPLIT_KP], qn[SPLIT_KP];
  float bq[SPLIT_KP];
  // B19: the island mask, this thread's alphas of the group (state kc, a
  // group ahead), and the sums of its own step of the group.
  constexpr int AG = CONF ? SPLIT_KP : 1;
  float mk[K], aq[AG][1], aqn[AG][1], isl = 0.0f, tot = 1.0f;
  float* conf = out + n;
  const float* al = alphas + (size_t)kc * nl + ln;
  if (CONF) {
#pragma unroll
    for (int j = 0; j < K; ++j) mk[j] = mask[j];
    load_alphas<1, AG>(al, (size_t)K * nl, Tp - 1, aq);
  }
  load_ints(p, nl, Tp - 1, -1, Tp, q);
  float cm = c_at(Tp - 1 - k), cmn;
  int k0 = 0;
  // Whole groups with no test of t: one straight run of SPLIT_KP steps.
  for (; k0 + SPLIT_KP <= Tp; k0 += SPLIT_KP) {
    load_ints(p, nl, Tp - 1 - (k0 + SPLIT_KP), -1, Tp, qn);
    cmn = c_at(Tp - 1 - (k0 + SPLIT_KP + k));
    if (CONF) load_alphas<1, AG>(al, (size_t)K * nl, Tp - 1 - (k0 + SPLIT_KP), aqn);
    split_scales(b_row, S, q, cm, bq);
#pragma unroll
    for (int r = 0; r < SPLIT_KP; ++r) {
      const int t = Tp - 1 - (k0 + r);
      bwd_split_step<K, CONF>(a_row, bq[r], t <= T - 2 && t + 1 < len, beta,
                              dst + (size_t)t * K * nl, stores);
      if (CONF) split_conf_sums<K>(aq[CONF ? r : 0][0], beta, mk, k == r, isl, tot);
    }
    if (CONF) {
      split_conf_store(conf, nl, Tp - 1 - (k0 + k), len, isl, tot, n < NL);
#pragma unroll
      for (int r = 0; r < AG; ++r) aq[r][0] = aqn[r][0];
    }
#pragma unroll
    for (int r = 0; r < SPLIT_KP; ++r) q[r] = qn[r];
    cm = cmn;
  }
  split_scales(b_row, S, q, cm, bq);
#pragma unroll
  for (int r = 0; r < SPLIT_KP; ++r) {
    const int t = Tp - 1 - (k0 + r);
    if (t >= 0) {
      bwd_split_step<K, CONF>(a_row, bq[r], t <= T - 2 && t + 1 < len, beta,
                              dst + (size_t)t * K * nl, stores);
      if (CONF) split_conf_sums<K>(aq[CONF ? r : 0][0], beta, mk, k == r, isl, tot);
    }
  }
  if (CONF) split_conf_store(conf, nl, Tp - 1 - (k0 + k), len, isl, tot, n < NL);
}

template <int K>
__global__ void __launch_bounds__(SPLIT_THREADS)
fb_bwd_split_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                    const float* __restrict__ cs_next, const float* __restrict__ beta0,
                    const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ betas, int Tp, int NL, int S, int T) {
  bwd_split_chain<K, false>(steps_next, lens, cs_next, beta0, nullptr, nullptr, A, B, betas, Tp,
                            NL, S, T);
}

template <int K>
__global__ void __launch_bounds__(SPLIT_THREADS)
fb_bwd_split_conf_kernel(const int32_t* __restrict__ steps_next,
                         const int32_t* __restrict__ lens, const float* __restrict__ cs_next,
                         const float* __restrict__ beta0, const float* __restrict__ alphas,
                         const float* __restrict__ mask, const float* __restrict__ A,
                         const float* __restrict__ B, float* __restrict__ conf, int Tp, int NL,
                         int S, int T) {
  bwd_split_chain<K, true>(steps_next, lens, cs_next, beta0, alphas, mask, A, B, conf, Tp, NL, S,
                           T);
}

// ---------------------------------------------------------------------------
// B20: per-lane counts.  Partial rows per (segment, lane), R = K*K + K*S + 1:
// [0, K*K) macc (j*K + k), then K*S emission rows (s*K + k), then the loglik.

template <int K>
__global__ void __launch_bounds__(STATS_THREADS)
fb_stats_part_kernel(const float* __restrict__ alphas, const float* __restrict__ betas,
                     const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
                     const float* __restrict__ B, float* __restrict__ part, int Tp, int NL,
                     int S, int Tt) {
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_emit[K * MAX_S * STATS_THREADS];  // [s*K + k][thread]
  for (int i = threadIdx.x; i < K * S; i += blockDim.x) s_B[i] = B[i];
  float* my = s_emit + threadIdx.x;
  for (int r = 0; r < K * S; ++r) my[r * STATS_THREADS] = 0.0f;
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int seg = blockIdx.y;
  const int len = min(lens[n], Tp);
  const int t0 = seg * Tt;
  const int t1 = min(t0 + Tt, len);
  float macc[K][K];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) macc[j][k] = 0.0f;
  float ll = 0.0f;
  if (t0 < t1) {
    // Normalized alpha of the step before the segment (unused at t == 0).
    float ap[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ap[k] = 0.0f;
    if (t0 > 0) {
      float a[K];
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = alphas[((size_t)(t0 - 1) * K + k) * nl + n];
      const float inv = 1.0f / fmaxf(seq_sum<K>(a), 1e-30f);
#pragma unroll
      for (int k = 0; k < K; ++k) ap[k] = a[k] * inv;
    }
    for (int t = t0; t < t1; ++t) {
      float a[K], b[K], g[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = __ldg(alphas + ((size_t)t * K + k) * nl + n);
        b[k] = __ldg(betas + ((size_t)t * K + k) * nl + n);
        g[k] = a[k] * b[k];
      }
      const int o = min(max(__ldg(steps + (size_t)t * nl + n), 0), S - 1);
      const float cs = fmaxf(seq_sum<K>(a), 1e-30f);
      const float inv_cs = 1.0f / cs;
      const float inv_g = 1.0f / fmaxf(seq_sum<K>(g), 1e-30f);
      float* e = my + (o * K) * STATS_THREADS;
#pragma unroll
      for (int k = 0; k < K; ++k) e[k * STATS_THREADS] += g[k] * inv_g;
      ll += logf(cs);
      if (t > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float w = s_B[k * S + o] * b[k] * inv_cs;
#pragma unroll
          for (int j = 0; j < K; ++j) macc[j][k] += ap[j] * w;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) ap[k] = a[k] * inv_cs;
    }
  }
  const int R = K * K + K * S + 1;
  float* dst = part + (size_t)seg * R * nl + n;
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) dst[(size_t)(j * K + k) * nl] = macc[j][k];
  for (int r = 0; r < K * S; ++r) dst[(size_t)(K * K + r) * nl] = my[r * STATS_THREADS];
  dst[(size_t)(R - 1) * nl] = ll;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
fb_stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ macc,
                       float* __restrict__ emit, float* __restrict__ ll, int nseg, int NL, int K,
                       int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int r = blockIdx.y;
  const int R = K * K + K * S + 1;
  float s = 0.0f;
  for (int g = 0; g < nseg; ++g) s += part[((size_t)g * R + r) * nl + n];
  if (r < K * K) {
    macc[(size_t)r * nl + n] = s;
  } else if (r < K * K + K * S) {
    emit[(size_t)(r - K * K) * nl + n] = s;
  } else {
    ll[n] = s;
  }
}

// ---------------------------------------------------------------------------
// Launchers and the C interface: every pointer and the stream arrive as
// void*, sizes as int.  Each function launches on the caller's stream and
// returns cudaGetLastError(), so a refused launch reaches the Python wrapper.

static inline unsigned blocks_for(int NL, int threads) {
  return (unsigned)((NL + threads - 1) / threads);
}

static inline bool bad_dims(int Tp, int NL, int K, int S) {
  return Tp <= 0 || NL <= 0 || K < 1 || K > MAX_K || S < 1 || S > MAX_S;
}

#define DISPATCH_K(K, CALL)                      \
  switch (K) {                                   \
    case 1: return CALL(1);                      \
    case 2: return CALL(2);                      \
    case 3: return CALL(3);                      \
    case 4: return CALL(4);                      \
    case 5: return CALL(5);                      \
    case 6: return CALL(6);                      \
    case 7: return CALL(7);                      \
    case 8: return CALL(8);                      \
    default: return (int)cudaErrorInvalidValue;  \
  }

template <int K>
static int launch_fwd(const void* steps, const void* lens, const void* a0, const void* A,
                      const void* B, void* alphas, int Tp, int NL, int S, cudaStream_t st) {
  fb_fwd_kernel<K><<<blocks_for(NL, CHAIN_THREADS), CHAIN_THREADS, 0, st>>>(
      (const int32_t*)steps, (const int32_t*)lens, (const float*)a0, (const float*)A,
      (const float*)B, (float*)alphas, Tp, NL, S);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_fwd_split(const void* steps, const void* lens, const void* a0, const void* A,
                            const void* B, void* alphas, int Tp, int NL, int S, cudaStream_t st) {
  if ((long long)NL * SPLIT_KP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fb_fwd_split_kernel<K><<<blocks_for(NL * SPLIT_KP, SPLIT_THREADS), SPLIT_THREADS, 0, st>>>(
      (const int32_t*)steps, (const int32_t*)lens, (const float*)a0, (const float*)A,
      (const float*)B, (float*)alphas, Tp, NL, S);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_fwd_sub(const void* steps, const void* lens, const void* a0, const void* A,
                          const void* B, void* alphas, void* pbuf, int Tp, int NL, int S, int G,
                          cudaStream_t st) {
  const int L = (Tp + G - 1) / G;
  const dim3 grid(blocks_for(NL, CHAIN_THREADS), (unsigned)G);
#define FWD_SUB_ARGS                                                                 \
  (const int32_t*)steps, (const int32_t*)lens, (const float*)a0, (const float*)A,    \
      (const float*)B, (float*)alphas, (float*)pbuf, Tp, NL, S, L
  fb_fwd_sub_kernel<K, 0><<<grid, CHAIN_THREADS, 0, st>>>(FWD_SUB_ARGS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fb_fwd_sub_kernel<K, 1><<<grid, CHAIN_THREADS, 0, st>>>(FWD_SUB_ARGS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fb_fwd_sub_kernel<K, 2><<<grid, CHAIN_THREADS, 0, st>>>(FWD_SUB_ARGS);
#undef FWD_SUB_ARGS
  return (int)cudaGetLastError();
}

template <int K, bool CONF>
static int launch_bwd(const void* steps_next, const void* lens, const void* cs_next,
                      const void* beta0, const void* alphas, const void* mask, const void* A,
                      const void* B, void* out, int Tp, int NL, int S, int T, cudaStream_t st) {
  fb_bwd_kernel<K, CONF><<<blocks_for(NL, CHAIN_THREADS), CHAIN_THREADS, 0, st>>>(
      (const int32_t*)steps_next, (const int32_t*)lens, (const float*)cs_next,
      (const float*)beta0, (const float*)alphas, (const float*)mask, (const float*)A,
      (const float*)B, (float*)out, Tp, NL, S, T);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_bwd_split(const void* steps_next, const void* lens, const void* cs_next,
                            const void* beta0, const void* A, const void* B, void* betas, int Tp,
                            int NL, int S, int T, cudaStream_t st) {
  if ((long long)NL * SPLIT_KP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fb_bwd_split_kernel<K><<<blocks_for(NL * SPLIT_KP, SPLIT_THREADS), SPLIT_THREADS, 0, st>>>(
      (const int32_t*)steps_next, (const int32_t*)lens, (const float*)cs_next,
      (const float*)beta0, (const float*)A, (const float*)B, (float*)betas, Tp, NL, S, T);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_bwd_split_conf(const void* steps_next, const void* lens, const void* cs_next,
                                 const void* beta0, const void* alphas, const void* mask,
                                 const void* A, const void* B, void* conf, int Tp, int NL, int S,
                                 int T, cudaStream_t st) {
  if ((long long)NL * SPLIT_KP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fb_bwd_split_conf_kernel<K>
      <<<blocks_for(NL * SPLIT_KP, SPLIT_THREADS), SPLIT_THREADS, 0, st>>>(
          (const int32_t*)steps_next, (const int32_t*)lens, (const float*)cs_next,
          (const float*)beta0, (const float*)alphas, (const float*)mask, (const float*)A,
          (const float*)B, (float*)conf, Tp, NL, S, T);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_bwd_sub(const void* steps_next, const void* lens, const void* cs_next,
                          const void* beta0, const void* A, const void* B, void* qbuf,
                          void* betas, int Tp, int NL, int S, int T, int G, cudaStream_t st) {
  const int L = (Tp + G - 1) / G;
  const dim3 grid(blocks_for(NL, CHAIN_THREADS), (unsigned)G);
#define BWD_SUB_ARGS                                                                    \
  (const int32_t*)steps_next, (const int32_t*)lens, (const float*)cs_next,               \
      (const float*)beta0, (const float*)A, (const float*)B, (float*)qbuf, (float*)betas, \
      Tp, NL, S, T, G, L
  fb_bwd_sub_kernel<K, true><<<grid, CHAIN_THREADS, 0, st>>>(BWD_SUB_ARGS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fb_bwd_sub_kernel<K, false><<<grid, CHAIN_THREADS, 0, st>>>(BWD_SUB_ARGS);
#undef BWD_SUB_ARGS
  return (int)cudaGetLastError();
}

// B19 in sub-lanes: B18's products launch into qbuf, then the messages and
// the chains emitting the confidence.
template <int K>
static int launch_bwd_sub_conf(const void* steps_next, const void* lens, const void* cs_next,
                               const void* beta0, const void* alphas, const void* mask,
                               const void* A, const void* B, void* conf, void* qbuf, int Tp,
                               int NL, int S, int T, int G, cudaStream_t st) {
  const int L = (Tp + G - 1) / G;
  const dim3 grid(blocks_for(NL, CHAIN_THREADS), (unsigned)G);
  fb_bwd_sub_kernel<K, true><<<grid, CHAIN_THREADS, 0, st>>>(
      (const int32_t*)steps_next, (const int32_t*)lens, (const float*)cs_next,
      (const float*)beta0, (const float*)A, (const float*)B, (float*)qbuf, nullptr, Tp, NL, S, T,
      G, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fb_bwd_sub_conf_kernel<K><<<grid, CHAIN_THREADS, 0, st>>>(
      (const int32_t*)steps_next, (const int32_t*)lens, (const float*)cs_next,
      (const float*)beta0, (const float*)alphas, (const float*)mask, (const float*)A,
      (const float*)B, (const float*)qbuf, (float*)conf, Tp, NL, S, T, G, L);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_prod(const void* sel, const void* tab, void* out, int Tp, int NL, int S,
                       cudaStream_t st) {
  constexpr int KP = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
  if ((long long)NL * KP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fb_prod_kernel<K><<<blocks_for(NL * KP, PROD_THREADS), PROD_THREADS, 0, st>>>(
      (const int32_t*)sel, (const float*)tab, (float*)out, Tp, NL, S);
  return (int)cudaGetLastError();
}

template <int K>
static int launch_stats(const void* alphas, const void* betas, const void* steps,
                        const void* lens, const void* B, void* part, void* macc, void* emit,
                        void* ll, int Tp, int NL, int S, int Tt, cudaStream_t st) {
  const int nseg = (Tp + Tt - 1) / Tt;
  if (nseg > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(NL, STATS_THREADS), (unsigned)nseg);
  fb_stats_part_kernel<K><<<grid, STATS_THREADS, 0, st>>>(
      (const float*)alphas, (const float*)betas, (const int32_t*)steps, (const int32_t*)lens,
      (const float*)B, (float*)part, Tp, NL, S, Tt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid(blocks_for(NL, REDUCE_THREADS), (unsigned)(K * K + K * S + 1));
  fb_stats_reduce_kernel<<<rgrid, REDUCE_THREADS, 0, st>>>(
      (const float*)part, (float*)macc, (float*)emit, (float*)ll, nseg, NL, K, S);
  return (int)cudaGetLastError();
}

extern "C" {

// B16: at K <= 4, G sub-lanes a lane (fb_pallas.fwd_sublanes), three
// launches over a (lane block, sub-lane) grid (pbuf [G, K*K, NL] scratch
// where G > 1), or one thread a chain at G = 1; at K >= 5 (G = 1) one chain
// split one thread a state.
int fb_fwd(const void* steps, const void* lens, const void* a0, const void* A, const void* B,
           void* alphas, void* pbuf, int Tp, int NL, int K, int S, int G, void* stream) {
  if (bad_dims(Tp, NL, K, S) || G < 1 || G > SUB_LANES_MAX || G > Tp ||
      (G > 1 && K > SUB_MAX_K))
    return (int)cudaErrorInvalidValue;
  if (G > 1) {
#define CALL_FS(KK) \
  launch_fwd_sub<KK>(steps, lens, a0, A, B, alphas, pbuf, Tp, NL, S, G, (cudaStream_t)stream)
    switch (K) {
      case 1: return CALL_FS(1);
      case 2: return CALL_FS(2);
      case 3: return CALL_FS(3);
      case 4: return CALL_FS(4);
      default: return (int)cudaErrorInvalidValue;
    }
#undef CALL_FS
  }
#define CALL_F(KK) launch_fwd<KK>(steps, lens, a0, A, B, alphas, Tp, NL, S, (cudaStream_t)stream)
#define CALL_FX(KK) \
  launch_fwd_split<KK>(steps, lens, a0, A, B, alphas, Tp, NL, S, (cudaStream_t)stream)
  switch (K) {
    case 1: return CALL_F(1);
    case 2: return CALL_F(2);
    case 3: return CALL_F(3);
    case 4: return CALL_F(4);
    case 5: return CALL_FX(5);
    case 6: return CALL_FX(6);
    case 7: return CALL_FX(7);
    case 8: return CALL_FX(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL_F
#undef CALL_FX
}

// B18: at K <= 4, G sub-lanes a lane (fb_pallas.bwd_sublanes), two launches
// over a (lane block, sub-lane) grid (qbuf [G, K*K + 1, NL] scratch where
// G > 1), or one thread a chain at G = 1; at K >= 5 (G = 1) one chain split
// one thread a state.
int fb_bwd(const void* steps_next, const void* lens, const void* cs_next, const void* beta0,
           const void* A, const void* B, void* betas, void* qbuf, int Tp, int NL, int K, int S,
           int T, int G, void* stream) {
  if (bad_dims(Tp, NL, K, S) || G < 1 || G > SUB_LANES_MAX || G > Tp ||
      (G > 1 && K > SUB_MAX_K))
    return (int)cudaErrorInvalidValue;
  if (G > 1) {
#define CALL_BS(KK)                                                                       \
  launch_bwd_sub<KK>(steps_next, lens, cs_next, beta0, A, B, qbuf, betas, Tp, NL, S, T, G, \
                     (cudaStream_t)stream)
    switch (K) {
      case 1: return CALL_BS(1);
      case 2: return CALL_BS(2);
      case 3: return CALL_BS(3);
      case 4: return CALL_BS(4);
      default: return (int)cudaErrorInvalidValue;
    }
#undef CALL_BS
  }
#define CALL_B(KK)                                                                          \
  launch_bwd<KK, false>(steps_next, lens, cs_next, beta0, nullptr, nullptr, A, B, betas, Tp, \
                        NL, S, T, (cudaStream_t)stream)
#define CALL_BX(KK)                                                                        \
  launch_bwd_split<KK>(steps_next, lens, cs_next, beta0, A, B, betas, Tp, NL, S, T, \
                       (cudaStream_t)stream)
  switch (K) {
    case 1: return CALL_B(1);
    case 2: return CALL_B(2);
    case 3: return CALL_B(3);
    case 4: return CALL_B(4);
    case 5: return CALL_BX(5);
    case 6: return CALL_BX(6);
    case 7: return CALL_BX(7);
    case 8: return CALL_BX(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL_B
#undef CALL_BX
}

// B19: B18's layout at every K (fb_bwd) with the confidence epilogue: at K
// <= 4, G sub-lanes a lane (qbuf [G, K*K + 1, NL] scratch where G > 1) or
// one thread a chain at G = 1; at K >= 5 (G = 1) one chain split one thread
// a state.
int fb_bwd_conf(const void* steps_next, const void* lens, const void* cs_next,
                const void* beta0, const void* alphas, const void* mask, const void* A,
                const void* B, void* conf, void* qbuf, int Tp, int NL, int K, int S, int T,
                int G, void* stream) {
  if (bad_dims(Tp, NL, K, S) || G < 1 || G > SUB_LANES_MAX || G > Tp ||
      (G > 1 && K > SUB_MAX_K))
    return (int)cudaErrorInvalidValue;
  if (G > 1) {
#define CALL_CS(KK)                                                                        \
  launch_bwd_sub_conf<KK>(steps_next, lens, cs_next, beta0, alphas, mask, A, B, conf, qbuf, \
                          Tp, NL, S, T, G, (cudaStream_t)stream)
    switch (K) {
      case 1: return CALL_CS(1);
      case 2: return CALL_CS(2);
      case 3: return CALL_CS(3);
      case 4: return CALL_CS(4);
      default: return (int)cudaErrorInvalidValue;
    }
#undef CALL_CS
  }
#define CALL_C(KK)                                                                        \
  launch_bwd<KK, true>(steps_next, lens, cs_next, beta0, alphas, mask, A, B, conf, Tp, NL, \
                       S, T, (cudaStream_t)stream)
#define CALL_CX(KK)                                                                   \
  launch_bwd_split_conf<KK>(steps_next, lens, cs_next, beta0, alphas, mask, A, B, conf, Tp, \
                            NL, S, T, (cudaStream_t)stream)
  switch (K) {
    case 1: return CALL_C(1);
    case 2: return CALL_C(2);
    case 3: return CALL_C(3);
    case 4: return CALL_C(4);
    case 5: return CALL_CX(5);
    case 6: return CALL_CX(6);
    case 7: return CALL_CX(7);
    case 8: return CALL_CX(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL_C
#undef CALL_CX
}

int fb_prod(const void* sel, const void* tab, void* out, int Tp, int NL, int K, int S,
            void* stream) {
  if (bad_dims(Tp, NL, K, S)) return (int)cudaErrorInvalidValue;
#define CALL_P(KK) launch_prod<KK>(sel, tab, out, Tp, NL, S, (cudaStream_t)stream)
  DISPATCH_K(K, CALL_P)
#undef CALL_P
}

int fb_stats(const void* alphas, const void* betas, const void* steps, const void* lens,
             const void* B, void* part, void* macc, void* emit, void* ll, int Tp, int NL, int K,
             int S, int Tt, void* stream) {
  if (bad_dims(Tp, NL, K, S) || Tt <= 0) return (int)cudaErrorInvalidValue;
#define CALL_S(KK)                                                                          \
  launch_stats<KK>(alphas, betas, steps, lens, B, part, macc, emit, ll, Tp, NL, S, Tt, \
                   (cudaStream_t)stream)
  DISPATCH_K(K, CALL_S)
#undef CALL_S
}

}  // extern "C"
