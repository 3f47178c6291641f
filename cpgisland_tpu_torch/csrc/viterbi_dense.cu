// Dense Viterbi: the three decode passes of the "pallas" engine as CUDA
// kernels for Hopper (sm_90a), for any model with K <= 8 states, with a
// plain C interface loaded through ctypes (cpgisland_tpu_torch/ops/_kernels.py).
// Plain versions of the same functions, used on the CPU and as the
// reference on the card, live in cpgisland_tpu_torch/ops/viterbi_pallas.py
// (dense_*_plain).
//
// Layout shared by all three: the time-major step stream [bk, nb] (global
// step b*bk + k sits at [k, b]), one thread per lane b looping over the bk
// steps of its block, so each warp's load of a step row is one coalesced
// transaction.  The state arrays (the K x K product, the K-state delta) are
// template-sized and stay in registers.  Every step's matrix
// M_s[m][j] = logA[m][j] + logB[j][s] (row S: the max-plus identity, for
// PAD) is built once per thread block into a shared-memory table; its rows
// are K*K + 1 floats apart, an odd stride, so threads of a warp that look up
// different symbols hit different banks.  A lookup returns exactly the f32
// value the TPU kernel's compare/select tree produced.
//
// Max-plus needs adds and maxes only, so nothing can contract into an FMA.
// The operands are the twin's: the step entry logA + logB is formed first,
// the chain value is added to it after (C[i][m] + M_m[j], delta[m] + M_m[j]),
// and a max is exact whatever its order, so every result equals its plain
// PyTorch version bit for bit.  The backpointer sweep starts from m = 0's
// candidate and takes a later m only when strictly greater: argmax's first
// maximum, as in the XLA twin, also where every candidate is LOG_ZERO-sized.
//
// What bounds them: each lane is a dependent chain of bk steps.  At the
// default block of 4096 steps a 64 Mi-symbol record has 16384 lanes, about
// 124 threads per SM: too few warps to hide a device-memory load behind
// other warps' work.  B13 and B14 therefore read their step streams ahead
// of the chain (B14 STEP_AHEAD steps, B13 below: the next group's loads fly
// while the current group's steps run) and, at K <= 2, the table rows of 8
// steps before those steps run; on up to 8 Ki lanes B13 also gives each
// row of a lane's product to a thread of its own (below).  B14 then runs at
// K = 2 at about 1.8x its byte bound (the same chain with no loads at
// 1.25x) and at K = 8, bound by the issue of its 64 candidates a step,
// within 10% of the chain with no loads (PERF.md).  B15 keeps one load a
// step.

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_ZERO (-1e30f)
#define THREADS 128
#define MAX_K 8
#define MAX_S 255
// Steps of the symbol stream B14 holds in registers ahead of its chain.
#define STEP_AHEAD 16

// Shared step table: row s holds M_s[m][j] at s * (K*K + 1) + m*K + j.
template <int K>
__device__ __forceinline__ void load_step_table(float* s_M, const float* __restrict__ logAT,
                                                const float* __restrict__ logB, int S) {
  constexpr int KK = K * K;
  for (int i = threadIdx.x; i < (S + 1) * KK; i += blockDim.x) {
    const int s = i / KK, mj = i % KK, m = mj / K, j = mj % K;
    float v;
    if (s < S) {
      v = logAT[j * K + m] + logB[j * S + s];
    } else {
      v = (m == j) ? 0.0f : LOG_ZERO;
    }
    s_M[s * (KK + 1) + mj] = v;
  }
  __syncthreads();
}

// q[r] = the symbol at step k0 + r of a lane's stream (column p), for the
// steps below bk; no load is issued past the stream's last row.
template <int N>
__device__ __forceinline__ void load_steps(const int32_t* __restrict__ p, int nb, int k0,
                                           int bk, int (&q)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int k = k0 + r;
    q[r] = k < bk ? __ldg(p + (size_t)k * nb) : 0;
  }
}

// B13: replaces cpgisland_tpu/ops/viterbi_pallas.py::_products_kernel.  Per
// lane, the max-plus product of its bk step matrices, written as
// out[i*K + m, b] = C[i][m].  Reads 4 B per step (the step stream), writes
// 4*K*K B per lane; K^2 (2K - 1) adds and maxes a real step (bound by
// operations at K = 8, by bytes at K = 2).  The first port ran one thread a
// lane with one load a step: at 16 Ki lanes a chain waiting on its load
// every step or two (K = 2, 12.5x its byte bound) or one warp a scheduler
// issuing 960 dependent-chain adds and maxes a step behind its loads (K =
// 8, 4.7x the ops bound).
//
// Row i of the product evolves alone, C[i] <- C[i] (x) M_s, so a lane's
// rows can go to R-row slices on KP = ceil(K / R) (rounded up to a power of
// two) neighbouring threads.  Each thread runs, for its rows, exactly the
// operations of the one-thread chain in its order (N[j] = C[0] + M[0][j],
// then max with C[m] + M[m][j], m = 1..K-1), so the output is the same
// bits whatever R.  Two layouts ship, chosen by the lane count (H100
// measurements, cpgisland_tpu_torch/tools/kernel_variants.py --group
// decode, PERF.md; not a law):
// - up to DENSE_ROWS_MAX_LANES lanes, R = 1: one row a thread, K times the
//   warps of one thread a lane, each issuing a K-th of the adds and maxes.
//   A lane's K threads each read the whole step matrix, so the table has
//   rows PROD_STRIDE(K*K) floats apart, a multiple of 4 and an odd count of
//   float4s: a thread reads a step's matrix as K*K/4 128-bit loads, the K
//   threads of a lane read one address (a broadcast), and the 4 lanes of a
//   warp at K = 8 (8 at K = 4, 16 at K = 2) looking up different symbols
//   start their rows in different banks (row s at bank 4s mod 32 with the
//   stride of 68 floats).  Rows win where the lanes are too few to fill
//   the schedulers: at K = 8 on 4 Ki lanes 0.94 ms against 2.62 one
//   thread a lane, and on the two_state decode's scaffold flushes (8
//   records padded to at most 512 Ki: 128 to 1,024 lanes of 4,096 steps,
//   32 of that decode's 33 launches) 0.12 ms against 0.18 at K = 2;
// - past it, R = K: one thread a lane, the first port's layout.  At 16 Ki
//   lanes (a 64 Mi record's 4,096-step blocks: the big record of the
//   two_state decode and of the flagship's masked decode) that is one warp a
//   scheduler, which at K = 8 issues the step's 960 adds and maxes nearly
//   every cycle (2.6 ms against the rows' 3.2: the rows issue the K-fold
//   table reads on top); at K = 2 the two tie at 16 Ki lanes and one
//   thread a lane wins past it (0.36 against 0.48 ms at 64 Ki).
// Both read the symbols ahead of the chain (PROD_AHEAD, LANE_AHEAD) and,
// at K <= 2, 8 steps' matrices before those steps run: the read-ahead is
// most of what moves K = 2 (0.98 -> 0.19 ms at 16 Ki lanes; at the flushes
// 0.43 -> 0.18 one thread a lane, 0.12 in rows).
#define PROD_THREADS 128
// One row a thread up to this many lanes, one thread a lane past it.
#define DENSE_ROWS_MAX_LANES 8192
// Steps of the symbol stream B13 holds ahead of its chain, one row a thread
// (PROD_AHEAD) and one thread a lane (LANE_AHEAD): 16 where a step is a few
// operations (K*K <= 4: the loads set the pace); above, 8 for the rows,
// where 16 more registers would cost them blocks an SM (3.2 against 4.2 ms
// at K = 8, 16 Ki lanes), and 2 for a lane, whose K x K product and step
// matrix already hold some 130 registers (4 and 8 ran 2.2-2.3x slower).
#define PROD_AHEAD(KK) ((KK) <= 4 ? 16 : 8)
#define LANE_AHEAD(KK) ((KK) <= 4 ? 16 : 2)
#define PROD_STRIDE(KK) \
  ((((KK) + 3) / 4 * 4) % 8 == 0 ? ((KK) + 3) / 4 * 4 + 4 : ((KK) + 3) / 4 * 4)

// B13's table: row s holds M_s[m][j] at s * PROD_STRIDE(K*K) + m*K + j (row
// S: the max-plus identity), zeros in the padding.
template <int K>
__device__ __forceinline__ void load_prod_table(float* s_M, const float* __restrict__ logAT,
                                                const float* __restrict__ logB, int S) {
  constexpr int KK = K * K, SP = PROD_STRIDE(KK);
  for (int i = threadIdx.x; i < (S + 1) * SP; i += blockDim.x) {
    const int s = i / SP, c = i % SP, m = c / K, j = c % K;
    float v = 0.0f;
    if (c < KK) v = s < S ? logAT[j * K + m] + logB[j * S + s] : ((m == j) ? 0.0f : LOG_ZERO);
    s_M[i] = v;
  }
  __syncthreads();
}

// TT steps of B13's chain for R rows C from their symbols q[0..TT-1]: the TT
// matrices are read first (as float4s), then the steps run in order (the
// first `left` of them: the rest lie past bk).
template <int K, int R, int TT>
__device__ __forceinline__ void prod_tile(const int* q, const float* __restrict__ s_M, int S,
                                          float (&C)[R][K], int left) {
  constexpr int NV = (K * K + 3) / 4, SP = PROD_STRIDE(K * K);
  float Mt[TT][NV * 4];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const float4* M4 = reinterpret_cast<const float4*>(s_M + min(q[i], S) * SP);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 x = M4[v];
      Mt[i][4 * v] = x.x;
      Mt[i][4 * v + 1] = x.y;
      Mt[i][4 * v + 2] = x.z;
      Mt[i][4 * v + 3] = x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    if (i < left) {
      const float* Ms = Mt[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float N[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float best = C[r][0] + Ms[j];
#pragma unroll
          for (int m = 1; m < K; ++m) best = fmaxf(best, C[r][m] + Ms[m * K + j]);
          N[j] = best;
        }
#pragma unroll
        for (int j = 0; j < K; ++j) C[r][j] = N[j];
      }
    }
  }
}

template <int K, int R>
__global__ void __launch_bounds__(PROD_THREADS)
dense_products_kernel(const int32_t* __restrict__ steps, const float* __restrict__ logAT,
                      const float* __restrict__ logB, float* __restrict__ out, int bk, int nb,
                      int S) {
  constexpr int G = (K + R - 1) / R;  // threads a lane carrying rows
  constexpr int KP = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  constexpr int TT = K * K <= 4 ? 8 : 1;
  constexpr int AH = R == 1 ? PROD_AHEAD(K * K) : LANE_AHEAD(K * K);
  extern __shared__ float s_P[];
  load_prod_table<K>(s_P, logAT, logB, S);
  const int i0 = (threadIdx.x % KP) * R;  // this thread's first row
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / KP;
  if (b >= nb || i0 >= K) return;
  float C[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < K; ++m) C[r][m] = (i0 + r == m) ? 0.0f : LOG_ZERO;
  const int32_t* p = steps + b;
  int q[AH], qn[AH];
  load_steps(p, nb, 0, bk, q);
  for (int k0 = 0; k0 < bk; k0 += AH) {
    load_steps(p, nb, k0 + AH, bk, qn);
#pragma unroll
    for (int h = 0; h < AH; h += TT)
      if (k0 + h < bk) prod_tile<K, R, TT>(q + h, s_P, S, C, bk - (k0 + h));
#pragma unroll
    for (int r = 0; r < AH; ++r) q[r] = qn[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (i0 + r < K) {
#pragma unroll
      for (int m = 0; m < K; ++m) out[(size_t)((i0 + r) * K + m) * nb + b] = C[r][m];
    }
}

// TT steps of B14's chain from their symbols q[0..TT-1]: the TT table rows
// are read first, so no step waits on a shared-memory lookup, then the steps
// run in order (the first `left` of them: the rest lie past bk), each
// storing its packed pointers at bp_t[i * nb].
template <int K, int TT>
__device__ __forceinline__ void dense_tile(const int* q, const float* __restrict__ s_M, int S,
                                           float (&d)[K], uint32_t& E,
                                           int32_t* __restrict__ bp_t, int nb, int left) {
  float Mt[TT][K * K];
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const float* Ms = s_M + min(q[i], S) * (K * K + 1);
#pragma unroll
    for (int mj = 0; mj < K * K; ++mj) Mt[i][mj] = Ms[mj];
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    if (i < left) {
      const float* Ms = Mt[i];
      float nd[K];
      uint32_t word = 0, newE = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float best = d[0] + Ms[j];
        uint32_t arg = 0;
#pragma unroll
        for (int m = 1; m < K; ++m) {
          const float c = d[m] + Ms[m * K + j];
          if (c > best) {
            best = c;
            arg = m;
          }
        }
        nd[j] = best;
        word |= arg << (3 * j);
        newE |= ((E >> (3 * arg)) & 7u) << (3 * j);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) d[j] = nd[j];
      E = newE;
      bp_t[(size_t)i * nb] = (int32_t)word;
    }
  }
}

// B14: replaces _backpointers_kernel.  The delta recursion from the true
// entering vector v_enter [K, nb]; each step's K argmax pointers pack 3 bits
// each into one int32 (bp[k, b]), and the exit -> entry table E (3 bits per
// exit state) composes E'[j] = E[bp[j]].  Writes the exit deltas dexit
// [K, nb] and the packed table ftab [nb].  Reads 4 B and writes 4 B per step.
// The symbols are read STEP_AHEAD steps ahead: group g + 1's loads are issued
// into qn before group g's steps run from q, so the chain no longer waits on
// a load every step or two; at K <= 2 the table rows of 8 steps are read
// before those steps run (at larger K a row is K*K floats: one step's), so
// the chain's own compares and E composition set the pace.  bk is any
// positive count: a group's steps past bk are neither loaded nor run, and
// every step run stores its word.
template <int K>
__global__ void __launch_bounds__(THREADS)
dense_backpointers_kernel(const int32_t* __restrict__ steps, const float* __restrict__ v_enter,
                          const float* __restrict__ logAT, const float* __restrict__ logB,
                          int32_t* __restrict__ bp, float* __restrict__ dexit,
                          int32_t* __restrict__ ftab, int bk, int nb, int S) {
  constexpr int TT = K * K <= 4 ? 8 : 1;
  extern __shared__ float s_M[];
  load_step_table<K>(s_M, logAT, logB, S);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float d[K];
#pragma unroll
  for (int m = 0; m < K; ++m) d[m] = v_enter[(size_t)m * nb + b];
  uint32_t E = 0;  // identity: exit j -> entry j
#pragma unroll
  for (int j = 0; j < K; ++j) E |= (uint32_t)j << (3 * j);
  const int32_t* p = steps + b;
  int q[STEP_AHEAD], qn[STEP_AHEAD];
  load_steps(p, nb, 0, bk, q);
  for (int k0 = 0; k0 < bk; k0 += STEP_AHEAD) {
    load_steps(p, nb, k0 + STEP_AHEAD, bk, qn);
#pragma unroll
    for (int h = 0; h < STEP_AHEAD; h += TT)
      if (k0 + h < bk)
        dense_tile<K, TT>(q + h, s_M, S, d, E, bp + (size_t)(k0 + h) * nb + b, nb,
                          bk - (k0 + h));
#pragma unroll
    for (int r = 0; r < STEP_AHEAD; ++r) q[r] = qn[r];
  }
#pragma unroll
  for (int m = 0; m < K; ++m) dexit[(size_t)m * nb + b] = d[m];
  ftab[b] = (int32_t)E;
}

// B15: replaces _backtrace_kernel.  Walks the packed pointers back from the
// anchored exit state, k = bk-1 down to 0, emitting the state after each
// step: path[k] = state; state = (bp[k] >> 3*state) & 7.  Reads 4 B and
// writes 4 B per step.
__global__ void __launch_bounds__(THREADS)
dense_backtrace_kernel(const int32_t* __restrict__ bp, const int32_t* __restrict__ exits,
                       int32_t* __restrict__ path, int bk, int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t state = (uint32_t)exits[b];
#pragma unroll 8
  for (int k = bk - 1; k >= 0; --k) {
    const uint32_t word = (uint32_t)__ldg(bp + (size_t)k * nb + b);
    path[(size_t)k * nb + b] = (int32_t)state;
    state = (word >> (3 * state)) & 7u;
  }
}

static inline unsigned grid_for(int nb) { return (unsigned)((nb + THREADS - 1) / THREADS); }

static inline size_t table_bytes(int K, int S) {
  return (size_t)(S + 1) * (size_t)(K * K + 1) * sizeof(float);
}

// Above 48 KiB a kernel must opt in to its dynamic shared memory.
template <typename Fn>
static int allow_smem(Fn fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int K, int R>
static int launch_products_r(const void* steps, const void* logAT, const void* logB, void* out,
                             int bk, int nb, int S, cudaStream_t stream) {
  constexpr int G = (K + R - 1) / R;
  constexpr int KP = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  if ((long long)nb * KP > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(S + 1) * PROD_STRIDE(K * K) * sizeof(float);
  int err = allow_smem(dense_products_kernel<K, R>, smem);
  if (err) return err;
  const unsigned grid = (unsigned)(((long long)nb * KP + PROD_THREADS - 1) / PROD_THREADS);
  dense_products_kernel<K, R><<<grid, PROD_THREADS, smem, stream>>>(
      (const int32_t*)steps, (const float*)logAT, (const float*)logB, (float*)out, bk, nb, S);
  return (int)cudaGetLastError();
}

// One row a thread up to DENSE_ROWS_MAX_LANES lanes, one thread a lane past it.
template <int K>
static int launch_products(const void* steps, const void* logAT, const void* logB, void* out,
                           int bk, int nb, int S, cudaStream_t stream) {
  if (nb <= DENSE_ROWS_MAX_LANES)
    return launch_products_r<K, 1>(steps, logAT, logB, out, bk, nb, S, stream);
  return launch_products_r<K, K>(steps, logAT, logB, out, bk, nb, S, stream);
}

template <int K>
static int launch_backpointers(const void* steps, const void* v_enter, const void* logAT,
                               const void* logB, void* bp, void* dexit, void* ftab, int bk, int nb,
                               int S, cudaStream_t stream) {
  const size_t smem = table_bytes(K, S);
  int err = allow_smem(dense_backpointers_kernel<K>, smem);
  if (err) return err;
  dense_backpointers_kernel<K><<<grid_for(nb), THREADS, smem, stream>>>(
      (const int32_t*)steps, (const float*)v_enter, (const float*)logAT, (const float*)logB,
      (int32_t*)bp, (float*)dexit, (int32_t*)ftab, bk, nb, S);
  return (int)cudaGetLastError();
}

#define DISPATCH_K(K, CALL)    \
  switch (K) {                 \
    case 1: return CALL(1);    \
    case 2: return CALL(2);    \
    case 3: return CALL(3);    \
    case 4: return CALL(4);    \
    case 5: return CALL(5);    \
    case 6: return CALL(6);    \
    case 7: return CALL(7);    \
    case 8: return CALL(8);    \
    default: return (int)cudaErrorInvalidValue; \
  }

// The C interface: every pointer and the stream arrive as void*, sizes as
// int.  Each function launches on the caller's stream and returns a CUDA
// error code (cudaGetLastError() after the launch), so a refused launch
// reaches the Python wrapper.
extern "C" {

int dense_products(const void* steps, const void* logAT, const void* logB, void* out, int bk,
                   int nb, int K, int S, void* stream) {
  if (bk <= 0 || nb <= 0 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
#define CALL_P(KK) launch_products<KK>(steps, logAT, logB, out, bk, nb, S, (cudaStream_t)stream)
  DISPATCH_K(K, CALL_P)
#undef CALL_P
}

int dense_backpointers(const void* steps, const void* v_enter, const void* logAT,
                       const void* logB, void* bp, void* dexit, void* ftab, int bk, int nb, int K,
                       int S, void* stream) {
  if (bk <= 0 || nb <= 0 || S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
#define CALL_B(KK)                                                                     \
  launch_backpointers<KK>(steps, v_enter, logAT, logB, bp, dexit, ftab, bk, nb, S, \
                          (cudaStream_t)stream)
  DISPATCH_K(K, CALL_B)
#undef CALL_B
}

int dense_backtrace(const void* bp, const void* exits, void* path, int bk, int nb,
                    void* stream) {
  if (bk <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  dense_backtrace_kernel<<<grid_for(nb), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bp, (const int32_t*)exits, (int32_t*)path, bk, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
