// Reduced one-hot Viterbi: the three decode passes, and the score-threading
// variant of the backpointer pass, as CUDA kernels for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (cpgisland_tpu_torch/ops/_kernels.py).  Plain versions of the same
// functions, used on the CPU and as the reference on the card, live in
// cpgisland_tpu_torch/ops/viterbi_onehot.py (oh_*_plain).
//
// Layout shared by all four: time-major streams [bk, nb] (global step
// b*bk + k sits at [k, b]), one thread per lane b looping over the bk steps
// of its block (B1: one thread per row of a lane's product; B3: one per
// segment of a lane's steps).  Neighbouring threads read neighbouring addresses at every
// step, so each warp's load of a step row is one coalesced 128-byte
// transaction.  The per-pair tables (at most MAX_PAIRS rows: S <= 16
// symbols, S*S real pairs, S resets, S PAD carries) are copied into shared
// memory once per block, nP rows and no more, so a small alphabet's block
// loads what it did before the bound grew; a lookup there returns exactly
// the f32 value the TPU kernel's compare/select tree produced.  Ragged lane
// counts are masked here; the wrapper pads bk to a multiple of 8 with
// identity pairs.
//
// Stacked decode (B26-B28): M models of one alphabet decode the SAME pair
// stream.  Each kernel carries a member axis on the grid (blockIdx.y = m;
// B28's on x, see there):
// a block loads member m's table rows (tab + m*nP rows) and writes member
// m's slice of every output, running the single-model chain body op for op,
// so member m's outputs equal a single-model launch on its operands bit for
// bit.  The single-model entries launch the same kernels instantiated with
// STACKED = false, which folds the member offsets away at compile time (a
// run-time member index of 0 cost B6 about a fifth of its time on the
// H100).  The TPU kernels interleave the M chains inside one lane instead;
// here a member per grid row needs no template cap on M and no M x 288-row
// table in one block, and M members bring M x nb threads to a latency-bound
// chain -- the extra warps are what stacking buys on this card.  The cost
// is that each member re-reads the shared pair stream, mostly from L2.
//
// Max-plus needs adds and maxes only.  There is no multiply, so no FMA can
// be contracted and every result equals its plain PyTorch version bit for
// bit: the add/max order below is the JAX kernels' order, op for op.
//
// What bounds them: each lane is a dependent chain of bk steps, and at the
// default block of 4096 steps a 64 Mi-symbol record has only 16384 lanes,
// about 124 threads per SM; a mixed-model flush (at most 1,024 lanes a
// member) fills at most 24 of the 132 SMs.  The max-plus chains (B1, B2,
// B6 and their stacked forms) run one chain body that reads its pair
// stream BP_AHEAD steps ahead (the next group's loads are issued before
// the current group's steps run), so the stream's latency hides behind the
// chain and the chain sets the pace: about 17 instructions a step for B2,
// nearly each waiting on the one before, some 40 cycles a step for a warp
// alone on its scheduler (PERF.md).  Deeper read-ahead, a shared-memory
// ring filled by cp.async, table rows read before their steps and blocks
// of 64 threads measured no faster for B2.  B1's 2x2 product is two chains
// that never meet (row i of C reads only row i), each B2's recursion
// entered at the identity's row i, so B1 runs one row a thread: twice the
// warps and half the work a chain, while the card has room for them (up to
// 48 Ki lanes of one model or 32 Ki lanes x members of several; past them
// one thread a lane, as first ported, whose single read of each pair then
// wins).  The float chains cannot be split along
// time without changing their bits; B3's walk can: it is integer logic,
// and what a run of words does to the bit is a map {0,1} -> {0,1} known
// before the bit that enters it.  B3 therefore splits each lane into up to
// BT_MAX_SEG segments, one warp each, joined by exact bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define LOG_ZERO (-1e30f)
#define MAX_S 16
#define MAX_PAIRS (MAX_S * MAX_S + 2 * MAX_S)  // 288 rows: 4.6 KB of tab, 2.3 KB of ids
#define THREADS 128
#define ROW_TILE 8
// Steps of the pair stream the max-plus chains (B1, B2, B6 and their
// stacked forms) hold in registers ahead of the chain (a multiple of
// ROW_TILE): one group's loads fly while the previous group's steps run.
#define BP_AHEAD 16
// B1 / B26: threads a block, one row of the 2x2 product each (both rows of
// PROD_THREADS / 2 lanes, on neighbouring threads), up to
// PROD_ROWS_MAX_LANES lanes of one model or PROD_ROWS_MAX_STACKED lanes x
// members of several; past them one thread a lane carries the product.
#define PROD_THREADS 128
#define PROD_ROWS_MAX_LANES 49152
#define PROD_ROWS_MAX_STACKED 32768
// B3 / B28: the words of a segment when the caller passes 0 (twice as many
// past BT_SEG_MANY_LANES lanes x members), the segments a lane at most
// (warps a block), the steps of pairs and words phase 2 holds ahead of its
// walk (a multiple of ROW_TILE), and the pointer words phase 1 holds ahead
// of its map.
#define BT_SEG 16
#define BT_SEG_MANY_LANES 32768
#define BT_MAX_SEG 32
#define BT_AHEAD 16
#define BT_MAP_AHEAD 8

// q[r] = the pair at step k0 + r of a lane's stream (column p), for the
// steps below bk; no load is issued past the stream's last row.
__device__ __forceinline__ void load_pairs(const int32_t* __restrict__ p, int nb, int k0,
                                           int bk, int (&q)[BP_AHEAD]) {
#pragma unroll
  for (int r = 0; r < BP_AHEAD; ++r) {
    const int k = k0 + r;
    q[r] = k < bk ? __ldg(p + (size_t)k * nb) : 0;
  }
}

// B1, B2 and B6 share one chain body: the reduced delta recursion of lane
// b from (d0, d1); strict > keeps first-max tie-breaking.  B2
// (WANT_BP) replaces _oh_backpointers_kernel: it enters at the true
// entering vector v_red [2, nb] and writes one int32 word per 8 steps
// (bp0 | bp1 << 1 at bits 2r, 2r+1), the exit deltas dexit [2, nb] and the
// exit -> entry composition bits ebits [nb].  Reads 4 B and writes 0.25 B
// per step.  The pairs are read BP_AHEAD steps ahead: group g + 1's loads
// are issued into qn before group g's steps run from q, so the chain waits
// on memory only where a whole group's latency exceeds its steps' time,
// and the chain's own instructions (about 40 cycles a step) set the pace.
// bk is a multiple of ROW_TILE, so a group's tail holds whole words, and a
// word past bk is neither run nor stored.
//
// B6 (WANT_BP, WANT_DMAX) replaces _oh_backpointers_score_kernel
// (cpgisland_tpu/ops/viterbi_onehot.py:481): the same recursion, plus the
// running chain max dmax[k, b] = max(d0, d1) after each step (block-relative;
// the flat batch decoder reads it at each record's last step to recover
// exact per-record scores).  The max hangs off the chain, so bp, dexit and
// ebits equal B2's bit for bit.  The store is time-major: a warp's 32 lanes
// write one coalesced 128-byte row per step.  It adds 4 B written per step
// (8.25 B a step in all), which is why the path-only decode keeps B2.
//
// B1 (neither) is one row of the block product: the same recursion with no
// pointers, its exit pair written to dexit.
template <bool WANT_BP, bool WANT_DMAX>
__device__ __forceinline__ void oh_backpointers_body(
    const int32_t* __restrict__ pair2, float d0, float d1, const float* __restrict__ s_tab,
    int32_t* __restrict__ bp, float* __restrict__ dexit, int32_t* __restrict__ ebits,
    float* __restrict__ dmax, int bk, int nb, int b) {
  int32_t E = 0b10;  // identity: exit c -> entry c
  const int32_t* p = pair2 + b;
  int q[BP_AHEAD], qn[BP_AHEAD];
  load_pairs(p, nb, 0, bk, q);
  for (int k0 = 0; k0 < bk; k0 += BP_AHEAD) {
    load_pairs(p, nb, k0 + BP_AHEAD, bk, qn);
#pragma unroll
    for (int w = 0; w < BP_AHEAD / ROW_TILE; ++w) {
      const int kw = k0 + w * ROW_TILE;
      if (kw < bk) {
        int32_t word = 0;
#pragma unroll
        for (int r = 0; r < ROW_TILE; ++r) {
          const float* t = s_tab + 4 * q[w * ROW_TILE + r];
          const float a0 = d0 + t[0];
          const float a1 = d1 + t[2];
          const float b0 = d0 + t[1];
          const float b1 = d1 + t[3];
          const int32_t bp0 = a1 > a0;
          const int32_t bp1 = b1 > b0;
          d0 = fmaxf(a0, a1);
          d1 = fmaxf(b0, b1);
          if (WANT_BP) {
            word |= (bp0 | (bp1 << 1)) << (2 * r);
            E = ((E >> bp0) & 1) | (((E >> bp1) & 1) << 1);
          }
          if (WANT_DMAX) dmax[(size_t)(kw + r) * nb + b] = fmaxf(d0, d1);
        }
        if (WANT_BP) bp[(size_t)(kw / ROW_TILE) * nb + b] = word;
      }
    }
#pragma unroll
    for (int r = 0; r < BP_AHEAD; ++r) q[r] = qn[r];
  }
  dexit[b] = d0;
  dexit[(size_t)nb + b] = d1;
  if (WANT_BP) ebits[b] = E;
}

// B2 / B6, and with M > 1 on the grid's y axis B27
// (_oh_backpointers_stacked_kernel, both arms): member m reads v_red[m] and
// its table rows, and writes bp[m] [bk/8, nb], dexit[m] [2, nb], ebits[m]
// [nb] and (WANT_DMAX) dmax[m] [bk, nb].
template <bool WANT_DMAX, bool STACKED>
__global__ void __launch_bounds__(THREADS)
oh_backpointers_kernel(const int32_t* __restrict__ pair2, const float* __restrict__ v_red,
                       const float* __restrict__ tab, int32_t* __restrict__ bp,
                       float* __restrict__ dexit, int32_t* __restrict__ ebits,
                       float* __restrict__ dmax, int bk, int nb, int nP) {
  __shared__ float s_tab[MAX_PAIRS * 4];
  const int m = STACKED ? blockIdx.y : 0;
  const float* tab_m = tab + (size_t)m * nP * 4;
  for (int i = threadIdx.x; i < nP * 4; i += blockDim.x) s_tab[i] = tab_m[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const float* v = v_red + (size_t)m * 2 * nb;
  oh_backpointers_body<true, WANT_DMAX>(
      pair2, v[b], v[(size_t)nb + b], s_tab, bp + (size_t)m * (bk / ROW_TILE) * nb,
      dexit + (size_t)m * 2 * nb, ebits + (size_t)m * nb,
      WANT_DMAX ? dmax + (size_t)m * bk * nb : nullptr, bk, nb, b);
}

// B1: replaces cpgisland_tpu/ops/viterbi_onehot.py::_oh_products_kernel;
// with M > 1 on the grid's y axis, B26 (_oh_products_stacked_kernel).
// Per lane, the 2x2 max-plus product of its bk pair-selected step matrices:
// out[m, 0..3, b] = C00, C01, C10, C11.  Row i of the product,
// C[i, c] <- max(C[i, 0] + T[0, c], C[i, 1] + T[1, c]) (the TPU kernel's
// operand order, viterbi_onehot.py:421-424), reads only row i: it is B2's
// recursion entered at the identity's row i, (0, LOG_ZERO) or (LOG_ZERO,
// 0), op for op.  So, within the rows' limits (PROD_ROWS_MAX_*), one
// thread carries one row and writes out[m, 2i] and out[m, 2i + 1].
// Thread 2j + i of a block runs row i of its lane j: the two rows of a
// lane sit on neighbouring threads of one warp and read each
// pair and each table row at one address (rows a warp apart doubled the
// shared-memory wavefronts, and ran up to 1.6x slower over 16 symbols,
// PERF.md).  Reads 4 B per step (the pair stream) and writes 16 B per lane
// and member.
template <bool STACKED>
__global__ void __launch_bounds__(PROD_THREADS)
oh_products_kernel(const int32_t* __restrict__ pair2, const float* __restrict__ tab,
                   float* __restrict__ out, int bk, int nb, int nP) {
  __shared__ float s_tab[MAX_PAIRS * 4];
  const int m = STACKED ? blockIdx.y : 0;
  const float* tab_m = tab + (size_t)m * nP * 4;
  for (int i = threadIdx.x; i < nP * 4; i += blockDim.x) s_tab[i] = tab_m[i];
  __syncthreads();
  const int i = threadIdx.x % 2;
  const int b = blockIdx.x * (PROD_THREADS / 2) + threadIdx.x / 2;
  if (b >= nb) return;
  oh_backpointers_body<false, false>(pair2, i ? LOG_ZERO : 0.0f, i ? 0.0f : LOG_ZERO, s_tab,
                                     nullptr, out + ((size_t)m * 4 + 2 * i) * nb, nullptr,
                                     nullptr, bk, nb, b);
}

// B1 / B26 past the rows' limits: one thread a lane carrying all four
// entries, each group of ROW_TILE pairs loaded and then run (the layout as
// first ported).  Members share one pair stream, which the rows read twice
// a member from L2: at 16,384 lanes the rows ran 0.37 ms at M = 3 and 0.60
// at M = 5 against this layout's 0.34 and 0.39; one model's lanes read
// their own streams, and the rows still won at 49,152 lanes (0.35 against
// 0.41 ms), tied at 65,536 (PERF.md).  Each entry runs the rows' ops in
// their order, so the two layouts' products are equal bit for bit.
template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
oh_products_lane_kernel(const int32_t* __restrict__ pair2, const float* __restrict__ tab,
                        float* __restrict__ out, int bk, int nb, int nP) {
  __shared__ float s_tab[MAX_PAIRS * 4];
  const int m = STACKED ? blockIdx.y : 0;
  const float* tab_m = tab + (size_t)m * nP * 4;
  for (int i = threadIdx.x; i < nP * 4; i += blockDim.x) s_tab[i] = tab_m[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float c00 = 0.0f, c01 = LOG_ZERO, c10 = LOG_ZERO, c11 = 0.0f;
  const int32_t* p = pair2 + b;
  for (int k0 = 0; k0 < bk; k0 += ROW_TILE) {
    int q[ROW_TILE];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) q[r] = __ldg(p + (size_t)(k0 + r) * nb);
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
      const float* t = s_tab + 4 * q[r];
      const float a00 = t[0], a01 = t[1], a10 = t[2], a11 = t[3];
      const float n00 = fmaxf(c00 + a00, c01 + a10);
      const float n01 = fmaxf(c00 + a01, c01 + a11);
      const float n10 = fmaxf(c10 + a00, c11 + a10);
      const float n11 = fmaxf(c10 + a01, c11 + a11);
      c00 = n00; c01 = n01; c10 = n10; c11 = n11;
    }
  }
  float* o = out + (size_t)m * 4 * nb;
  o[b] = c00;
  o[(size_t)nb + b] = c01;
  o[2 * (size_t)nb + b] = c10;
  o[3 * (size_t)nb + b] = c11;
}

// B3: replaces _oh_backtrace_kernel; with M > 1 on the grid's x axis, B28
// (_oh_backtrace_stacked_kernel).  Walks member m's packed pointers from its
// anchored exit bit, k = bk-1 down to 0, emitting idtab[m][pair][bit] — the
// full state id of the pair's exit group under member m.  Reads 4.25 B and
// writes 4 B per step and member.
//
// A lane's nw = bk/8 words split into G = ceil(nw / seg) = blockDim.x / 32
// segments of seg words, [s seg, min((s + 1) seg, nw)) (the last may be
// short, none is empty); warp s of a block is segment s of its 32 consecutive lanes, so
// every load and store stays a 128-byte time-major row.  B28 puts the
// member on the grid's x axis and the lane block on y: blocks are
// dispatched x first, so the M members of one lane block run side by side
// and their reads of the shared pair stream meet in L2 (at 4,096 x 16,384
// the launch is more than one wave: with the member on y, M = 2 ran about
// a fifth slower, PERF.md).  Phase 1: the thread of segment s > 0 walks
// its words from last to first from both entering bits at once, reading
// only the words, and leaves the segment's map f_s (the bit below its
// first step from the bit at its last, 2 bits) in shared memory.  Phase 2:
// after one barrier, the thread takes the lane's exit bit through f_{G-1},
// ..., f_{s+1} to its segment's last step and walks the segment as one
// thread walked the lane, its words and pairs read BT_AHEAD steps ahead.
// The bits are the one walk's bits, so every path equals the plain
// version's whatever G.

// The pointer words [w0, w0 + BT_MAP_AHEAD) of a lane (column wp), words
// below lo read as the identity word (each step keeps its bit).
__device__ __forceinline__ void load_words(const int32_t* __restrict__ wp, int nb, int w0, int lo,
                                           int32_t (&wd)[BT_MAP_AHEAD]) {
#pragma unroll
  for (int u = 0; u < BT_MAP_AHEAD; ++u) {
    const int w = w0 + u;
    wd[u] = w >= lo ? __ldg(wp + (size_t)w * nb) : (int32_t)0xAAAAAAAAu;
  }
}

// The steps [k0, k0 + BT_AHEAD) of a lane's pair stream (column pp) and
// their pointer words (column wp); whole words below step k_lo are not read.
__device__ __forceinline__ void load_back(const int32_t* __restrict__ pp,
                                          const int32_t* __restrict__ wp, int nb, int k0,
                                          int k_lo, int (&q)[BT_AHEAD],
                                          int32_t (&wd)[BT_AHEAD / ROW_TILE]) {
#pragma unroll
  for (int u = 0; u < BT_AHEAD / ROW_TILE; ++u) {
    const int kw = k0 + u * ROW_TILE;
    const bool in = kw >= k_lo;
    wd[u] = in ? __ldg(wp + (size_t)(kw / ROW_TILE) * nb) : 0;
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
      q[u * ROW_TILE + r] = in ? __ldg(pp + (size_t)(kw + r) * nb) : 0;
  }
}

template <bool STACKED>
__global__ void __launch_bounds__(32 * BT_MAX_SEG)
oh_backtrace_kernel(const int32_t* __restrict__ bp, const int32_t* __restrict__ pair2,
                    const int32_t* __restrict__ idtab, const int32_t* __restrict__ exit_bits,
                    int32_t* __restrict__ path, int bk, int nb, int nP, int seg) {
  __shared__ int32_t s_id[MAX_PAIRS * 2];
  __shared__ uint8_t s_map[BT_MAX_SEG * 32];
  const int m = STACKED ? blockIdx.x : 0;
  const int32_t* idtab_m = idtab + (size_t)m * nP * 2;
  for (int i = threadIdx.x; i < nP * 2; i += blockDim.x) s_id[i] = idtab_m[i];
  const int G = blockDim.x / 32, s = threadIdx.x / 32, l = threadIdx.x % 32;
  const int b = (STACKED ? blockIdx.y : blockIdx.x) * 32 + l;
  const int nw = bk / ROW_TILE;
  const int lo = s * seg, hi = min(lo + seg, nw);
  const int32_t* wp = bp + (size_t)m * nw * nb + b;
  if (s > 0 && b < nb) {
    // Phase 1: f_s from both entering bits, BT_MAP_AHEAD words at a time.
    int f0 = 0, f1 = 1;
    int32_t wd[BT_MAP_AHEAD], wn[BT_MAP_AHEAD];
    load_words(wp, nb, hi - BT_MAP_AHEAD, lo, wd);
    for (int w0 = hi - BT_MAP_AHEAD; w0 + BT_MAP_AHEAD > lo; w0 -= BT_MAP_AHEAD) {
      load_words(wp, nb, w0 - BT_MAP_AHEAD, lo, wn);
#pragma unroll
      for (int u = BT_MAP_AHEAD - 1; u >= 0; --u) {
#pragma unroll
        for (int r = ROW_TILE - 1; r >= 0; --r) {
          const int32_t x = wd[u] >> (2 * r);
          f0 = (x >> f0) & 1;
          f1 = (x >> f1) & 1;
        }
      }
#pragma unroll
      for (int u = 0; u < BT_MAP_AHEAD; ++u) wd[u] = wn[u];
    }
    s_map[s * 32 + l] = (uint8_t)(f0 | (f1 << 1));
  }
  __syncthreads();
  if (b >= nb) return;
  int32_t bit = exit_bits[(size_t)m * nb + b];
  for (int t = G - 1; t > s; --t) bit = (s_map[t * 32 + l] >> bit) & 1;
  // Phase 2: the walk of steps [k_lo, hi * 8), last to first.
  const int32_t* pp = pair2 + b;
  int32_t* out = path + (size_t)m * bk * nb + b;
  const int k_lo = lo * ROW_TILE;
  int q[BT_AHEAD], qn[BT_AHEAD];
  int32_t wq[BT_AHEAD / ROW_TILE], wqn[BT_AHEAD / ROW_TILE];
  load_back(pp, wp, nb, hi * ROW_TILE - BT_AHEAD, k_lo, q, wq);
  for (int k0 = hi * ROW_TILE - BT_AHEAD; k0 + BT_AHEAD > k_lo; k0 -= BT_AHEAD) {
    load_back(pp, wp, nb, k0 - BT_AHEAD, k_lo, qn, wqn);
#pragma unroll
    for (int u = BT_AHEAD / ROW_TILE - 1; u >= 0; --u) {
      const int kw = k0 + u * ROW_TILE;
      if (kw >= k_lo) {
#pragma unroll
        for (int r = ROW_TILE - 1; r >= 0; --r) {
          out[(size_t)(kw + r) * nb] = s_id[2 * q[u * ROW_TILE + r] + bit];
          bit = (wq[u] >> (2 * r + bit)) & 1;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BT_AHEAD; ++r) q[r] = qn[r];
#pragma unroll
    for (int u = 0; u < BT_AHEAD / ROW_TILE; ++u) wq[u] = wqn[u];
  }
}

static inline dim3 grid_for(int nb, int M) {
  return dim3((unsigned)((nb + THREADS - 1) / THREADS), (unsigned)M);
}

static inline bool bad_args(int bk, int nb, int nP, int M) {
  return nP < 1 || nP > MAX_PAIRS || bk % ROW_TILE || nb <= 0 || M < 1 || M > 65535;
}

template <bool STACKED>
static int products(const void* pair2, const void* tab, void* out, int bk, int nb, int nP,
                    int M, void* stream) {
  if (bad_args(bk, nb, nP, M)) return (int)cudaErrorInvalidValue;
  if ((size_t)M * nb > (M > 1 ? PROD_ROWS_MAX_STACKED : PROD_ROWS_MAX_LANES)) {
    oh_products_lane_kernel<STACKED><<<grid_for(nb, M), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pair2, (const float*)tab, (float*)out, bk, nb, nP);
    return (int)cudaGetLastError();
  }
  const unsigned lanes = PROD_THREADS / 2;
  oh_products_kernel<STACKED>
      <<<dim3(((unsigned)nb + lanes - 1) / lanes, (unsigned)M), PROD_THREADS, 0,
         (cudaStream_t)stream>>>((const int32_t*)pair2, (const float*)tab, (float*)out, bk, nb,
                                 nP);
  return (int)cudaGetLastError();
}

template <bool WANT_DMAX, bool STACKED>
static int backpointers(const void* pair2, const void* v_red, const void* tab, void* bp,
                        void* dexit, void* ebits, void* dmax, int bk, int nb, int nP, int M,
                        void* stream) {
  if (bad_args(bk, nb, nP, M)) return (int)cudaErrorInvalidValue;
  oh_backpointers_kernel<WANT_DMAX, STACKED>
      <<<grid_for(nb, M), THREADS, 0, (cudaStream_t)stream>>>(
          (const int32_t*)pair2, (const float*)v_red, (const float*)tab, (int32_t*)bp,
          (float*)dexit, (int32_t*)ebits, (float*)dmax, bk, nb, nP);
  return (int)cudaGetLastError();
}

// seg: words a segment, 0 for the kernel's own (BT_SEG, or 2 BT_SEG past
// BT_SEG_MANY_LANES lanes x members, where the card is full and the longer
// segments ran 3-5% faster, PERF.md); lengthened where a lane's bk/8 words
// would need more than BT_MAX_SEG segments.
template <bool STACKED>
static int backtrace(const void* bp, const void* pair2, const void* idtab,
                     const void* exit_bits, void* path, int bk, int nb, int nP, int M, int seg,
                     void* stream) {
  const unsigned blocks = (unsigned)((nb + 31) / 32);
  if (bad_args(bk, nb, nP, M) || seg < 0 || (STACKED && blocks > 65535))
    return (int)cudaErrorInvalidValue;
  const int nw = bk / ROW_TILE;
  const int need = (nw + BT_MAX_SEG - 1) / BT_MAX_SEG;
  if (seg == 0) seg = (size_t)M * nb > BT_SEG_MANY_LANES ? 2 * BT_SEG : BT_SEG;
  if (seg < need) seg = need;
  const int G = nw > seg ? (nw + seg - 1) / seg : 1;
  oh_backtrace_kernel<STACKED>
      <<<STACKED ? dim3((unsigned)M, blocks) : dim3(blocks), 32 * G, 0, (cudaStream_t)stream>>>(
          (const int32_t*)bp, (const int32_t*)pair2, (const int32_t*)idtab,
          (const int32_t*)exit_bits, (int32_t*)path, bk, nb, nP, seg);
  return (int)cudaGetLastError();
}

// The C interface: every pointer and the stream arrive as void*, sizes as
// int.  Each function launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.  The
// single-model entries (B1, B2, B6, B3) launch one member; the stacked ones
// (B26, B27 and its scores arm, B28) launch M, with every per-member operand
// stacked on a leading member axis.
extern "C" {

int oh_products(const void* pair2, const void* tab, void* out, int bk, int nb, int nP,
                void* stream) {
  return products<false>(pair2, tab, out, bk, nb, nP, 1, stream);
}

int oh_products_stacked(const void* pair2, const void* tab, void* out, int bk, int nb, int nP,
                        int M, void* stream) {
  return products<true>(pair2, tab, out, bk, nb, nP, M, stream);
}

int oh_backpointers(const void* pair2, const void* v_red, const void* tab, void* bp,
                    void* dexit, void* ebits, int bk, int nb, int nP, void* stream) {
  return backpointers<false, false>(pair2, v_red, tab, bp, dexit, ebits, nullptr, bk, nb, nP,
                                    1, stream);
}

int oh_backpointers_scores(const void* pair2, const void* v_red, const void* tab, void* bp,
                           void* dexit, void* ebits, void* dmax, int bk, int nb, int nP,
                           void* stream) {
  return backpointers<true, false>(pair2, v_red, tab, bp, dexit, ebits, dmax, bk, nb, nP, 1,
                                   stream);
}

int oh_backpointers_stacked(const void* pair2, const void* v_red, const void* tab, void* bp,
                            void* dexit, void* ebits, int bk, int nb, int nP, int M,
                            void* stream) {
  return backpointers<false, true>(pair2, v_red, tab, bp, dexit, ebits, nullptr, bk, nb, nP,
                                   M, stream);
}

int oh_backpointers_stacked_scores(const void* pair2, const void* v_red, const void* tab,
                                   void* bp, void* dexit, void* ebits, void* dmax, int bk,
                                   int nb, int nP, int M, void* stream) {
  return backpointers<true, true>(pair2, v_red, tab, bp, dexit, ebits, dmax, bk, nb, nP, M,
                                  stream);
}

int oh_backtrace(const void* bp, const void* pair2, const void* idtab, const void* exit_bits,
                 void* path, int bk, int nb, int nP, int seg, void* stream) {
  return backtrace<false>(bp, pair2, idtab, exit_bits, path, bk, nb, nP, 1, seg, stream);
}

int oh_backtrace_stacked(const void* bp, const void* pair2, const void* idtab,
                         const void* exit_bits, void* path, int bk, int nb, int nP, int M,
                         int seg, void* stream) {
  return backtrace<true>(bp, pair2, idtab, exit_bits, path, bk, nb, nP, M, seg, stream);
}

}  // extern "C"
