// Reduced one-hot forward-backward: the fused arm's three kernels, the
// one-pass arm's, the split arm's four and their stacked (multi-model) forms
// for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (cpgisland_tpu_torch/ops/_kernels.py).  Plain versions of the same
// functions, used on the CPU and as the reference on the card, live in
// cpgisland_tpu_torch/ops/fb_onehot.py (oh_prod_plain, oh_fwdbwd_plain,
// oh_seq_stats_plain, oh_fwd_plain, oh_bwd_plain, oh_bwd_conf_plain,
// oh_stats_plain and their *_stacked_plain forms); those of T2-T4 in
// cpgisland_tpu_torch/ops/fb_compose.py.
//
// Layout: time-major streams, [Tp, NL] for the pairs and [Tp, 2, NL] for
// alphas and betas (lane n of step t at t * NL + n, component c at
// (2t + c) * NL + n).  Lanes are independent chunks of the training batch,
// or consecutive stretches of one record (the posterior);
// neighbouring threads take neighbouring lanes, so every load and store of
// a warp is one coalesced transaction per row.  The per-pair 2x2 tables
// (at most MAX_S^2 real rows plus the identity row, which every PAD pair
// is clamped onto) sit in shared memory.
//
// B7 oh_prod_kernel replaces cpgisland_tpu/ops/fb_onehot.py::
// _oh_prod_kernel.  Per lane, the 2x2 (+, x) product of its pair-selected
// step matrices, renormalized by the product's total.  Bound: it reads 4 B
// per step and writes 16 B per lane, 0.27 GB at NL = 8192 lanes of 8192
// steps (0.080 ms at 3.35 TB/s).  What bounded the first design was the
// chain: one thread a lane walked 8192 dependent steps, each waiting on
// four IEEE divisions, at 2-3 warps an SM (21x the bound).  The design:
// B4's sub-lanes (fb_onehot.prod_sublanes: G = 16 sub-lanes of 512 steps
// from 8 Ki-step lanes), each sub-lane's product renormalized every 8
// steps by one reciprocal (the TPU kernel's cadence), then warp 0 of each
// block composes its lanes' G products in order with the one-chain step
// (prod_step).  Every product, sum and division is an explicit
// round-to-nearest intrinsic in the plain version's order (the total
// ((n00 + n01) + n10) + n11), so it equals fb_onehot.oh_prod_plain (in
// G > 1, fb_onehot._prod_sublanes_plain) bit for bit.  With G = 1 it is
// the one-chain product, the twin _xla_products_prob's operations; G > 1
// differs from it in the last bits, and its consumers read directions.

// B4 oh_fwdbwd_kernel replaces cpgisland_tpu/ops/fb_onehot.py::
// _oh_fwdbwd_kernel.  Bound: it reads 8 B and writes 16 B per step and
// lane, 1.61 GB at NL = 1024, Tp = 65,536 (0.48 ms at 3.35 TB/s).  What
// bounds it is the chains: each lane is two dependent chains of Tp steps
// whose every step waits on an IEEE division, and a training batch has
// only about a thousand lanes, so one thread a chain (the first design)
// ran about 155 ns a step, 21x the bound.  The design: each lane runs as G
// = Tp // SUBLANE_T sub-lanes (fb_onehot.sublanes; at most 32) joined by
// exact boundary messages in one launch (fwdbwd_sublanes below: the
// sub-lanes' transfer products, an in-order scan of the messages, then the
// chains from them), so a thread walks about 2 Tp / G steps in place of
// Tp.  The two chains are degree 0 in the vector they carry, so the
// messages' directions are all they need.  A block is one direction of 32
// lanes, warp g their sub-lane g: every load and store of a warp stays one
// 128-byte row (8-lane groups of 4 sub-lanes, tried first, spread each
// access over four rows and ran slower).  What bounds it now is that
// access pattern: the G sub-lanes of a lane walk G rows at once, each a
// 128-byte piece of a row NL * 8 B long, so the device memory sees
// scattered pieces.  Bit equality with the plain
// version: every multiply and add is an explicit round-to-nearest
// intrinsic (__fmul_rn / __fadd_rn), so nvcc contracts nothing into an
// FMA, and 1/x is __fdiv_rn (IEEE), in the plain version's operand order —
// including the backward's raw contraction first, then the multiply by the
// previous beta's reciprocal sum; the products' and messages' operations
// follow fb_onehot._fwdbwd_sublanes_plain one for one.
//
// B5 oh_seq_stats_*_kernel replaces fb_onehot.py::_oh_seq_stats_kernel.
// Bound: it reads 20 B per valid step (two alphas, two betas, the pair),
// 1.34 GB at NL = 1024, Tp = 65,536 (0.40 ms).  It has no serial chain:
// the previous step's normalized alpha, which the TPU kernel carries
// because its tiles walk in order, is read from the stream.  So each lane's
// time splits into segments of fb_onehot.stats_segment_t steps (a function
// of the shape; the card's sweep chose it), one thread per (lane,
// segment), enough threads to fill the card; a block of 32 lanes x 4
// segments sums its segments in order, and a second kernel sums each
// lane's blocks in order (no atomics, so the result is the same every
// run).  Only 4 of the K*K xi products of a step are nonzero (previous
// group x current group); they map one to one onto (pair, a, c), so each
// thread keeps 4 S^2 pair bins plus 2S emission bins in its own slice of
// shared memory (bank-conflict free: thread i owns bank i mod 32) and the
// second kernel writes bin (s_prev, s_cur, a, c) to macc row
// gt[s_prev, a] * K + gt[s_cur, c].  The sums run in another order than
// the plain version's, which agrees within a tolerance.  What bounded the
// first design was the loads: a step's five were issued when the step
// ran, at the 20 warps an SM its shared memory allows.  Now each thread
// reads its streams eight steps ahead (four and twelve ran slower:
// cpgisland_tpu_torch/tools/kernel_variants.py), decodes pairs through a
// shared table, reads
// a step's six accumulators before its arithmetic and takes IEEE
// reciprocals (__frcp_rn).  What bounds it now is the loads' access
// pattern, 128-byte pieces of rows, one a warp: the loads alone, without
// the arithmetic, take four fifths of its time on the card.
//
// B8 oh_fwdbwd_mat_kernel replaces fb_onehot.py::_oh_fwdbwd_mat_kernel, the
// one-pass arm: both reduced chains of a lane carried as 2x2 MATRICES from
// the identity (Va[t] = M_1 ... M_t renormalized by the matrix total, Wb[t]
// = M_{t+1} ... M_{l-1} self-normalized), so it runs before any boundary
// message exists and the lane products fall out of an O(NL) epilogue
// (fb_onehot.run_fb_mat_onehot): one T-scaling pass in place of B7 and B4.
// Bound: it reads 8 B of pairs and writes 32 B of matrix rows per step and
// lane, 2.68 GB at NL = 8192 lanes x 8192 steps (0.80 ms at 3.35 TB/s);
// like B4 each chain is a dependent sequence of steps that each wait on an
// IEEE division, so it is latency-bound above that.  The design is B4's:
// the forward and the backward chain of a lane are independent, so each
// gets its own thread (grid (lane blocks, 2), 32 threads a block), reads
// its pair stream a group of steps ahead, and keeps its 4 carries in
// registers; the table sits in shared memory; each step stores its four
// entries as four coalesced rows.  Bit equality with the plain version:
// round-to-nearest intrinsics in the plain version's operand order, the
// total summed ((00 + 01) + 10) + 11, 1/x as __fdiv_rn.
//
// The split arm (fused=False), B9-B12 with the stacked B22 and B23:
// B9 replaces fb_onehot.py::_oh_fwd_kernel (and, with the member axis, B22
// ::_oh_fwd_stacked_kernel): B4's forward chain alone.  B10 replaces
// ::_oh_bwd_kernel (B23 ::_oh_bwd_stacked_kernel with the member axis): the
// backward chain with true Rabiner betas, each step's raw contraction times
// 1 / c_{t+1} read from a cs_next stream, in the XLA twin's order (contract
// first, then scale; the TPU kernel pre-scales the table rows instead).
// B11 replaces ::_oh_bwd_conf_kernel: the same chain emitting the island
// confidence (m0 g0 + m1 g1) / max(g0 + g1, 1e-30), g = alpha * beta, with
// the mask keyed on the position's own symbol; the betas never reach device
// memory.  Bound: B9
// reads 4 B and writes 8 B a step (0.24 ms at 67.1 M steps), B10 reads 8 B
// and writes 8 B (0.32 ms), B11 reads 20 B (both pair streams, cs_next, the
// two alphas) and writes 4 B (0.48 ms).  What bounded B9 and B10 in their
// first design, one thread a chain (32 to a block, operands read a group
// ahead), was the chain: a training batch has only about a thousand lanes,
// each Tp dependent steps that wait on an IEEE division, about 150 ns a
// step, 42x and 27x their bounds.  Now each lane runs as G sub-lanes
// joined by exact boundary messages, so a thread walks about Tp / G steps:
// - B9 takes B4's G (fb_onehot.sublanes) and B4's operations in B4's order
//   (sub_prod over the valid steps 0 < t < len, the in-order sub_message<true>
//   scan from a0, fwd_range from each message, the last valid alpha carried
//   past len), so its alphas equal B4's bit for bit.  Its layout is B16's,
//   oh_fwd_sub_kernel over a (32-lane block, sub-lane, member) grid in three
//   launches: the products, then each sub-lane's message and chain, then the
//   alphas past the last valid step (B4's own layout, a lane's sub-lanes the
//   warps of one block, ran 1.35x slower on the training batch).
// - B10 is DEGREE 1 in beta (B12 reads the Rabiner scale), so a direction,
//   all that B4's messages carry, is not enough: its messages carry the
//   betas' magnitude, B18's design for the 2x2 chain (oh_bwd_sub_kernel,
//   below), G = fb_onehot.split_bwd_sublanes.
// - B11 runs B10's sub-lanes (the same products launch, then the chain with
//   the confidence in place of the betas: oh_bwd_sub_kernel<false, true>),
//   so a confidence-only run equals the confidence over B10's betas, and
//   over B23's for a stacked member, bit for bit.
// At G == 1 all three keep their one-thread-a-chain kernels (oh_fwd_kernel,
// oh_bwd_kernel<false> and <true>), op for op the XLA twins.  Every
// operation is an explicit round-to-nearest intrinsic in the plain
// versions' order.
//
// B12 (oh_seq_stats_part_kernel<true> + B5's reduce) replaces
// ::_oh_stats_kernel: the chunked counts over the split arm's cs-scaled
// streams, DEGREE 1 in the betas (xi[a, c] = a_hat_{t-1}[a] * B_red[s_t, c]
// * beta_t[c] / c_t, no per-pair normalizer), each lane's t == 0 pair
// excluded (every chunk lane is its own record).  Bound: 20 B per valid
// step (two alphas, two betas, the pair; 0.35 ms on the training batch),
// the same as B5's, with less arithmetic (no z, no table row).  What
// bounded its first design, one thread per (lane, segment of the TPU
// layout's tile) in blocks of 128 lanes of one segment, was B5's old one:
// a step's five loads issued when the step ran, two IEEE divisions a step,
// and no block sums, so the reduce read four times B5's partial rows.  So
// B12 is B5's body with the CS flag (stats_step<FIRST, true>): the same
// segments (fb_onehot.stats_segment_t of the shape), the same 32 lanes x
// stats_segments_per_block segments a block with in-order block sums, the
// same decode table, loads STATS_AHEAD steps ahead, __frcp_rn and the same
// reduce; its sums run in another order than the plain version's einsum,
// which agrees within a tolerance, and the same every run (no atomics).
// On the H100 it then runs as B5 does, bound as B5 is by the loads' access
// pattern: 0.62 ms on the training batch against B5's 0.67 and the first
// design's 0.97 (PERF.md), its segment rule B5's (512 steps were fastest
// for both on the genome's 1,390 chunks).
//
// B21 (oh_prod_kernel with M > 1), B24 oh_fwdbwd_stacked_kernel and B25
// (the B5 kernels with M > 1) replace fb_onehot.py::_oh_prod_stacked_kernel,
// _oh_fwdbwd_stacked_kernel and _oh_seq_stats_stacked_kernel: B7, B4 and B5
// for M models over ONE shared pair stream (the members of a comparison, or
// a family trained in lockstep).  On the TPU one program carries M members'
// rows; here the member is one more grid dimension: one thread per (lane,
// sub-lane, member) for B21, per (lane, sub-lane, direction, member) for
// B24, per (lane, segment, member) for B25, each running exactly the single-model body on
// its member's table (in that block's shared memory, so M does not bound the
// table space) and its member's slice of the member-major operands ([M, Tp,
// 2, NL] streams, [M, 4, NL] products).  So a member's outputs equal its own
// single-model launch bit for bit, and the launch is M times wider (B21 in
// B7's sub-lanes and B24 in B4's, G the same for every member).  Bound:
// B21 and B24 read the shared pair stream once and write M times the
// single-model outputs; B25 reads M times B5's streams.

// T2-T4, the pair-composition variants of B9's forward chain, replace the
// benchmark-only kernels of tools/bench_compose.py (T1 is B9 itself).
// Bounds at the benchmark's geometry, 64 Mi symbols as 1024 lanes of
// 65,536 steps, alphas written once at 8 B a symbol (3.35 TB/s):
// T2 oh_fwd_strm replaces ::_fwd_strm_kernel: B9's chain with the four
// entries of each step's matrix streamed from device memory in place of
// B9's pair load and shared-table lookup; 16 + 8 B a symbol, 1.61 GB, 0.481
// ms.  It runs B9's own sub-lane kernel (oh_fwd_sub_kernel<PHASE, true>:
// the step source a template flag of sub_prod and fwd_range) at B9's G, so
// its alphas equal B9's bit for bit at every G; at G = 1 oh_fwd_strm_kernel,
// B9's one chain over the streams.  T3 oh_fwd_comp replaces
// ::_fwd_comp_kernel: the double-step chain over ten streams (T2 = T_even .
// T_odd, R = the row sums of T_even, T_even), alpha_{2h+1} = (v . T2) / (v .
// R) carried while alpha_{2h} = (v . T_even) / (v0 + v1) hangs off the
// chain; 20 + 8 B a symbol, 1.88 GB, 0.561 ms.  It runs in B9's G sub-lanes
// of whole double steps, B9's three launches (oh_fwd_comp_sub_kernel; the
// chain is degree 0 in v, so a sub-lane's message is a direction), its
// alphas the one chain's in exact arithmetic; at G = 1 oh_fwd_comp_kernel,
// one chain.  T4 oh_fwd_compsel replaces ::_fwd_compsel_kernel: T3's chain
// with the composed rows looked up from three tables (at S = 4: 96 x 4, 17
// x 2 and 17 x 4 floats) in shared memory, keyed by two int32 index
// streams; 4 + 8 B a symbol, 0.81 GB, 0.240 ms.  What bounded its first
// design, one thread a lane (32 warps on 132 SMs at the benchmark's 1,024
// lanes), was the chain: 32,768 dependent double steps a thread, each
// waiting on two IEEE divisions.  Now it runs T3's sub-lanes and T3's three
// launches (oh_fwd_compsel_sub_kernel: T3's phases, comp_sub_phase, over a
// table step source for the products and a table row source for the chain,
// its indices read COMPSEL_AHEAD double steps ahead, each table row one
// vector load); at G = 1 its phase 1 alone, one chain.  The phases read
// 2 B a symbol (the products' index) and 4 B (both indices) beside the 8 B
// of alphas, 14 B in all.  Its tables hold T3's stream values bit for bit
// (the plain side builds them with T3's formula), so on chained pairs its
// alphas equal T3's bit for bit at every G.  The one-chain kernels run one
// thread a lane (32 to a block) like B9 at G = 1; the streams are read a
// group of steps ahead so a step waits on the chain alone.  A double step's
// chain (v . R -> 1 / den beside v . T2, then one multiply) is no deeper
// than B9's single step, so T3 and T4 carry one dependent step per two
// symbols.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_steps.cuh"  // pow2f, scale_exp: B10's power-of-two message scaling
#include "onehot_steps.cuh"

#define FB_THREADS 32
#define REDUCE_THREADS 128

// ---------------------------------------------------------------------------
// The chain bodies, one lane each.  The single-model kernels and the stacked
// ones (B21, B24, B25) call the same functions on their member's table and
// output slice, so a member's results in a stacked launch equal its own
// single-model launch bit for bit.

// One step of B4's forward (and of T2's): alpha_t = (alpha_{t-1} . M_t) *
// (1 / sum alpha_{t-1}) on valid steps; the entering vector at t == 0;
// carried past len.  m0..m3 are M_t's entries 00, 01, 10, 11.
__device__ __forceinline__ void fwd_step(float& v0, float& v1, float m0, float m1, float m2,
                                         float m3, int t, int len, float e0, float e1) {
  const float inv = __fdiv_rn(1.0f, __fadd_rn(v0, v1));
  const float raw0 = __fadd_rn(__fmul_rn(v0, m0), __fmul_rn(v1, m2));
  const float raw1 = __fadd_rn(__fmul_rn(v0, m1), __fmul_rn(v1, m3));
  if (t == 0) {
    v0 = e0;
    v1 = e1;
  } else if (t < len) {
    v0 = __fmul_rn(raw0, inv);
    v1 = __fmul_rn(raw1, inv);
  }
}

// T2's step source and T3's streams: float streams read STRM_AHEAD rows
// ahead of the chain (a row holds 4 or 10 floats, a pair one int).
#define STRM_AHEAD 8

// f[r][k] = stream k of the lane at row first + r (streams ``plane`` floats
// apart, rows ``nl`` apart); 0 past the last row, which is never read.
template <int NS>
__device__ __forceinline__ void load_rows(const float* p, size_t plane, size_t nl, int first,
                                          int rows, float (&f)[STRM_AHEAD][NS]) {
#pragma unroll
  for (int r = 0; r < STRM_AHEAD; ++r) {
    const int t = first + r;
#pragma unroll
    for (int k = 0; k < NS; ++k)
      f[r][k] = t < rows ? __ldg(p + k * plane + (size_t)t * nl) : 0.0f;
  }
}

// The step source of four streamed planes (onehot_steps.cuh's PairSteps has
// the interface): entry k of row t at p[k * plane + t * nl], every step
// real.  T2's matrices ([4, Tp, NL]) and T3's composed T2 rows (rows 0-3 of
// [10, H, NL], a row a double step).
struct StreamSteps {
  static constexpr int AHEAD = STRM_AHEAD;
  struct Group {
    float f[AHEAD][4];
  };
  const float* p;
  size_t plane, nl;
  int rows;
  __device__ __forceinline__ void load(int first, Group& g) const {
    load_rows<4>(p, plane, nl, first, rows, g.f);
  }
  __device__ __forceinline__ void mat(const Group& g, int r, float (&m)[4]) const {
    m[0] = g.f[r][0];
    m[1] = g.f[r][1];
    m[2] = g.f[r][2];
    m[3] = g.f[r][3];
  }
  __device__ __forceinline__ bool real(const Group&, int) const { return true; }
};

// B4's forward chain over steps [tb, te) of a lane, from (v0, v1), the vector
// entering step tb (at tb == 0 the entering vector e itself); leaves the
// alpha of step te - 1 in (v0, v1).  ``src`` reads the lane's steps (B4 and
// B9 a pair stream, T2 its streamed matrices); ``out`` points at the lane's
// column.
template <class Src>
__device__ __forceinline__ void fwd_range(const Src& src, float& v0, float& v1, float e0,
                                          float e1, float* out, int len, int tb, int te,
                                          size_t nl) {
  typename Src::Group q, qn;
  src.load(tb, q);
  for (int t0 = tb; t0 < te; t0 += Src::AHEAD) {
    src.load(t0 + Src::AHEAD, qn);
#pragma unroll
    for (int r = 0; r < Src::AHEAD; ++r) {
      const int t = t0 + r;
      if (t < te) {
        float m[4];
        src.mat(q, r, m);
        fwd_step(v0, v1, m[0], m[1], m[2], m[3], t, len, e0, e1);
        out[(size_t)(2 * t) * nl] = v0;
        out[(size_t)(2 * t + 1) * nl] = v1;
      }
    }
    q = qn;
  }
}

// fwd_range over a lane's pair stream ``p`` and the table ``s_tab``.
__device__ __forceinline__ void fwd_range(const int32_t* p, const float* s_tab, float& v0,
                                          float& v1, float e0, float e1, float* out, int len,
                                          int tb, int te, int Tp, size_t nl, int nreal) {
  fwd_range(PairSteps{p, s_tab, nl, Tp, nreal}, v0, v1, e0, e1, out, len, tb, te, nl);
}

// The whole lane's forward chain (B9, B22, and B4 with one sub-lane).
__device__ __forceinline__ void fwd_chain(const int32_t* p, const float* s_tab, float e0,
                                          float e1, float* out, int len, int Tp, size_t nl,
                                          int nreal) {
  float v0 = e0, v1 = e1;
  fwd_range(p, s_tab, v0, v1, e0, e1, out, len, 0, Tp, Tp, nl, nreal);
}

// B4's backward over steps te-1 down to tb, from (b0, b1), the beta after
// step te - 1: beta_t = (M_{t+1} . beta_{t+1}) * (1 / sum beta_{t+1})
// where t <= T-2 and t+1 < len, else carried.
__device__ __forceinline__ void bwd_range(const int32_t* p, const float* s_tab, float b0,
                                          float b1, float* out, int len, int tb, int te,
                                          int Tp, size_t nl, int nreal, int T) {
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_group(p, nl, te - 1, -1, Tp, nreal, q);
  for (int k0 = 0; k0 < te - tb; k0 += LOOKAHEAD) {
    load_group(p, nl, te - 1 - (k0 + LOOKAHEAD), -1, Tp, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = te - 1 - (k0 + r);
      if (t >= tb) {
        const float* m = s_tab + 4 * q[r];
        const float binv = __fdiv_rn(1.0f, __fadd_rn(b0, b1));
        const float x0 = __fmul_rn(__fadd_rn(__fmul_rn(m[0], b0), __fmul_rn(m[1], b1)), binv);
        const float x1 = __fmul_rn(__fadd_rn(__fmul_rn(m[2], b0), __fmul_rn(m[3], b1)), binv);
        if (t <= T - 2 && t + 1 < len) {
          b0 = x0;
          b1 = x1;
        }
        out[(size_t)(2 * t) * nl] = b0;
        out[(size_t)(2 * t + 1) * nl] = b1;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

// f[r] = the lane's value at step first + step * r; 1 outside [0, Tp).
__device__ __forceinline__ void load_fgroup(const float* p, size_t stride, int first, int step,
                                            int Tp, float (&f)[LOOKAHEAD]) {
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = first + step * r;
    f[r] = (t >= 0 && t < Tp) ? __ldg(p + (size_t)t * stride) : 1.0f;
  }
}

// B11's per-position operands of steps first - r (r < LOOKAHEAD): the
// position's pair index, raw (its island-mask row keys the per-pair mask
// table), and its two alphas, read a group ahead of the chain as the pairs
// are.  Only loads here: a value computed from a load would make the warp
// wait for each load in turn.
__device__ __forceinline__ void load_conf_group(const int32_t* pc, const float* al, size_t nl,
                                                int first, int Tp, int (&p)[LOOKAHEAD],
                                                float (&a0)[LOOKAHEAD], float (&a1)[LOOKAHEAD]) {
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = first - r;
    const bool in = t >= 0 && t < Tp;
    p[r] = in ? __ldg(pc + (size_t)t * nl) : 0;
    a0[r] = in ? __ldg(al + (size_t)(2 * t) * nl) : 0.0f;
    a1[r] = in ? __ldg(al + (size_t)(2 * t + 1) * nl) : 0.0f;
  }
}

// B11's island-mask row of every pair index into s_pmask [2 (S^2 + S)]:
// real pairs p = prev * S + cur take cur's row, PAD pairs S^2 + s take s's,
// so no step divides.  Returns their count, S^2 + S; the caller's
// load_table syncs the block.
__device__ __forceinline__ int load_pmask(float* s_pmask, const float* mtab, int nreal, int S) {
  const int npm = nreal + S;
  for (int i = threadIdx.x; i < npm; i += blockDim.x) {
    const int sym = i < nreal ? i % S : i - nreal;
    s_pmask[2 * i] = mtab[2 * sym];
    s_pmask[2 * i + 1] = mtab[2 * sym + 1];
  }
  return npm;
}

// B11's confidence at a valid step t < len: (m0 g0 + m1 g1) / max(g0 + g1,
// 1e-30), g = alpha_t * beta_t, (m0, m1) the mask row of pair index pp (a
// pair index past the table carries no symbol: mask 0, as the plain
// version's select gives).
__device__ __forceinline__ float conf_of(int pp, float a0, float a1, float b0, float b1,
                                         const float* s_pmask, int npm) {
  const bool known = (unsigned)pp < (unsigned)npm;
  const float m0 = known ? s_pmask[2 * pp] : 0.0f;
  const float m1 = known ? s_pmask[2 * pp + 1] : 0.0f;
  const float g0 = __fmul_rn(a0, b0);
  const float g1 = __fmul_rn(a1, b1);
  const float tot = fmaxf(__fadd_rn(g0, g1), 1e-30f);
  return __fdiv_rn(__fadd_rn(__fmul_rn(m0, g0), __fmul_rn(m1, g1)), tot);
}

// B10's backward (B11's with CONF), t = Tp-1 down to 0: beta_t = (M_{t+1} .
// beta_{t+1}) * (1 / c_{t+1}) where t <= T-2 and t+1 < len, else carried;
// ``cn`` is the lane's cs_next column (c_{t+1} at row t, 1 at the last).
// Without CONF it stores beta_t at rows 2t, 2t + 1 of ``out``; with CONF it
// stores conf[t] at row t: 0 past len, else (m0 g0 + m1 g1) / max(g0 + g1,
// 1e-30) with g = alpha_t * beta_t and (m0, m1) the island-mask row of the
// position's own symbol (``pc`` the unclamped pair column, ``al`` the
// alphas column, ``s_pmask`` [2 (S^2 + S)] the mask row of every pair
// index: a real pair's current symbol, a PAD's carried one).  Every operand
// off the chain is read a group of steps ahead, so a step waits on its
// chain alone.
template <bool CONF>
__device__ __forceinline__ void split_bwd_chain(const int32_t* pn, const float* cn,
                                                const float* s_tab, float b0, float b1,
                                                float* out, int len, int Tp, size_t nl,
                                                int nreal, int T, const int32_t* pc,
                                                const float* al, const float* s_pmask,
                                                int npm) {
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float c[LOOKAHEAD], cx[LOOKAHEAD];
  int pp[LOOKAHEAD], ppx[LOOKAHEAD];
  float a0[LOOKAHEAD], a1[LOOKAHEAD], a0x[LOOKAHEAD], a1x[LOOKAHEAD];
  load_group(pn, nl, Tp - 1, -1, Tp, nreal, q);
  load_fgroup(cn, nl, Tp - 1, -1, Tp, c);
  if (CONF) load_conf_group(pc, al, nl, Tp - 1, Tp, pp, a0, a1);
  for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
    const int next = Tp - 1 - (k0 + LOOKAHEAD);
    load_group(pn, nl, next, -1, Tp, nreal, qn);
    load_fgroup(cn, nl, next, -1, Tp, cx);
    if (CONF) load_conf_group(pc, al, nl, next, Tp, ppx, a0x, a1x);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0) {
        const float* m = s_tab + 4 * q[r];
        const float inv_cn = __fdiv_rn(1.0f, c[r]);
        const float x0 = __fmul_rn(__fadd_rn(__fmul_rn(m[0], b0), __fmul_rn(m[1], b1)), inv_cn);
        const float x1 = __fmul_rn(__fadd_rn(__fmul_rn(m[2], b0), __fmul_rn(m[3], b1)), inv_cn);
        if (t <= T - 2 && t + 1 < len) {
          b0 = x0;
          b1 = x1;
        }
        if (CONF) {
          out[(size_t)t * nl] = t < len ? conf_of(pp[r], a0[r], a1[r], b0, b1, s_pmask, npm)
                                        : 0.0f;
        } else {
          out[(size_t)(2 * t) * nl] = b0;
          out[(size_t)(2 * t + 1) * nl] = b1;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      c[r] = cx[r];
      if (CONF) {
        pp[r] = ppx[r];
        a0[r] = a0x[r];
        a1[r] = a1x[r];
      }
    }
  }
}

// One step of B7's product: C <- C . m, each entry then over the total
// ((n00 + n01) + n10) + n11, the twin's order (fb_onehot.py:162-167).  The
// sub-lane form composes its sub-lanes' products with the same step.
__device__ __forceinline__ void prod_step(float& c00, float& c01, float& c10, float& c11,
                                          const float* m) {
  const float n00 = __fadd_rn(__fmul_rn(c00, m[0]), __fmul_rn(c01, m[2]));
  const float n01 = __fadd_rn(__fmul_rn(c00, m[1]), __fmul_rn(c01, m[3]));
  const float n10 = __fadd_rn(__fmul_rn(c10, m[0]), __fmul_rn(c11, m[2]));
  const float n11 = __fadd_rn(__fmul_rn(c10, m[1]), __fmul_rn(c11, m[3]));
  const float tot = fmaxf(__fadd_rn(__fadd_rn(__fadd_rn(n00, n01), n10), n11), 1e-30f);
  c00 = __fdiv_rn(n00, tot);
  c01 = __fdiv_rn(n01, tot);
  c10 = __fdiv_rn(n10, tot);
  c11 = __fdiv_rn(n11, tot);
}

// B7's product in one chain: from the identity, prod_step over every step.
// Writes C00, C01, C10, C11 at out[0], out[nl], out[2 nl], out[3 nl].
__device__ __forceinline__ void prod_chain(const int32_t* p, const float* s_tab, float* out,
                                           int Tp, size_t nl, int nreal) {
  float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_group(p, nl, 0, 1, Tp, nreal, q);
  for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
    load_group(p, nl, t0 + LOOKAHEAD, 1, Tp, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r)
      if (t0 + r < Tp) prod_step(c00, c01, c10, c11, s_tab + 4 * q[r]);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  out[0] = c00;
  out[nl] = c01;
  out[2 * nl] = c10;
  out[3 * nl] = c11;
}

// B8's forward: V <- V . M_t times 1 / total(V) on valid steps, carried past
// len; position 0 stores the identity.  Writes rows 4t + {0,1,2,3}.
__device__ __forceinline__ void mat_fwd_chain(const int32_t* p, const float* s_tab, float* out,
                                              int len, int Tp, size_t nl, int nreal) {
  float v00 = 1.0f, v01 = 0.0f, v10 = 0.0f, v11 = 1.0f;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_group(p, nl, 0, 1, Tp, nreal, q);
  for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
    load_group(p, nl, t0 + LOOKAHEAD, 1, Tp, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < Tp) {
        if (t > 0 && t < len) {
          const float* m = s_tab + 4 * q[r];
          const float inv =
              __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(__fadd_rn(v00, v01), v10), v11));
          const float r00 = __fadd_rn(__fmul_rn(v00, m[0]), __fmul_rn(v01, m[2]));
          const float r01 = __fadd_rn(__fmul_rn(v00, m[1]), __fmul_rn(v01, m[3]));
          const float r10 = __fadd_rn(__fmul_rn(v10, m[0]), __fmul_rn(v11, m[2]));
          const float r11 = __fadd_rn(__fmul_rn(v10, m[1]), __fmul_rn(v11, m[3]));
          v00 = __fmul_rn(r00, inv);
          v01 = __fmul_rn(r01, inv);
          v10 = __fmul_rn(r10, inv);
          v11 = __fmul_rn(r11, inv);
        }
        out[(size_t)(4 * t) * nl] = v00;
        out[(size_t)(4 * t + 1) * nl] = v01;
        out[(size_t)(4 * t + 2) * nl] = v10;
        out[(size_t)(4 * t + 3) * nl] = v11;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

// B8's backward, t = Tp-1 down to 0: W <- M_{t+1} . W times 1 / total(W)
// where t <= T-2 and t+1 < len, else carried (``p`` is the next-step pair
// stream, so row t holds M_{t+1}).
__device__ __forceinline__ void mat_bwd_chain(const int32_t* p, const float* s_tab, float* out,
                                              int len, int Tp, size_t nl, int nreal, int T) {
  float w00 = 1.0f, w01 = 0.0f, w10 = 0.0f, w11 = 1.0f;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_group(p, nl, Tp - 1, -1, Tp, nreal, q);
  for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
    load_group(p, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0) {
        if (t <= T - 2 && t + 1 < len) {
          const float* g = s_tab + 4 * q[r];
          const float binv =
              __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(__fadd_rn(w00, w01), w10), w11));
          const float b00 = __fmul_rn(__fadd_rn(__fmul_rn(g[0], w00), __fmul_rn(g[1], w10)), binv);
          const float b01 = __fmul_rn(__fadd_rn(__fmul_rn(g[0], w01), __fmul_rn(g[1], w11)), binv);
          const float b10 = __fmul_rn(__fadd_rn(__fmul_rn(g[2], w00), __fmul_rn(g[3], w10)), binv);
          const float b11 = __fmul_rn(__fadd_rn(__fmul_rn(g[2], w01), __fmul_rn(g[3], w11)), binv);
          w00 = b00;
          w01 = b01;
          w10 = b10;
          w11 = b11;
        }
        out[(size_t)(4 * t) * nl] = w00;
        out[(size_t)(4 * t + 1) * nl] = w01;
        out[(size_t)(4 * t + 2) * nl] = w10;
        out[(size_t)(4 * t + 3) * nl] = w11;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

__device__ __forceinline__ void load_table(float* s_tab, const float* tab, int nreal) {
  for (int i = threadIdx.x; i < (nreal + 1) * 4; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// B4 and B24: the forward and the self-normalized backward chain of each lane
// (B24: of each member, blockIdx.z; every stacked operand is member-major,
// [M, ...], so member m's slice is one contiguous single-model operand; a
// single-model launch is member 0 of 1).  Each lane runs as G sub-lanes of
// L steps, [g L, min((g + 1) L, Tp)), one thread per (lane, sub-lane); a
// block holds one direction (blockIdx.y: 0 forward, 1 backward) of 32
// lanes, warp g their sub-lane g, so every load and store of a warp is one
// 128-byte row as in the one-thread-a-chain layout.  Three phases, joined
// by __syncthreads:
// 1. each sub-lane's transfer product of its valid steps (sub_prod);
// 2. warp 0 walks the G products of its lanes in order: the forward's
//    entering message of sub-lane g from a0 and the products of sub-lanes
//    0..g-1, the backward's exit message from beta0 and those of g+1..G-1
//    (a sub-lane with no valid step passes the message on as it is, so
//    sub-lane 0's forward enters with a0 and the last valid sub-lane's
//    backward with beta0 exactly);
// 3. the chains of fwd_range / bwd_range over each sub-lane from those
//    messages.  Both chains are degree 0 in the vector they carry, so a
//    sub-lane entered with the exact direction stores, in exact arithmetic,
//    the sequential chain's alphas and betas.  The forward carries its last
//    valid alpha past len: the sub-lane holding step max(len, 1) - 1 leaves
//    it in shared memory and the sub-lanes after it store it.
// With G == 1 phases 1 and 2 do not run and the launch is the one-thread-
// a-chain kernel, bit for bit.

#define SUB_LANES_MAX 32  // sub-lanes a lane at most: 32 warps a block

__device__ __forceinline__ void fwdbwd_sublanes(
    const int32_t* __restrict__ pair, const int32_t* __restrict__ pairn,
    const int32_t* __restrict__ lens, const float* __restrict__ a0,
    const float* __restrict__ beta0, const float* s_tab, float* __restrict__ alphas,
    float* __restrict__ betas, int Tp, int NL, int nreal, int T, int G, int L, float* s_msg,
    float* s_last) {
  const int j = threadIdx.x % FB_THREADS;
  const int g = threadIdx.x / FB_THREADS;
  const bool fwd = blockIdx.y == 0;
  const int n = blockIdx.x * FB_THREADS + j;
  const bool live = n < NL;
  const size_t nl = (size_t)NL;
  const int len = live ? lens[n] : 0;
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  // The direction's valid steps, [lo, hi): the forward's 0 < t < len, the
  // backward's t <= T - 2 and t + 1 < len.
  const int lo = fwd ? 1 : 0;
  const int hi = fwd ? len : min(T - 1, len - 1);
  const int32_t* p = (fwd ? pair : pairn) + n;
  // Slot (k, c) of lane j: entry c of sub-lane k's product, then of its
  // message; [G][4][32], so a warp's accesses hit 32 banks.
#define MSG(k, c) s_msg[((k) * 4 + (c)) * FB_THREADS + j]
  if (G > 1) {
    if (live) {
      float P[4];
      sub_prod(p, s_tab, tb, te, lo, hi, Tp, nl, nreal, P);
      for (int c = 0; c < 4; ++c) MSG(g, c) = P[c];
    }
    __syncthreads();
    if (live && g == 0) {
      float v0 = fwd ? a0[n] : beta0[n], v1 = fwd ? a0[nl + n] : beta0[nl + n];
      for (int i = 0; i < G; ++i) {
        const int k = fwd ? i : G - 1 - i;
        const float P[4] = {MSG(k, 0), MSG(k, 1), MSG(k, 2), MSG(k, 3)};
        MSG(k, 0) = v0;
        MSG(k, 1) = v1;
        const int kb = min(k * L, Tp), ke = min(kb + L, Tp);
        if (max(kb, lo) < min(ke, hi)) {
          if (fwd)
            sub_message<true>(v0, v1, P);
          else
            sub_message<false>(v0, v1, P);
        }
      }
    }
    __syncthreads();
  }
  const int last = max(min(len, Tp), 1) - 1;  // the forward's last valid step
  const int gl = last / L;                     // and its sub-lane
  if (live) {
    if (fwd) {
      if (g <= gl) {
        const float e0 = a0[n], e1 = a0[nl + n];
        float v0 = g == 0 ? e0 : MSG(g, 0), v1 = g == 0 ? e1 : MSG(g, 1);
        fwd_range(p, s_tab, v0, v1, e0, e1, alphas + n, len, tb, te, Tp, nl, nreal);
        if (g == gl) {
          s_last[j] = v0;
          s_last[FB_THREADS + j] = v1;
        }
      }
    } else {
      const float b0 = g == G - 1 ? beta0[n] : MSG(g, 0);
      const float b1 = g == G - 1 ? beta0[nl + n] : MSG(g, 1);
      bwd_range(p, s_tab, b0, b1, betas + n, len, tb, te, Tp, nl, nreal, T);
    }
  }
#undef MSG
  if (G > 1 && fwd) {
    __syncthreads();
    if (live && g > gl) {
      const float v0 = s_last[j], v1 = s_last[FB_THREADS + j];
      for (int t = tb; t < te; ++t) {
        alphas[(size_t)(2 * t) * nl + n] = v0;
        alphas[(size_t)(2 * t + 1) * nl + n] = v1;
      }
    }
  }
}

__global__ void __launch_bounds__(FB_THREADS * SUB_LANES_MAX)
oh_fwdbwd_kernel(const int32_t* __restrict__ pair, const int32_t* __restrict__ pairn,
                 const int32_t* __restrict__ lens, const float* __restrict__ a0,
                 const float* __restrict__ beta0, const float* __restrict__ tab,
                 float* __restrict__ alphas, float* __restrict__ betas,
                 int Tp, int NL, int nreal, int T, int G, int L) {
  __shared__ float s_tab[MAX_TAB];
  __shared__ float s_msg[SUB_LANES_MAX * 4 * FB_THREADS];
  __shared__ float s_last[2 * FB_THREADS];
  load_table(s_tab, tab, nreal);
  fwdbwd_sublanes(pair, pairn, lens, a0, beta0, s_tab, alphas, betas, Tp, NL, nreal, T, G, L,
                  s_msg, s_last);
}

__global__ void __launch_bounds__(FB_THREADS * SUB_LANES_MAX)
oh_fwdbwd_stacked_kernel(const int32_t* __restrict__ pair, const int32_t* __restrict__ pairn,
                         const int32_t* __restrict__ lens, const float* __restrict__ a0,
                         const float* __restrict__ beta0, const float* __restrict__ tab,
                         float* __restrict__ alphas, float* __restrict__ betas,
                         int Tp, int NL, int nreal, int T, int G, int L) {
  __shared__ float s_tab[MAX_TAB];
  __shared__ float s_msg[SUB_LANES_MAX * 4 * FB_THREADS];
  __shared__ float s_last[2 * FB_THREADS];
  const int m = blockIdx.z;
  load_table(s_tab, tab + (size_t)m * (nreal + 1) * 4, nreal);
  const size_t vec = (size_t)m * 2 * NL;         // member m of [M, 2, NL]
  const size_t strm = (size_t)m * Tp * 2 * NL;   // member m of [M, Tp, 2, NL]
  fwdbwd_sublanes(pair, pairn, lens, a0 + vec, beta0 + vec, s_tab, alphas + strm,
                  betas + strm, Tp, NL, nreal, T, G, L, s_msg, s_last);
}

// ---------------------------------------------------------------------------
// The split arm's chains.  B9 (B22 with M > 1): the forward chain of each
// lane of member blockIdx.y.  B10 (B23 with M > 1): the cs-scaled backward
// of each lane of member blockIdx.y, cs_next member-major [M, Tp, NL].  B11:
// B10 for one model, storing the confidence [Tp, NL] in place of the betas.
// A single-model launch is member 0 of 1.

__global__ void __launch_bounds__(FB_THREADS)
oh_fwd_kernel(const int32_t* __restrict__ pair, const int32_t* __restrict__ lens,
              const float* __restrict__ a0, const float* __restrict__ tab,
              float* __restrict__ alphas, int Tp, int NL, int nreal) {
  __shared__ float s_tab[MAX_TAB];
  const int m = blockIdx.y;
  load_table(s_tab, tab + (size_t)m * (nreal + 1) * 4, nreal);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const size_t vec = (size_t)m * 2 * nl;
  fwd_chain(pair + n, s_tab, a0[vec + n], a0[vec + nl + n], alphas + (size_t)m * Tp * 2 * nl + n,
            lens[n], Tp, nl, nreal);
}

template <bool CONF>
__global__ void __launch_bounds__(FB_THREADS)
oh_bwd_kernel(const int32_t* __restrict__ pairn, const int32_t* __restrict__ pair,
              const int32_t* __restrict__ lens, const float* __restrict__ cs_next,
              const float* __restrict__ beta0, const float* __restrict__ alphas,
              const float* __restrict__ mtab, const float* __restrict__ tab,
              float* __restrict__ out, int Tp, int NL, int nreal, int S, int T) {
  __shared__ float s_tab[MAX_TAB];
  __shared__ float s_pmask[2 * (MAX_S * MAX_S + MAX_S)];
  const int m = blockIdx.y;
  const int npm = CONF ? load_pmask(s_pmask, mtab, nreal, S) : 0;
  load_table(s_tab, tab + (size_t)m * (nreal + 1) * 4, nreal);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const size_t vec = (size_t)m * 2 * nl;
  float* dst = CONF ? out + n : out + (size_t)m * Tp * 2 * nl + n;
  split_bwd_chain<CONF>(pairn + n, cs_next + (size_t)m * Tp * nl + n, s_tab, beta0[vec + n],
                        beta0[vec + nl + n], dst, lens[n], Tp, nl, nreal, T,
                        CONF ? pair + n : nullptr, CONF ? alphas + n : nullptr, s_pmask, npm);
}

// ---------------------------------------------------------------------------
// B9 / B22 in sub-lanes, and T2 in B9's, the grid layout: one thread per
// (lane, sub-lane g = blockIdx.y, member m = blockIdx.z), 32 lanes a block,
// three launches.  With last = max(min(len, Tp), 1) - 1 the last valid step
// and gl = last / L its sub-lane:
// PHASE 0: each sub-lane g < gl forms B4's product of its valid steps
//    (sub_prod) into the scratch [M, G, 4, NL]; the products of sub-lanes gl
//    and up are never read, so they are not formed;
// PHASE 1: each thread g <= gl forms the direction entering its sub-lane
//    from a0 and P_0 .. P_{g-1} with B4's in-order scan (sub_message<true>;
//    a sub-lane with no valid step passes the message on), the same
//    operations in the same order as B4's warp 0, then B4's chain
//    (fwd_range), which in sub-lane gl carries the alpha of step last to
//    the sub-lane's end;
// PHASE 2: each sub-lane g > gl stores the alpha of step last, read back
//    from the alphas, at every step (B4 hands it over in shared memory).
// The steps come from the pair stream and the member's table (B9, B22) or,
// with STRM, from T2's streamed matrices ``mats`` [4, Tp, NL] (M = 1): the
// same operations in the same order, so T2's alphas equal B9's at every G.
template <bool STRM>
__device__ __forceinline__ auto lane_steps(const int32_t* pair, const float* s_tab,
                                           const float* mats, int n, size_t nl, int Tp,
                                           int nreal) {
  if constexpr (STRM)
    return StreamSteps{mats + n, (size_t)Tp * nl, nl, Tp};
  else
    return PairSteps{pair + n, s_tab, nl, Tp, nreal};
}

template <int PHASE, bool STRM>
__global__ void __launch_bounds__(FB_THREADS)
oh_fwd_sub_kernel(const int32_t* __restrict__ pair, const float* __restrict__ mats,
                  const int32_t* __restrict__ lens, const float* __restrict__ a0,
                  const float* __restrict__ tab, float* alphas, float* pbuf, int Tp, int NL,
                  int nreal, int G, int L) {
  __shared__ float s_tab[STRM ? 1 : MAX_TAB];
  const int m = blockIdx.z;
  if (!STRM && PHASE < 2) load_table(s_tab, tab + (size_t)m * (nreal + 1) * 4, nreal);
  const int g = blockIdx.y;
  const int n = blockIdx.x * FB_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int len = lens[n];
  const int last = max(min(len, Tp), 1) - 1;
  const int gl = last / L;
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  float* al = alphas + (size_t)m * Tp * 2 * nl + n;
  float* pb = pbuf + (size_t)m * G * 4 * nl + n;  // member m's [G, 4, NL], lane n
  if (PHASE == 0) {
    if (g < gl) {
      float P[4];
      sub_prod(lane_steps<STRM>(pair, s_tab, mats, n, nl, Tp, nreal), tb, te, 1, len, P);
      for (int c = 0; c < 4; ++c) pb[(size_t)(4 * g + c) * nl] = P[c];
    }
  } else if (PHASE == 1) {
    if (g <= gl) {
      const float e0 = a0[(size_t)m * 2 * nl + n], e1 = a0[(size_t)(m * 2 + 1) * nl + n];
      float v0 = e0, v1 = e1;
      for (int h = 0; h < g; ++h) {
        const int hb = min(h * L, Tp), he = min(hb + L, Tp);
        if (max(hb, 1) >= min(he, len)) continue;  // no valid step: the message passes on
        const float* Ph = pb + (size_t)(4 * h) * nl;
        const float P[4] = {Ph[0], Ph[nl], Ph[2 * nl], Ph[3 * nl]};
        sub_message<true>(v0, v1, P);
      }
      fwd_range(lane_steps<STRM>(pair, s_tab, mats, n, nl, Tp, nreal), v0, v1, e0, e1,
                al, len, tb, te, nl);
    }
  } else if (g > gl) {
    const float v0 = al[(size_t)(2 * last) * nl], v1 = al[(size_t)(2 * last + 1) * nl];
    for (int t = tb; t < te; ++t) {
      al[(size_t)(2 * t) * nl] = v0;
      al[(size_t)(2 * t + 1) * nl] = v1;
    }
  }
}

// ---------------------------------------------------------------------------
// B10 / B23 in sub-lanes (fb_onehot.split_bwd_sublanes): B18's design for the
// 2x2 reduced chain.  Each lane runs as G sub-lanes of L steps, [g L,
// min((g + 1) L, Tp)), one thread per (lane, sub-lane g = blockIdx.y,
// member m = blockIdx.z), 32 lanes a block.  The chain is DEGREE 1 in beta,
// so a sub-lane's message carries the true magnitude:
// 1. (PROD) each sub-lane g > 0 with a valid step forms its transfer matrix
//    Q_g (beta_tb = Q_g . beta_te over its valid steps t < hi = min(T - 1,
//    len - 1)) from the identity, by the chain's own step applied to each
//    column (contract, then times 1 / c_{t+1}), t walking down from the
//    sub-lane's end; after every 8th step counted from its padded end (g +
//    1) L - 1, Q_g is scaled by 2^-e, e the binary exponent of its total
//    ((Q00 + Q01) + Q10) + Q11 (scale_exp: a power of two costs no division
//    and rounds nothing), and e is added to an int E_g.  Q_g (row-major)
//    and E_g (as a float: exact below 2^24) go to the scratch [M, G, 5, NL].
//    Sub-lane 0's product and those of sub-lanes without a valid step are
//    never read, so they are not formed;
// 2. (!PROD) each thread forms the beta entering its sub-lane (the one after
//    its last step) from beta0 and Q_{G-1} .. Q_{g+1} in order (v <- Q_h .
//    v, then v times 2^-e of its sum, the exponents summed; a sub-lane with
//    no valid step passes v on unchanged) and starts its chain from (v
//    2^E1) 2^E2, E1 = E / 2: the same operations in the same order in every
//    thread, so the messages are a sequential scan's, and the last valid
//    sub-lane starts from beta0 exactly;
// 3. B10's chain (cs_bwd_range) over the sub-lane from that message.
// A product by a power of two is exact away from float32's subnormals, so in
// exact arithmetic the messages are the sequential chain's betas; the
// stored betas differ from it in the last bits.  Every operation is an
// explicit round-to-nearest intrinsic in fb_onehot._split_bwd_sublanes_plain's
// order.

// Phase 1: Q_g and E_g of the sub-lane [tb, te) into dst (rows nl apart);
// pn and cn: the lane's next-step pair and cs_next columns.
__device__ __forceinline__ void cs_bwd_sub_prod(const int32_t* pn, const float* cn,
                                                const float* s_tab, int tb, int te, int hi,
                                                int L, int Tp, size_t nl, int nreal,
                                                float* dst) {
  float q00 = 1.0f, q01 = 0.0f, q10 = 0.0f, q11 = 1.0f;
  int E = 0;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float c[LOOKAHEAD], cx[LOOKAHEAD];
  load_group(pn, nl, te - 1, -1, Tp, nreal, q);
  load_fgroup(cn, nl, te - 1, -1, Tp, c);
  for (int k0 = 0; k0 < te - tb; k0 += LOOKAHEAD) {
    const int next = te - 1 - (k0 + LOOKAHEAD);
    load_group(pn, nl, next, -1, Tp, nreal, qn);
    load_fgroup(cn, nl, next, -1, Tp, cx);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = te - 1 - (k0 + r);
      if (t >= tb) {
        if (t < hi) {
          const float* m = s_tab + 4 * q[r];
          const float ic = __fdiv_rn(1.0f, c[r]);
          const float n00 = __fmul_rn(__fadd_rn(__fmul_rn(m[0], q00), __fmul_rn(m[1], q10)), ic);
          const float n01 = __fmul_rn(__fadd_rn(__fmul_rn(m[0], q01), __fmul_rn(m[1], q11)), ic);
          const float n10 = __fmul_rn(__fadd_rn(__fmul_rn(m[2], q00), __fmul_rn(m[3], q10)), ic);
          const float n11 = __fmul_rn(__fadd_rn(__fmul_rn(m[2], q01), __fmul_rn(m[3], q11)), ic);
          q00 = n00;
          q01 = n01;
          q10 = n10;
          q11 = n11;
        }
        if (((tb + L - 1 - t) & 7) == 7) {
          const int e = scale_exp(__fadd_rn(__fadd_rn(__fadd_rn(q00, q01), q10), q11));
          const float sc = pow2f(-e);
          q00 = __fmul_rn(q00, sc);
          q01 = __fmul_rn(q01, sc);
          q10 = __fmul_rn(q10, sc);
          q11 = __fmul_rn(q11, sc);
          E += e;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      c[r] = cx[r];
    }
  }
  dst[0] = q00;
  dst[nl] = q01;
  dst[2 * nl] = q10;
  dst[3 * nl] = q11;
  dst[4 * nl] = (float)E;
}

// Phase 2: the beta entering sub-lane g (the beta after its last step) into
// (b0, b1), from beta0 (the lane's column, rows nl apart) and the products
// of sub-lanes G-1 .. g+1 in qb (the lane's column of the member's scratch).
__device__ __forceinline__ void cs_bwd_entry(const float* qb, const float* beta0, int g, int G,
                                             int L, int Tp, int hi, size_t nl, float& b0,
                                             float& b1) {
  float v0 = beta0[0], v1 = beta0[nl];
  int E = 0;
  for (int h = G - 1; h > g; --h) {
    const int hb = min(h * L, Tp), he = min(hb + L, Tp);
    if (hb >= min(he, hi)) continue;  // no valid step: the message passes on
    const float* Q = qb + (size_t)(5 * h) * nl;
    const float r0 = __fadd_rn(__fmul_rn(Q[0], v0), __fmul_rn(Q[nl], v1));
    const float r1 = __fadd_rn(__fmul_rn(Q[2 * nl], v0), __fmul_rn(Q[3 * nl], v1));
    const int e = scale_exp(__fadd_rn(r0, r1));
    const float sc = pow2f(-e);
    v0 = __fmul_rn(r0, sc);
    v1 = __fmul_rn(r1, sc);
    E += (int)Q[4 * nl] + e;
  }
  const int e1 = E / 2, e2 = E - e1;
  const float s1 = pow2f(min(max(e1, -126), 126)), s2 = pow2f(min(max(e2, -126), 126));
  b0 = __fmul_rn(__fmul_rn(v0, s1), s2);
  b1 = __fmul_rn(__fmul_rn(v1, s1), s2);
}

// Phase 3: B10's chain over [tb, te) from (b0, b1), the beta after step te -
// 1: beta_t = (M_{t+1} . beta_{t+1}) * (1 / c_{t+1}) where t < hi, else
// carried; beta_t stored at rows 2t, 2t + 1 of out (the lane's column).
// With CONF (B11) conf[t] at row t instead, split_bwd_chain's (pc, al,
// s_pmask as there; 0 at t >= len).
template <bool CONF>
__device__ __forceinline__ void cs_bwd_range(const int32_t* pn, const float* cn,
                                             const float* s_tab, float b0, float b1, float* out,
                                             int tb, int te, int hi, int Tp, size_t nl,
                                             int nreal, int len, const int32_t* pc,
                                             const float* al, const float* s_pmask, int npm) {
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float c[LOOKAHEAD], cx[LOOKAHEAD];
  int pp[LOOKAHEAD], ppx[LOOKAHEAD];
  float a0[LOOKAHEAD], a1[LOOKAHEAD], a0x[LOOKAHEAD], a1x[LOOKAHEAD];
  load_group(pn, nl, te - 1, -1, Tp, nreal, q);
  load_fgroup(cn, nl, te - 1, -1, Tp, c);
  if (CONF) load_conf_group(pc, al, nl, te - 1, Tp, pp, a0, a1);
  for (int k0 = 0; k0 < te - tb; k0 += LOOKAHEAD) {
    const int next = te - 1 - (k0 + LOOKAHEAD);
    load_group(pn, nl, next, -1, Tp, nreal, qn);
    load_fgroup(cn, nl, next, -1, Tp, cx);
    if (CONF) load_conf_group(pc, al, nl, next, Tp, ppx, a0x, a1x);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = te - 1 - (k0 + r);
      if (t >= tb) {
        const float* m = s_tab + 4 * q[r];
        const float ic = __fdiv_rn(1.0f, c[r]);
        const float x0 = __fmul_rn(__fadd_rn(__fmul_rn(m[0], b0), __fmul_rn(m[1], b1)), ic);
        const float x1 = __fmul_rn(__fadd_rn(__fmul_rn(m[2], b0), __fmul_rn(m[3], b1)), ic);
        if (t < hi) {
          b0 = x0;
          b1 = x1;
        }
        if (CONF) {
          out[(size_t)t * nl] = t < len ? conf_of(pp[r], a0[r], a1[r], b0, b1, s_pmask, npm)
                                        : 0.0f;
        } else {
          out[(size_t)(2 * t) * nl] = b0;
          out[(size_t)(2 * t + 1) * nl] = b1;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      c[r] = cx[r];
      if (CONF) {
        pp[r] = ppx[r];
        a0[r] = a0x[r];
        a1[r] = a1x[r];
      }
    }
  }
}

// PROD: phase 1 (the first launch); else phases 2 and 3 (the second).
// cs_next member-major [M, Tp, NL], beta0 [M, 2, NL], out: the betas [M, Tp,
// 2, NL], or with CONF (B11, M = 1) the confidence [Tp, NL] from pair [Tp,
// NL], alphas [Tp, 2, NL] and mtab [S, 2] (B11's operands).
template <bool PROD, bool CONF>
__global__ void __launch_bounds__(FB_THREADS)
oh_bwd_sub_kernel(const int32_t* __restrict__ pairn, const int32_t* __restrict__ lens,
                  const float* __restrict__ cs_next, const float* __restrict__ beta0,
                  const float* __restrict__ tab, float* qbuf, float* __restrict__ out, int Tp,
                  int NL, int nreal, int T, int G, int L, const int32_t* __restrict__ pair,
                  const float* __restrict__ alphas, const float* __restrict__ mtab, int S) {
  __shared__ float s_tab[MAX_TAB];
  __shared__ float s_pmask[2 * (MAX_S * MAX_S + MAX_S)];
  const int m = blockIdx.z;
  const int npm = CONF ? load_pmask(s_pmask, mtab, nreal, S) : 0;
  load_table(s_tab, tab + (size_t)m * (nreal + 1) * 4, nreal);
  const int g = blockIdx.y;
  const int n = blockIdx.x * FB_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int hi = min(T - 1, lens[n] - 1);
  const int tb = min(g * L, Tp), te = min(tb + L, Tp);
  const float* cn = cs_next + (size_t)m * Tp * nl + n;
  float* qb = qbuf + (size_t)m * G * 5 * nl + n;
  if (PROD) {
    if (g > 0 && tb < min(te, hi))
      cs_bwd_sub_prod(pairn + n, cn, s_tab, tb, te, hi, L, Tp, nl, nreal,
                      qb + (size_t)(5 * g) * nl);
  } else {
    float b0, b1;
    cs_bwd_entry(qb, beta0 + (size_t)m * 2 * nl + n, g, G, L, Tp, hi, nl, b0, b1);
    cs_bwd_range<CONF>(pairn + n, cn, s_tab, b0, b1,
                       CONF ? out + n : out + (size_t)m * Tp * 2 * nl + n, tb, te, hi, Tp, nl,
                       nreal, lens[n], CONF ? pair + n : nullptr, CONF ? alphas + n : nullptr,
                       s_pmask, npm);
  }
}

// ---------------------------------------------------------------------------
// B8: the matrix-carried forward (blockIdx.y == 0) and backward chain of each
// lane, [Tp, 4, NL] each.

__global__ void __launch_bounds__(FB_THREADS)
oh_fwdbwd_mat_kernel(const int32_t* __restrict__ pair, const int32_t* __restrict__ pairn,
                     const int32_t* __restrict__ lens, const float* __restrict__ tab,
                     float* __restrict__ va, float* __restrict__ wb, int Tp, int NL,
                     int nreal, int T) {
  __shared__ float s_tab[MAX_TAB];
  load_table(s_tab, tab, nreal);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  if (blockIdx.y == 0)
    mat_fwd_chain(pair + n, s_tab, va + n, lens[n], Tp, nl, nreal);
  else
    mat_bwd_chain(pairn + n, s_tab, wb + n, lens[n], Tp, nl, nreal, T);
}

// ---------------------------------------------------------------------------
// B7 and B21: the per-lane transfer products (B21: of each member, blockIdx.y;
// a single-model launch is member 0 of 1).  Each lane runs as G sub-lanes of
// L steps (fb_onehot.prod_sublanes), B4's layout: a block holds 32 lanes,
// warp g their sub-lane g, so every pair load of a warp is one 128-byte row.
// 1. each sub-lane's product of its steps from the identity (sub_prod, every
//    step valid: a PAD pair selects the identity row), times 1 / max(total,
//    1e-30) after every 8th step, the TPU kernel's cadence, so a step waits
//    on no division;
// 2. warp 0 composes its lanes' G products in order with prod_step (each
//    composition over its total, so the output sums to 1 as the one-chain
//    product's does) and writes them.
// The product is associative, so the result's direction, all that its
// consumers read, is the one chain's in exact arithmetic.  With G == 1 the
// launch is prod_chain, one thread a lane, bit for bit.

__device__ __forceinline__ void prod_sublanes(const int32_t* __restrict__ pair,
                                              const float* s_tab, float* __restrict__ out,
                                              int Tp, int NL, int nreal, int G, int L,
                                              float* s_msg) {
  const int j = threadIdx.x % FB_THREADS;
  const int g = threadIdx.x / FB_THREADS;
  const int n = blockIdx.x * FB_THREADS + j;
  const bool live = n < NL;
  const size_t nl = (size_t)NL;
  if (G == 1) {
    if (live) prod_chain(pair + n, s_tab, out + n, Tp, nl, nreal);
    return;
  }
  // Slot (k, c) of lane j: entry c of sub-lane k's product ([G][4][32]).
#define MSG(k, c) s_msg[((k) * 4 + (c)) * FB_THREADS + j]
  if (live) {
    const int tb = min(g * L, Tp), te = min(tb + L, Tp);
    float P[4];
    sub_prod(pair + n, s_tab, tb, te, 0, Tp, Tp, nl, nreal, P);
    for (int c = 0; c < 4; ++c) MSG(g, c) = P[c];
  }
  __syncthreads();
  if (live && g == 0) {
    float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
    for (int k = 0; k < G && k * L < Tp; ++k) {
      const float P[4] = {MSG(k, 0), MSG(k, 1), MSG(k, 2), MSG(k, 3)};
      prod_step(c00, c01, c10, c11, P);
    }
    out[n] = c00;
    out[nl + n] = c01;
    out[2 * nl + n] = c10;
    out[3 * nl + n] = c11;
  }
#undef MSG
}

__global__ void __launch_bounds__(FB_THREADS * SUB_LANES_MAX)
oh_prod_kernel(const int32_t* __restrict__ pair, const float* __restrict__ tab,
               float* __restrict__ out, int Tp, int NL, int nreal, int G, int L) {
  __shared__ float s_tab[MAX_TAB];
  extern __shared__ float s_msg[];  // [G][4][FB_THREADS] where G > 1, else none
  const int m = blockIdx.y;
  load_table(s_tab, tab + (size_t)m * (nreal + 1) * 4, nreal);
  prod_sublanes(pair, s_tab, out + (size_t)m * 4 * NL, Tp, NL, nreal, G, L, s_msg);
}

// ---------------------------------------------------------------------------
// B5 and B25: z-normalized counts; with CS set, B12: the split arm's
// cs-scaled counts.  Per-lane accumulator rows (R = 4 S^2 + 2S + 1): [0, 4
// S^2) pair bins ((s_prev * S + s_cur) * 4 + a * 2 + c), then the 2S
// emission rows (2 * s + a), then the loglik.  B25 runs B5's body for
// member blockIdx.z on its own slices; B12 runs it for member 0 of 1.
//
// A block is STATS_LANES (32) lanes x SPB consecutive segments of Tt steps
// (fb_onehot.stats_segment_t, a function of the shape; SPB =
// fb_onehot.stats_segments_per_block, 4 where a block's accumulators fit,
// else 1), warp s taking segment s, so every load of a warp is one 128-byte
// row.  Each thread keeps its R accumulators in its own column of shared
// memory and reads its streams STATS_AHEAD steps ahead of use (two groups
// of registers, one being read while the next loads).  At the end the block sums its SPB segments' columns in
// order into one partial row set, so the part buffer holds ceil(nseg / SPB)
// partials a lane and the reduce kernel reads SPB times fewer bytes.

#define STATS_LANES 32
#define STATS_AHEAD 8

// A pair's decode: its emitted symbol (bits 0-4), its pair bin s_prev * S +
// s_cur (bits 5-12) and its table row (bits 13-21; PAD pairs, pr >= S^2,
// take the identity row S^2 and carry their symbol: previous and current
// are both it).
__device__ __forceinline__ int stats_decode(int pr, int S) {
  const int nreal = S * S;
  const int esym = pr < nreal ? pr % S : pr - nreal;
  const int bin = pr < nreal ? pr : esym * (S + 1);
  return esym | (bin << 5) | (min(pr, nreal) << 13);
}

// One step of B5 at a t > 0 (FIRST = false), or at the lane's t == 0
// (FIRST = true: the previous alpha is the entering message, reduced for z
// and full K for the counts, masked by pair0).  Its three reciprocals are
// __frcp_rn, the IEEE reciprocal: the bits of __fdiv_rn(1, x) in a shorter
// instruction sequence.  With CS (B12) the pair bin's normalizer is 1 / c_t
// in place of 1 / z: xi[a, c] = a_hat[a] * ((B_red[s_t, c] * beta_t[c]) *
// (1 / c_t)), the XLA twin's operand order, and no z or table row is
// formed; at t == 0 only the gamma rows and log c are added (every chunk
// lane is its own record: its t == 0 pair is excluded).
template <bool FIRST, bool CS>
__device__ __forceinline__ void stats_step(float a0, float a1, float be0, float be1, int d,
                                           float& ah0, float& ah1, float& ll, float* my, int bd,
                                           const float* s_tab, const float* s_bred,
                                           const int* s_igt, const float* enters_full,
                                           const float* enters_red, float pair0, size_t nl,
                                           int S, int K) {
  const int esym = d & 31, bin = (d >> 5) & 255, row = d >> 13;
  const int EMIT = 4 * S * S;
  // The step's six accumulators, read before any arithmetic so that their
  // shared-memory latencies overlap the reciprocals' (the emission and
  // pair-bin regions never overlap).
  float* e = my + (EMIT + 2 * esym) * bd;
  float* b = my + (bin * 4) * bd;
  const float e0v = e[0], e1v = e[bd];
  float b0v = 0.0f, b1v = 0.0f, b2v = 0.0f, b3v = 0.0f;
  if (!FIRST) {
    b0v = b[0];
    b1v = b[bd];
    b2v = b[2 * bd];
    b3v = b[3 * bd];
  }
  const float cs = __fadd_rn(a0, a1);
  const float inv_cs = __frcp_rn(fmaxf(cs, 1e-30f));
  const float g0 = __fmul_rn(a0, be0), g1 = __fmul_rn(a1, be1);
  const float inv_g = __frcp_rn(fmaxf(__fadd_rn(g0, g1), 1e-30f));
  e[0] = __fadd_rn(e0v, __fmul_rn(g0, inv_g));
  e[bd] = __fadd_rn(e1v, __fmul_rn(g1, inv_g));
  ll = __fadd_rn(ll, logf(fmaxf(cs, 1e-30f)));
  const float* m = s_tab + 4 * row;
  // z = sum_ac aprev[a] T[a, c] beta[c]; xi[a, c] = aprev[a] w[c] / z
  // with w[c] = B_red[esym, c] beta[c] (the table supplies A * B).
  const float r0 = CS ? 0.0f : __fadd_rn(__fmul_rn(m[0], be0), __fmul_rn(m[1], be1));
  const float r1 = CS ? 0.0f : __fadd_rn(__fmul_rn(m[2], be0), __fmul_rn(m[3], be1));
  if (!FIRST) {
    const float inv_z =
        CS ? inv_cs : __frcp_rn(fmaxf(__fadd_rn(__fmul_rn(ah0, r0), __fmul_rn(ah1, r1)), 1e-30f));
    const float wz0 = __fmul_rn(__fmul_rn(s_bred[2 * esym], be0), inv_z);
    const float wz1 = __fmul_rn(__fmul_rn(s_bred[2 * esym + 1], be1), inv_z);
    b[0] = __fadd_rn(b0v, __fmul_rn(ah0, wz0));
    b[bd] = __fadd_rn(b1v, __fmul_rn(ah0, wz1));
    b[2 * bd] = __fadd_rn(b2v, __fmul_rn(ah1, wz0));
    b[3 * bd] = __fadd_rn(b3v, __fmul_rn(ah1, wz1));
  } else if (!CS && pair0 != 0.0f) {
    const float e0 = enters_red[0], e1 = enters_red[nl];
    const float z = __fadd_rn(__fmul_rn(e0, r0), __fmul_rn(e1, r1));
    const float inv_z = __fmul_rn(pair0, __frcp_rn(fmaxf(z, 1e-30f)));
    const float wz0 = __fmul_rn(__fmul_rn(s_bred[2 * esym], be0), inv_z);
    const float wz1 = __fmul_rn(__fmul_rn(s_bred[2 * esym + 1], be1), inv_z);
    for (int i = 0; i < K; ++i) {
      const float ef = enters_full[(size_t)i * nl];
      const int sa = s_igt[i];
      float* bi = my + (((sa >> 1) * S + esym) * 4 + (sa & 1) * 2) * bd;
      bi[0] = __fadd_rn(bi[0], __fmul_rn(ef, wz0));
      bi[bd] = __fadd_rn(bi[bd], __fmul_rn(ef, wz1));
    }
  }
  ah0 = __fmul_rn(a0, inv_cs);
  ah1 = __fmul_rn(a1, inv_cs);
}

// The streams of STATS_AHEAD steps from t (decoded pairs; zeros at and past t1).
struct StatsGroup {
  float a0[STATS_AHEAD], a1[STATS_AHEAD], b0[STATS_AHEAD], b1[STATS_AHEAD];
  int d[STATS_AHEAD];
};

__device__ __forceinline__ void stats_load(StatsGroup& q, const float* al, const float* be,
                                           const int32_t* p, const int* s_dec, int t, int t1,
                                           size_t nl, int npair) {
#pragma unroll
  for (int r = 0; r < STATS_AHEAD; ++r) {
    const bool in = t + r < t1;
    const size_t x = (size_t)(2 * (t + r)) * nl;
    q.a0[r] = in ? __ldg(al + x) : 0.0f;
    q.a1[r] = in ? __ldg(al + x + nl) : 0.0f;
    q.b0[r] = in ? __ldg(be + x) : 0.0f;
    q.b1[r] = in ? __ldg(be + x + nl) : 0.0f;
    q.d[r] = in ? __ldg(p + (size_t)(t + r) * nl) : 0;
  }
#pragma unroll
  for (int r = 0; r < STATS_AHEAD; ++r) q.d[r] = s_dec[min(max(q.d[r], 0), npair - 1)];
}

// One (lane, segment) of B5 (B12 with CS): accumulate into the thread's
// shared column ``my`` (stride bd) over steps [t0, t1) of the lane whose
// streams ``al``, ``be``, ``p`` point at (column n of the member's [Tp, 2,
// NL] / [Tp, NL]).
template <bool CS>
__device__ __forceinline__ void stats_segment(
    const float* al, const float* be, const int32_t* p, const float* s_tab,
    const float* s_bred, const int* s_igt, const int* s_dec, const float* enters_full,
    const float* enters_red, float pair0, float* my, int bd, int t0, int t1, size_t nl, int S,
    int K) {
  const int LL = 4 * S * S + 2 * S;
  // Normalized alpha of the step before the segment.
  float ah0 = 0.0f, ah1 = 0.0f;
  if (t0 > 0) {
    const float p0 = al[(size_t)(2 * t0 - 2) * nl];
    const float p1 = al[(size_t)(2 * t0 - 1) * nl];
    const float ic = __fdiv_rn(1.0f, fmaxf(__fadd_rn(p0, p1), 1e-30f));
    ah0 = __fmul_rn(p0, ic);
    ah1 = __fmul_rn(p1, ic);
  }
  const int npair = S * S + S;
  float ll = 0.0f;
  int t = t0;
  if (t0 == 0) {
    const int d = s_dec[min(max(p[0], 0), npair - 1)];
    stats_step<true, CS>(al[0], al[nl], be[0], be[nl], d, ah0, ah1, ll, my, bd, s_tab, s_bred,
                         s_igt, enters_full, enters_red, pair0, nl, S, K);
    t = 1;
  }
  StatsGroup q, qn;
  stats_load(q, al, be, p, s_dec, t, t1, nl, npair);
  for (; t < t1; t += STATS_AHEAD) {
    stats_load(qn, al, be, p, s_dec, t + STATS_AHEAD, t1, nl, npair);
#pragma unroll
    for (int r = 0; r < STATS_AHEAD; ++r) {
      if (t + r < t1)
        stats_step<false, CS>(q.a0[r], q.a1[r], q.b0[r], q.b1[r], q.d[r], ah0, ah1, ll, my,
                              bd, s_tab, s_bred, s_igt, enters_full, enters_red, pair0, nl, S,
                              K);
    }
    q = qn;
  }
  my[LL * bd] = ll;
}

// Grid (lane blocks, segment groups, members); a single-model launch is
// member 0 of 1.  Member m's operands: alphas / betas at m * Tp * 2 * NL, tab
// at m * (S^2 + 1) * 4, bred and gt at m * 2S, enters_full at m * K * NL,
// enters_red at m * 2 * NL, part at m * gridDim.y * R * NL.  With CS (B12)
// tab, enters_full, enters_red and pair0m are not read (null).
template <bool CS>
__global__ void oh_seq_stats_part_kernel(
    const float* __restrict__ alphas, const float* __restrict__ betas,
    const int32_t* __restrict__ pair, const int32_t* __restrict__ lens,
    const float* __restrict__ tab, const float* __restrict__ bred,
    const int32_t* __restrict__ gt, const float* __restrict__ enters_full,
    const float* __restrict__ enters_red, const float* __restrict__ pair0m,
    float* __restrict__ part, int Tp, int NL, int S, int K, int Tt) {
  extern __shared__ float acc[];  // [R][blockDim.x]
  __shared__ float s_tab[MAX_TAB];
  __shared__ float s_bred[2 * MAX_S];
  __shared__ int s_igt[2 * MAX_S];  // state id -> s * 2 + a
  __shared__ int s_dec[MAX_S * MAX_S + MAX_S];
  const int m = blockIdx.z;
  const int nreal = S * S;
  const int R = 4 * nreal + 2 * S + 1;
  const int bd = blockDim.x;
  const int SPB = bd / STATS_LANES;
  const size_t nl = (size_t)NL;
  if (!CS) {
    const float* tab_m = tab + (size_t)m * (nreal + 1) * 4;
    for (int i = threadIdx.x; i < (nreal + 1) * 4; i += bd) s_tab[i] = tab_m[i];
  }
  for (int i = threadIdx.x; i < nreal + S; i += bd) s_dec[i] = stats_decode(i, S);
  for (int i = threadIdx.x; i < 2 * S; i += bd) {
    s_bred[i] = bred[(size_t)m * 2 * S + i];
    if (!CS) s_igt[gt[(size_t)m * 2 * S + i]] = i;
  }
  float* my = acc + threadIdx.x;
  for (int r = 0; r < R; ++r) my[r * bd] = 0.0f;
  __syncthreads();

  const int j = threadIdx.x % STATS_LANES;
  const int n = blockIdx.x * STATS_LANES + j;
  if (n < NL) {
    const int len = min(lens[n], Tp);
    const int t0 = (blockIdx.y * SPB + threadIdx.x / STATS_LANES) * Tt;
    const int t1 = min(t0 + Tt, len);
    const size_t strm = (size_t)m * Tp * 2 * nl;
    if (t0 < t1)
      stats_segment<CS>(alphas + strm + n, betas + strm + n, pair + n, s_tab, s_bred, s_igt,
                        s_dec, CS ? nullptr : enters_full + (size_t)m * K * nl + n,
                        CS ? nullptr : enters_red + (size_t)m * 2 * nl + n,
                        CS ? 0.0f : pair0m[n], my, bd, t0, t1, nl, S, K);
  }
  __syncthreads();
  // The block's segments summed in order, warp w taking rows w, w + SPB, ...
  if (n < NL) {
    float* out = part + ((size_t)m * gridDim.y + blockIdx.y) * R * nl + n;
    for (int r = threadIdx.x / STATS_LANES; r < R; r += SPB) {
      const float* row = acc + r * bd + j;
      float sum = row[0];
      for (int w = 1; w < SPB; ++w) sum = __fadd_rn(sum, row[w * STATS_LANES]);
      out[(size_t)r * nl] = sum;
    }
  }
}

// Grid (lane blocks, rows R, members): each lane's segments summed in order.
__global__ void __launch_bounds__(REDUCE_THREADS)
oh_seq_stats_reduce_kernel(const float* __restrict__ part, const int32_t* __restrict__ gt,
                           float* __restrict__ macc, float* __restrict__ emit,
                           float* __restrict__ ll, int nseg, int NL, int S, int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int r = blockIdx.y;
  const int m = blockIdx.z;
  const int nbins = 4 * S * S;
  const int R = nbins + 2 * S + 1;
  const float* pm = part + (size_t)m * nseg * R * nl;
  const int32_t* g = gt + (size_t)m * 2 * S;
  float s = 0.0f;
  for (int i = 0; i < nseg; ++i) s = __fadd_rn(s, pm[((size_t)i * R + r) * nl + n]);
  if (r < nbins) {
    const int p = r >> 2, a = (r >> 1) & 1, c = r & 1;
    const int row = g[2 * (p / S) + a] * K + g[2 * (p % S) + c];
    macc[((size_t)m * K * K + row) * nl + n] = s;
  } else if (r < nbins + 2 * S) {
    emit[((size_t)m * 2 * S + r - nbins) * nl + n] = s;
  } else {
    ll[(size_t)m * nl + n] = s;
  }
}

// B5 / B25 (B12 with cs): the part kernel over (lane blocks, ceil(nseg /
// SPB), M), part [M, ceil(nseg / SPB), R, NL], then the reduce.
static int launch_seq_stats(bool cs, const void* alphas, const void* betas, const void* pair,
                            const void* lens, const void* tab, const void* bred, const void* gt,
                            const void* enters_full, const void* enters_red, const void* pair0m,
                            void* part, void* macc, void* emit, void* ll, int Tp, int NL, int S,
                            int K, int Tt, int SPB, int M, cudaStream_t st) {
  if (S < 1 || S > MAX_S || K != 2 * S || Tp <= 0 || NL <= 0 || Tt <= 0 || M < 1 ||
      M > 65535 || (SPB != 1 && SPB != 4))
    return (int)cudaErrorInvalidValue;
  const int R = 4 * S * S + 2 * S + 1;
  const int nblk = ((Tp + Tt - 1) / Tt + SPB - 1) / SPB;
  const int threads = STATS_LANES * SPB;
  const size_t smem = (size_t)R * threads * sizeof(float);
  if (nblk > 65535 || smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = cs ? oh_seq_stats_part_kernel<true> : oh_seq_stats_part_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((NL + STATS_LANES - 1) / STATS_LANES), (unsigned)nblk, (unsigned)M);
  kernel<<<grid, threads, smem, st>>>(
      (const float*)alphas, (const float*)betas, (const int32_t*)pair, (const int32_t*)lens,
      (const float*)tab, (const float*)bred, (const int32_t*)gt, (const float*)enters_full,
      (const float*)enters_red, (const float*)pair0m, (float*)part, Tp, NL, S, K, Tt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((unsigned)((NL + REDUCE_THREADS - 1) / REDUCE_THREADS), (unsigned)R,
                   (unsigned)M);
  oh_seq_stats_reduce_kernel<<<rgrid, REDUCE_THREADS, 0, st>>>(
      (const float*)part, (const int32_t*)gt, (float*)macc, (float*)emit, (float*)ll, nblk, NL,
      S, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T2-T4: the pair-composition variants of the forward chain (the
// benchmark-only kernels of tools/bench_compose.py; B9 is T1).  All three run
// in B9's sub-lanes (G = fb_onehot.sublanes(Tp)): T2 through B9's own
// oh_fwd_sub_kernel, T3 through oh_fwd_comp_sub_kernel, T4 through
// oh_fwd_compsel_sub_kernel (T3's phases with its rows looked up in tables);
// at G = 1 one thread a lane, 32 to a block; every operand off the chain read
// a group of steps ahead; round-to-nearest intrinsics in the plain versions'
// order.

#define COMP_MAX_S 8  // T4's largest alphabet (its tables in shared memory)

// One double step (t = 2h) of T3 and T4 over c = T2 (00, 01, 10, 11), R (0,
// 1), T_even (00, 01, 10, 11): the intermediate i (alpha_t, off the chain)
// and the carried v <- alpha_{t+1}.
__device__ __forceinline__ void comp_step(float& v0, float& v1, float& i0, float& i1,
                                          const float* c, int t, int len, float e0, float e1) {
  const float inv = __fdiv_rn(1.0f, __fadd_rn(v0, v1));
  const float w0 = __fadd_rn(__fmul_rn(v0, c[6]), __fmul_rn(v1, c[8]));
  const float w1 = __fadd_rn(__fmul_rn(v0, c[7]), __fmul_rn(v1, c[9]));
  if (t == 0) {
    i0 = e0;
    i1 = e1;
  } else if (t < len) {
    i0 = __fmul_rn(w0, inv);
    i1 = __fmul_rn(w1, inv);
  } else {
    i0 = v0;
    i1 = v1;
  }
  const float den = __fadd_rn(__fmul_rn(v0, c[4]), __fmul_rn(v1, c[5]));
  const float dinv = __fdiv_rn(1.0f, den);
  const float u0 = __fadd_rn(__fmul_rn(v0, c[0]), __fmul_rn(v1, c[2]));
  const float u1 = __fadd_rn(__fmul_rn(v0, c[1]), __fmul_rn(v1, c[3]));
  if (t + 1 < len) {
    v0 = __fmul_rn(u0, dinv);
    v1 = __fmul_rn(u1, dinv);
  } else {
    v0 = i0;
    v1 = i1;
  }
}

// The row sources of T3's and T4's double-step chain (comp_range).  A source
// reads the rows of AHEAD consecutive double steps of a lane (``load``, a
// group ahead of the chain, no row at or past ``rows``) and hands out double
// step r's ten values, T2 (00, 01, 10, 11), R (0, 1) and T_even (00, 01, 10,
// 11), from the group it read (``row``).  CompStreamRows (T3): the lane's
// column of the ten streams comp [10, H, NL], read STRM_AHEAD double steps
// ahead.
struct CompStreamRows {
  static constexpr int AHEAD = STRM_AHEAD;
  struct Group {
    float f[AHEAD][10];
  };
  const float* c;
  size_t plane, nl;
  __device__ __forceinline__ void load(int first, int rows, Group& g) const {
    load_rows<10>(c, plane, nl, first, rows, g.f);
  }
  __device__ __forceinline__ void row(const Group& g, int r, float (&x)[10]) const {
#pragma unroll
    for (int k = 0; k < 10; ++k) x[k] = g.f[r][k];
  }
};

// T4's index streams are read COMPSEL_AHEAD double steps ahead of the chain
// (a multiple of 8: sub_prod counts its scaling cadence within a group).
#define COMPSEL_AHEAD 16

// q[r] = the index at double step first + r of a lane's stream ``p`` (rows
// ``nl`` apart), clamped into a table of last + 1 rows as T4's plain version
// clamps it; rows at or past ``rows`` take the last row (never read).
template <int N>
__device__ __forceinline__ void load_idx(const int32_t* p, size_t nl, int first, int rows,
                                         int last, int (&q)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int t = first + r;
    const int v = t < rows ? __ldg(p + (size_t)t * nl) : last;
    q[r] = max(min(v, last), 0);
  }
}

// T4's tables in the block's dynamic shared memory, a row one vector load:
// t2tab's n_trip rows (T2, 16 B), ttab's n_pe (T_even, 16 B), then rtab's
// n_pe (R, 8 B); comp_tables_bytes(S) of them.  load_comp_tables fills them
// from device memory and syncs the block.
struct CompTables {
  const float4* t2;
  const float4* te;
  const float2* r;
  int last_trip, last_pe;
};

static inline size_t comp_tables_bytes(int S) {
  const int n_trip = S * S * (S + 2), n_pe = S * S + 1;
  return (size_t)(n_trip + n_pe) * 16 + (size_t)n_pe * 8;
}

__device__ __forceinline__ CompTables load_comp_tables(float4* s, const float* t2tab,
                                                       const float* rtab, const float* ttab,
                                                       int S) {
  const int n_trip = S * S * (S + 2), n_pe = S * S + 1;
  float* f = reinterpret_cast<float*>(s);
  for (int i = threadIdx.x; i < 4 * n_trip; i += blockDim.x) f[i] = t2tab[i];
  for (int i = threadIdx.x; i < 4 * n_pe; i += blockDim.x) f[4 * n_trip + i] = ttab[i];
  for (int i = threadIdx.x; i < 2 * n_pe; i += blockDim.x) f[4 * (n_trip + n_pe) + i] = rtab[i];
  __syncthreads();
  return CompTables{s, s + n_trip, reinterpret_cast<const float2*>(s + n_trip + n_pe),
                    n_trip - 1, n_pe - 1};
}

// CompTabRows (T4): the lane's two index streams idx [2, H, NL] (t2tab's
// row, then rtab's and ttab's), read COMPSEL_AHEAD double steps ahead; a
// double step's rows are looked up in the shared tables when it runs.
struct CompTabRows {
  static constexpr int AHEAD = COMPSEL_AHEAD;
  struct Group {
    int a[AHEAD], b[AHEAD];
  };
  const int32_t* idx;
  size_t plane, nl;
  CompTables tab;
  __device__ __forceinline__ void load(int first, int rows, Group& g) const {
    load_idx(idx, nl, first, rows, tab.last_trip, g.a);
    load_idx(idx + plane, nl, first, rows, tab.last_pe, g.b);
  }
  __device__ __forceinline__ void row(const Group& g, int r, float (&x)[10]) const {
    const float4 t2 = tab.t2[g.a[r]], te = tab.te[g.b[r]];
    const float2 rr = tab.r[g.b[r]];
    x[0] = t2.x;
    x[1] = t2.y;
    x[2] = t2.z;
    x[3] = t2.w;
    x[4] = rr.x;
    x[5] = rr.y;
    x[6] = te.x;
    x[7] = te.y;
    x[8] = te.z;
    x[9] = te.w;
  }
};

// T4's step source for sub_prod (onehot_steps.cuh's PairSteps has the
// interface): the lane's t2tab index stream (idx row 0) and t2tab in shared
// memory, every step real.
struct CompTabSteps {
  static constexpr int AHEAD = COMPSEL_AHEAD;
  struct Group {
    int a[AHEAD];
  };
  const int32_t* idx;
  size_t nl;
  int rows;
  CompTables tab;
  __device__ __forceinline__ void load(int first, Group& g) const {
    load_idx(idx, nl, first, rows, tab.last_trip, g.a);
  }
  __device__ __forceinline__ void mat(const Group& g, int r, float (&m)[4]) const {
    const float4 t = tab.t2[g.a[r]];
    m[0] = t.x;
    m[1] = t.y;
    m[2] = t.z;
    m[3] = t.w;
  }
  __device__ __forceinline__ bool real(const Group&, int) const { return true; }
};

// T3's and T4's double-step chain over double steps [hb, he) of a lane, from
// (v0, v1), the vector entering double step hb (at hb == 0 the entering
// vector e itself); comp_step at each, alpha_2h and alpha_2h+1 stored at the
// lane's column ``out``.  ``src`` reads the rows (CompStreamRows,
// CompTabRows), no further than he.
template <class Rows>
__device__ __forceinline__ void comp_range(const Rows& src, float& v0, float& v1, float e0,
                                           float e1, float* out, int len, int hb, int he,
                                           size_t nl) {
  float i0, i1;
  typename Rows::Group q, qn;
  src.load(hb, he, q);
  for (int h0 = hb; h0 < he; h0 += Rows::AHEAD) {
    src.load(h0 + Rows::AHEAD, he, qn);
#pragma unroll
    for (int r = 0; r < Rows::AHEAD; ++r) {
      const int t = 2 * (h0 + r);
      if (h0 + r < he) {
        float c[10];
        src.row(q, r, c);
        comp_step(v0, v1, i0, i1, c, t, len, e0, e1);
        out[(size_t)(2 * t) * nl] = i0;
        out[(size_t)(2 * t + 1) * nl] = i1;
        out[(size_t)(2 * t + 2) * nl] = v0;
        out[(size_t)(2 * t + 3) * nl] = v1;
      }
    }
    q = qn;
  }
}

// T2 at G = 1: mats [4, Tp, NL], the four entries of each step's matrix, in
// one chain (B9's oh_fwd_kernel with the streamed step source).
__global__ void __launch_bounds__(FB_THREADS)
oh_fwd_strm_kernel(const float* __restrict__ mats, const int32_t* __restrict__ lens,
                   const float* __restrict__ a0, float* __restrict__ alphas, int Tp, int NL) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const float e0 = a0[n], e1 = a0[nl + n];
  float v0 = e0, v1 = e1;
  fwd_range(StreamSteps{mats + n, (size_t)Tp * nl, nl, Tp}, v0, v1, e0, e1, alphas + n, lens[n],
            0, Tp, nl);
}

// T3 at G = 1: comp [10, H, NL], the composed streams of each double step,
// in one chain.
__global__ void __launch_bounds__(FB_THREADS)
oh_fwd_comp_kernel(const float* __restrict__ comp, const int32_t* __restrict__ lens,
                   const float* __restrict__ a0, float* __restrict__ alphas, int H, int NL) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const float e0 = a0[n], e1 = a0[nl + n];
  float v0 = e0, v1 = e1;
  comp_range(CompStreamRows{comp + n, (size_t)H * nl, nl}, v0, v1, e0, e1, alphas + n, lens[n],
             0, H, nl);
}

// T3 and T4 in B9's sub-lanes: one thread per (lane n, sub-lane g =
// blockIdx.y), 32 lanes a block, three launches; sub-lane g covers double
// steps [g Lh, min((g + 1) Lh, H)), so every boundary falls between double
// steps.  ``steps`` reads the lane's composed matrices T2_h for sub_prod
// (T3: rows 0-3 of comp through StreamSteps; T4: t2tab's rows through
// CompTabSteps), ``rows`` a double step's ten values for comp_range.  With
// last = max(min(len, Tp), 1) - 1 the last valid step and gl = (last / 2) /
// Lh its sub-lane:
// PHASE 0: each sub-lane g < gl forms the product of its T2_h from the
//    identity, scaled after every 8th double step (sub_prod), into pbuf [G,
//    4, NL].  Every double step below gl is valid in both halves; double
//    step 0's even half is the identity, so T2_0 = T_1 and step 0 applies
//    nothing, as in B9;
// PHASE 1: each thread g <= gl forms the direction entering its sub-lane
//    from a0 and P_0 .. P_{g-1} (sub_message<true>, in order; each has a
//    valid double step), then comp_range over its double steps: the chain
//    is degree 0 in v (i = (v . T_even) / (v0 + v1), n = (v . T2) / (v .
//    R)), so a direction is all a message needs; in sub-lane gl comp_step's
//    own masks carry the alpha of step last to the sub-lane's end;
// PHASE 2: each sub-lane g > gl stores the alpha of step last at every step.
template <int PHASE, class Steps, class Rows>
__device__ __forceinline__ void comp_sub_phase(const Steps& steps, const Rows& rows,
                                               const int32_t* lens, const float* a0,
                                               float* alphas, float* pbuf, int H, int n, int g,
                                               int Lh, size_t nl) {
  const int Tp = 2 * H;
  const int len = lens[n];
  const int last = max(min(len, Tp), 1) - 1;
  const int gl = (last / 2) / Lh;
  const int hb = min(g * Lh, H), he = min(hb + Lh, H);
  float* al = alphas + n;
  float* pb = pbuf + n;  // [G, 4, NL], lane n
  if (PHASE == 0) {
    if (g < gl) {
      float P[4];
      sub_prod(steps, hb, he, 0, H, P);
      for (int c = 0; c < 4; ++c) pb[(size_t)(4 * g + c) * nl] = P[c];
    }
  } else if (PHASE == 1) {
    if (g <= gl) {
      const float e0 = a0[n], e1 = a0[nl + n];
      float v0 = e0, v1 = e1;
      for (int h = 0; h < g; ++h) {
        const float* Ph = pb + (size_t)(4 * h) * nl;
        const float P[4] = {Ph[0], Ph[nl], Ph[2 * nl], Ph[3 * nl]};
        sub_message<true>(v0, v1, P);
      }
      comp_range(rows, v0, v1, e0, e1, al, len, hb, he, nl);
    }
  } else if (g > gl) {
    const float v0 = al[(size_t)(2 * last) * nl], v1 = al[(size_t)(2 * last + 1) * nl];
    for (int t = 2 * hb; t < 2 * he; ++t) {
      al[(size_t)(2 * t) * nl] = v0;
      al[(size_t)(2 * t + 1) * nl] = v1;
    }
  }
}

// T3 in sub-lanes over comp [10, H, NL].
template <int PHASE>
__global__ void __launch_bounds__(FB_THREADS)
oh_fwd_comp_sub_kernel(const float* __restrict__ comp, const int32_t* __restrict__ lens,
                       const float* __restrict__ a0, float* alphas, float* pbuf, int H, int NL,
                       int G, int Lh) {
  const int n = blockIdx.x * FB_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL, plane = (size_t)H * nl;
  comp_sub_phase<PHASE>(StreamSteps{comp + n, plane, nl, H}, CompStreamRows{comp + n, plane, nl},
                        lens, a0, alphas, pbuf, H, n, blockIdx.y, Lh, nl);
}

// T4 in sub-lanes over idx [2, H, NL] and the tables of S symbols (phases 0
// and 1 load them into shared memory; phase 2 reads none).  At G = 1 phase 1
// alone is T4's one chain: sub-lane 0 covers [0, H) from a0, no message.
template <int PHASE>
__global__ void __launch_bounds__(FB_THREADS)
oh_fwd_compsel_sub_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ lens,
                          const float* __restrict__ a0, const float* __restrict__ t2tab,
                          const float* __restrict__ rtab, const float* __restrict__ ttab,
                          float* alphas, float* pbuf, int H, int NL, int S, int G, int Lh) {
  extern __shared__ float4 s_comp[];
  CompTables tab{};
  if (PHASE < 2) tab = load_comp_tables(s_comp, t2tab, rtab, ttab, S);
  const int n = blockIdx.x * FB_THREADS + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL, plane = (size_t)H * nl;
  comp_sub_phase<PHASE>(CompTabSteps{idx + n, nl, H, tab}, CompTabRows{idx + n, plane, nl, tab},
                        lens, a0, alphas, pbuf, H, n, blockIdx.y, Lh, nl);
}

// The C interface: every pointer and the stream arrive as void*, sizes as
// int.  Each function launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.
extern "C" {

static inline bool bad_stream(int Tp, int NL, int nreal) {
  return nreal < 1 || nreal > MAX_S * MAX_S || Tp <= 0 || NL <= 0;
}

// B9 / B22: member m on the last grid axis.  G == 1: one thread a chain
// (oh_fwd_kernel); G > 1: the three launches of oh_fwd_sub_kernel (pbuf
// [M, G, 4, NL]).
static int launch_fwd(const void* pair, const void* lens, const void* a0, const void* tab,
                      void* alphas, void* pbuf, int Tp, int NL, int nreal, int G, int M,
                      cudaStream_t st) {
  if (bad_stream(Tp, NL, nreal) || M < 1 || M > 65535 || G < 1 || G > SUB_LANES_MAX || G > Tp)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((NL + FB_THREADS - 1) / FB_THREADS);
  if (G == 1) {
    oh_fwd_kernel<<<dim3(blocks, (unsigned)M), FB_THREADS, 0, st>>>(
        (const int32_t*)pair, (const int32_t*)lens, (const float*)a0, (const float*)tab,
        (float*)alphas, Tp, NL, nreal);
    return (int)cudaGetLastError();
  }
  const int L = (Tp + G - 1) / G;
  const dim3 grid(blocks, (unsigned)G, (unsigned)M);
#define FWD_SUB_ARGS                                                                       \
  (const int32_t*)pair, nullptr, (const int32_t*)lens, (const float*)a0, (const float*)tab, \
      (float*)alphas, (float*)pbuf, Tp, NL, nreal, G, L
  oh_fwd_sub_kernel<0, false><<<grid, FB_THREADS, 0, st>>>(FWD_SUB_ARGS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_sub_kernel<1, false><<<grid, FB_THREADS, 0, st>>>(FWD_SUB_ARGS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_sub_kernel<2, false><<<grid, FB_THREADS, 0, st>>>(FWD_SUB_ARGS);
#undef FWD_SUB_ARGS
  return (int)cudaGetLastError();
}

// B10 / B23 (``pair`` null: the betas, member m on the last grid axis) or
// B11 (``pair`` given, M = 1: the confidence from pair, alphas and mtab).
// G == 1: one thread a chain (oh_bwd_kernel); G > 1: the two launches of
// oh_bwd_sub_kernel (qbuf [M, G, 5, NL]), the products shared.
static int launch_bwd(const void* pairn, const void* lens, const void* cs_next,
                      const void* beta0, const void* tab, void* out, void* qbuf, int Tp,
                      int NL, int nreal, int T, int G, int M, const void* pair,
                      const void* alphas, const void* mtab, int S, cudaStream_t st) {
  const bool conf = pair != nullptr;
  if (bad_stream(Tp, NL, nreal) || M < 1 || M > 65535 || G < 1 || G > SUB_LANES_MAX ||
      G > Tp || (conf && (M != 1 || S < 1 || S > MAX_S || nreal != S * S)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((NL + FB_THREADS - 1) / FB_THREADS);
  if (G == 1) {
#define BWD_ARGS                                                                     \
  (const int32_t*)pairn, (const int32_t*)pair, (const int32_t*)lens,                \
      (const float*)cs_next, (const float*)beta0, (const float*)alphas,             \
      (const float*)mtab, (const float*)tab, (float*)out, Tp, NL, nreal, S, T
    if (conf)
      oh_bwd_kernel<true><<<dim3(blocks, 1), FB_THREADS, 0, st>>>(BWD_ARGS);
    else
      oh_bwd_kernel<false><<<dim3(blocks, (unsigned)M), FB_THREADS, 0, st>>>(BWD_ARGS);
#undef BWD_ARGS
    return (int)cudaGetLastError();
  }
  const int L = (Tp + G - 1) / G;
  const dim3 grid(blocks, (unsigned)G, (unsigned)M);
#define BWD_SUB_ARGS                                                                   \
  (const int32_t*)pairn, (const int32_t*)lens, (const float*)cs_next,                 \
      (const float*)beta0, (const float*)tab, (float*)qbuf, (float*)out, Tp, NL, nreal,   \
      T, G, L, (const int32_t*)pair, (const float*)alphas, (const float*)mtab, S
  oh_bwd_sub_kernel<true, false><<<grid, FB_THREADS, 0, st>>>(BWD_SUB_ARGS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (conf)
    oh_bwd_sub_kernel<false, true><<<grid, FB_THREADS, 0, st>>>(BWD_SUB_ARGS);
  else
    oh_bwd_sub_kernel<false, false><<<grid, FB_THREADS, 0, st>>>(BWD_SUB_ARGS);
#undef BWD_SUB_ARGS
  return (int)cudaGetLastError();
}

int oh_fwd(const void* pair, const void* lens, const void* a0, const void* tab, void* alphas,
           void* pbuf, int Tp, int NL, int nreal, int G, void* stream) {
  return launch_fwd(pair, lens, a0, tab, alphas, pbuf, Tp, NL, nreal, G, 1,
                    (cudaStream_t)stream);
}

int oh_fwd_stacked(const void* pair, const void* lens, const void* a0, const void* tab,
                   void* alphas, void* pbuf, int Tp, int NL, int nreal, int G, int M,
                   void* stream) {
  return launch_fwd(pair, lens, a0, tab, alphas, pbuf, Tp, NL, nreal, G, M,
                    (cudaStream_t)stream);
}

int oh_bwd(const void* pairn, const void* lens, const void* cs_next, const void* beta0,
           const void* tab, void* betas, void* qbuf, int Tp, int NL, int nreal, int T, int G,
           void* stream) {
  return launch_bwd(pairn, lens, cs_next, beta0, tab, betas, qbuf, Tp, NL, nreal, T, G, 1,
                    nullptr, nullptr, nullptr, 1, (cudaStream_t)stream);
}

int oh_bwd_stacked(const void* pairn, const void* lens, const void* cs_next, const void* beta0,
                   const void* tab, void* betas, void* qbuf, int Tp, int NL, int nreal, int T,
                   int G, int M, void* stream) {
  return launch_bwd(pairn, lens, cs_next, beta0, tab, betas, qbuf, Tp, NL, nreal, T, G, M,
                    nullptr, nullptr, nullptr, 1, (cudaStream_t)stream);
}

int oh_bwd_conf(const void* pairn, const void* pair, const void* lens, const void* cs_next,
                const void* beta0, const void* alphas, const void* mtab, const void* tab,
                void* conf, void* qbuf, int Tp, int NL, int S, int T, int G, void* stream) {
  if (pair == nullptr) return (int)cudaErrorInvalidValue;
  return launch_bwd(pairn, lens, cs_next, beta0, tab, conf, qbuf, Tp, NL, S * S, T, G, 1, pair,
                    alphas, mtab, S, (cudaStream_t)stream);
}

int oh_stats(const void* alphas, const void* betas, const void* pair, const void* lens,
             const void* bred, const void* gt, void* part, void* macc, void* emit, void* ll,
             int Tp, int NL, int S, int K, int Tt, int SPB, void* stream) {
  return launch_seq_stats(true, alphas, betas, pair, lens, nullptr, bred, gt, nullptr, nullptr,
                          nullptr, part, macc, emit, ll, Tp, NL, S, K, Tt, SPB, 1,
                          (cudaStream_t)stream);
}

// B7 / B21: G sub-lanes a lane (fb_onehot.prod_sublanes), member m on grid y.
static int launch_prod(const void* pair, const void* tab, void* out, int Tp, int NL,
                       int nreal, int G, int M, cudaStream_t st) {
  if (bad_stream(Tp, NL, nreal) || M < 1 || M > 65535 || G < 1 || G > SUB_LANES_MAX || G > Tp)
    return (int)cudaErrorInvalidValue;
  const int L = (Tp + G - 1) / G;
  const dim3 grid((unsigned)((NL + FB_THREADS - 1) / FB_THREADS), (unsigned)M);
  const size_t msg_bytes = G > 1 ? (size_t)G * 4 * FB_THREADS * sizeof(float) : 0;
  oh_prod_kernel<<<grid, (unsigned)(FB_THREADS * G), msg_bytes, st>>>(
      (const int32_t*)pair, (const float*)tab, (float*)out, Tp, NL, nreal, G, L);
  return (int)cudaGetLastError();
}

int oh_prod(const void* pair, const void* tab, void* out, int Tp, int NL, int nreal, int G,
            void* stream) {
  return launch_prod(pair, tab, out, Tp, NL, nreal, G, 1, (cudaStream_t)stream);
}

int oh_prod_stacked(const void* pair, const void* tab, void* out, int Tp, int NL, int nreal,
                    int G, int M, void* stream) {
  return launch_prod(pair, tab, out, Tp, NL, nreal, G, M, (cudaStream_t)stream);
}

// B4 / B24: G sub-lanes a lane (fb_onehot.sublanes), member m on grid y.
static int launch_fwdbwd(bool stacked, const void* pair, const void* pairn, const void* lens,
                         const void* a0, const void* beta0, const void* tab, void* alphas,
                         void* betas, int Tp, int NL, int nreal, int T, int G, int M,
                         cudaStream_t st) {
  if (bad_stream(Tp, NL, nreal) || M < 1 || M > 65535 || G < 1 || G > SUB_LANES_MAX || G > Tp)
    return (int)cudaErrorInvalidValue;
  const int L = (Tp + G - 1) / G;
  const dim3 grid((unsigned)((NL + FB_THREADS - 1) / FB_THREADS), 2, (unsigned)M);
  const unsigned threads = (unsigned)(FB_THREADS * G);
  if (stacked)
    oh_fwdbwd_stacked_kernel<<<grid, threads, 0, st>>>(
        (const int32_t*)pair, (const int32_t*)pairn, (const int32_t*)lens, (const float*)a0,
        (const float*)beta0, (const float*)tab, (float*)alphas, (float*)betas, Tp, NL, nreal,
        T, G, L);
  else
    oh_fwdbwd_kernel<<<grid, threads, 0, st>>>(
        (const int32_t*)pair, (const int32_t*)pairn, (const int32_t*)lens, (const float*)a0,
        (const float*)beta0, (const float*)tab, (float*)alphas, (float*)betas, Tp, NL, nreal,
        T, G, L);
  return (int)cudaGetLastError();
}

int oh_fwdbwd(const void* pair, const void* pairn, const void* lens, const void* a0,
              const void* beta0, const void* tab, void* alphas, void* betas, int Tp,
              int NL, int nreal, int T, int G, void* stream) {
  return launch_fwdbwd(false, pair, pairn, lens, a0, beta0, tab, alphas, betas, Tp, NL, nreal,
                       T, G, 1, (cudaStream_t)stream);
}

int oh_fwdbwd_mat(const void* pair, const void* pairn, const void* lens, const void* tab,
                  void* va, void* wb, int Tp, int NL, int nreal, int T, void* stream) {
  if (bad_stream(Tp, NL, nreal)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((NL + FB_THREADS - 1) / FB_THREADS), 2);
  oh_fwdbwd_mat_kernel<<<grid, FB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pair, (const int32_t*)pairn, (const int32_t*)lens, (const float*)tab,
      (float*)va, (float*)wb, Tp, NL, nreal, T);
  return (int)cudaGetLastError();
}

int oh_fwdbwd_stacked(const void* pair, const void* pairn, const void* lens, const void* a0,
                      const void* beta0, const void* tab, void* alphas, void* betas, int Tp,
                      int NL, int nreal, int T, int G, int M, void* stream) {
  return launch_fwdbwd(true, pair, pairn, lens, a0, beta0, tab, alphas, betas, Tp, NL, nreal,
                       T, G, M, (cudaStream_t)stream);
}

int oh_seq_stats(const void* alphas, const void* betas, const void* pair, const void* lens,
                 const void* tab, const void* bred, const void* gt, const void* enters_full,
                 const void* enters_red, const void* pair0m, void* part, void* macc,
                 void* emit, void* ll, int Tp, int NL, int S, int K, int Tt, int SPB,
                 void* stream) {
  return launch_seq_stats(false, alphas, betas, pair, lens, tab, bred, gt, enters_full,
                          enters_red, pair0m, part, macc, emit, ll, Tp, NL, S, K, Tt, SPB, 1,
                          (cudaStream_t)stream);
}

int oh_seq_stats_stacked(const void* alphas, const void* betas, const void* pair,
                         const void* lens, const void* tab, const void* bred, const void* gt,
                         const void* enters_full, const void* enters_red, const void* pair0m,
                         void* part, void* macc, void* emit, void* ll, int Tp, int NL, int S,
                         int K, int Tt, int SPB, int M, void* stream) {
  return launch_seq_stats(false, alphas, betas, pair, lens, tab, bred, gt, enters_full,
                          enters_red, pair0m, part, macc, emit, ll, Tp, NL, S, K, Tt, SPB, M,
                          (cudaStream_t)stream);
}

// T2-T4 (the pair-composition variants): G == 1 one thread a chain
// (oh_fwd_strm_kernel, oh_fwd_comp_kernel; T4 oh_fwd_compsel_sub_kernel<1>
// alone, its one sub-lane the whole chain); G > 1 the three launches of
// oh_fwd_sub_kernel<., true> / oh_fwd_comp_sub_kernel /
// oh_fwd_compsel_sub_kernel (pbuf [G, 4, NL]).  T4's tables take
// comp_tables_bytes(S) of dynamic shared memory where they are read.
int oh_fwd_strm(const void* mats, const void* lens, const void* a0, void* alphas, void* pbuf,
                int Tp, int NL, int G, void* stream) {
  if (Tp <= 0 || NL <= 0 || G < 1 || G > SUB_LANES_MAX || G > Tp)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((NL + FB_THREADS - 1) / FB_THREADS);
  if (G == 1) {
    oh_fwd_strm_kernel<<<blocks, FB_THREADS, 0, st>>>(
        (const float*)mats, (const int32_t*)lens, (const float*)a0, (float*)alphas, Tp, NL);
    return (int)cudaGetLastError();
  }
  const int L = (Tp + G - 1) / G;
  const dim3 grid(blocks, (unsigned)G, 1u);
#define STRM_SUB_ARGS                                                                      \
  nullptr, (const float*)mats, (const int32_t*)lens, (const float*)a0, nullptr,            \
      (float*)alphas, (float*)pbuf, Tp, NL, 0, G, L
  oh_fwd_sub_kernel<0, true><<<grid, FB_THREADS, 0, st>>>(STRM_SUB_ARGS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_sub_kernel<1, true><<<grid, FB_THREADS, 0, st>>>(STRM_SUB_ARGS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_sub_kernel<2, true><<<grid, FB_THREADS, 0, st>>>(STRM_SUB_ARGS);
#undef STRM_SUB_ARGS
  return (int)cudaGetLastError();
}

int oh_fwd_comp(const void* comp, const void* lens, const void* a0, void* alphas, void* pbuf,
                int H, int NL, int G, void* stream) {
  if (H <= 0 || NL <= 0 || G < 1 || G > SUB_LANES_MAX || G > H)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((NL + FB_THREADS - 1) / FB_THREADS);
  if (G == 1) {
    oh_fwd_comp_kernel<<<blocks, FB_THREADS, 0, st>>>(
        (const float*)comp, (const int32_t*)lens, (const float*)a0, (float*)alphas, H, NL);
    return (int)cudaGetLastError();
  }
  const int Lh = (H + G - 1) / G;
  const dim3 grid(blocks, (unsigned)G, 1u);
#define COMP_SUB_ARGS \
  (const float*)comp, (const int32_t*)lens, (const float*)a0, (float*)alphas, (float*)pbuf, H, NL, G, Lh
  oh_fwd_comp_sub_kernel<0><<<grid, FB_THREADS, 0, st>>>(COMP_SUB_ARGS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_comp_sub_kernel<1><<<grid, FB_THREADS, 0, st>>>(COMP_SUB_ARGS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_comp_sub_kernel<2><<<grid, FB_THREADS, 0, st>>>(COMP_SUB_ARGS);
#undef COMP_SUB_ARGS
  return (int)cudaGetLastError();
}

int oh_fwd_compsel(const void* idx, const void* lens, const void* a0, const void* t2tab,
                   const void* rtab, const void* ttab, void* alphas, void* pbuf, int H, int NL,
                   int S, int G, void* stream) {
  if (H <= 0 || NL <= 0 || S < 1 || S > COMP_MAX_S || G < 1 || G > SUB_LANES_MAX || G > H)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((NL + FB_THREADS - 1) / FB_THREADS);
  const size_t smem = comp_tables_bytes(S);
  const int Lh = (H + G - 1) / G;
  const dim3 grid(blocks, (unsigned)G, 1u);
#define COMPSEL_SUB_ARGS                                                                 \
  (const int32_t*)idx, (const int32_t*)lens, (const float*)a0, (const float*)t2tab,       \
      (const float*)rtab, (const float*)ttab, (float*)alphas, (float*)pbuf, H, NL, S, G, Lh
  if (G == 1) {  // phase 1 alone: sub-lane 0 is the whole chain, from a0
    oh_fwd_compsel_sub_kernel<1><<<grid, FB_THREADS, smem, st>>>(COMPSEL_SUB_ARGS);
    return (int)cudaGetLastError();
  }
  oh_fwd_compsel_sub_kernel<0><<<grid, FB_THREADS, smem, st>>>(COMPSEL_SUB_ARGS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_compsel_sub_kernel<1><<<grid, FB_THREADS, smem, st>>>(COMPSEL_SUB_ARGS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oh_fwd_compsel_sub_kernel<2><<<grid, FB_THREADS, 0, st>>>(COMPSEL_SUB_ARGS);
#undef COMPSEL_SUB_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
