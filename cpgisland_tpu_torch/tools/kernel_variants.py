"""Variant builds of the dense chain kernels, of B5 / B12, of the decode
kernels and of the compose bench's chains, timed on identical inputs: the
measurements behind their layouts.

    python -m cpgisland_tpu_torch.tools.kernel_variants [--group dense|split|stats|decode|compose ...]
        [--variant NAME ...]

Each variant is a copy of a kernel source (``csrc/fb_dense.cu``,
``csrc/fb_onehot.cu``, ``csrc/viterbi_onehot.cu``, ``csrc/viterbi_dense.cu``) with
a few lines replaced (the table below), compiled with the port's nvcc flags
into ``build/kernel_variants/`` and called through its C interface, so a
variant changes nothing in the package.  On the card only, by group:

- ``dense``: B16, B18 and B19 at K = 2 (two_state) in sub-lanes on 1,024
  ragged chunks of 65,536 steps (G = 32) and on 8,192 lanes of 8,192 steps
  (G = 16 and 8), B19 also in one sub-lane (G = 1: its one-thread chain);
- ``split``: B16, B18 and B19 (island mask: the first half of the
  states) at K = 5 and 8 (seeded random models over 4 symbols) on the
  same two geometries, where each lane is one chain: the shipped
  state-split kernels (one state a thread, 8 threads a lane, a shuffle
  exchange, blocks of 16 lanes; B19 each thread dividing and storing
  once a group of 8 steps) against B19 dividing and storing at every
  step by one thread of the lane (``conf_step``), blocks of 4, 8 and 32
  lanes, two and four states a thread (:data:`SPT_KERNELS`), ``__frcp_rn``
  for the divisions, a branch around each store, the kernels as first
  written (:data:`SIMPLE_KERNELS`), a warp a state (:data:`WARP_KERNELS`:
  K warps a block of 32 lanes, the exchange through shared memory and a
  barrier each step, every store a 128-byte row), the stores staged in
  shared memory for 8 steps and written as whole rows
  (:data:`STAGE_KERNELS`, blocks of 32 lanes), one thread a chain (the
  K <= 4 kernels' template at K >= 5, the layout every K >= 5 launch ran
  before the state split) and, unchecked, the shipped kernels with their
  stores dropped (``diag_nostore``);
- ``stats``: B5 (the flagship) on 1,024 and the genome's 1,390 ragged
  chunks of 65,536 steps and on 8,192 and the genome's 11,121 seq lanes of
  8,192 steps, and B12 (B5's body with the cs-scaled normalizer, on B9's
  and B10's streams) on the same chunks, at segments of 128 to 1,024
  steps: the shipped build, its read-ahead at 4, 12 and 16 steps, blocks
  of 128 lanes of one segment, ``__fdiv_rn`` for the reciprocals, B12 as
  the parent ran it (``b12_parent``: one thread per (lane, segment) in
  blocks of 128 lanes, a step's loads when it runs, no block sums) and,
  unchecked, B5 without its log or its arithmetic;
- ``decode``: the reduced decode kernels (``csrc/viterbi_onehot.cu``: B2,
  B6, B27 and its scores arm, B1 / B26 and B3 / B28) and B14
  (``csrc/viterbi_dense.cu``, K = 2 and 8). Where the max-plus chains (B1
  and B2 share one body) take each step's pair or symbol and its table row
  from: the shipped registers read ahead (``BP_AHEAD`` / ``STEP_AHEAD`` 16;
  B14 also reads 8 steps' table rows before they run at K <= 2) against 8
  and 32 steps ahead, the loads before the read-ahead (8 steps loaded, then
  run; B14: one load a step), the table rows read the other way (a word's
  rows before its steps; B14: inside each step), a shared-memory ring filled
  by 4-byte ``cp.async`` (16 steps a stage, 5 stages, no block barrier),
  B2's blocks of 64 threads and, unchecked, the chains with their loads
  replaced by arithmetic (``diag_noload``). B1 / B26 one row a thread
  (blocks of 128, the two rows of a lane on neighbouring threads) up to 48
  Ki lanes or 32 Ki lanes x members and one thread a lane past them,
  against the rows on every lane count (``prod_rows``, and so each row
  layout below), blocks of 64 and 256, one thread a lane (as the parent
  ran it, or read ahead), B26's member on the grid's x axis (``prod_member_x``), at least 10
  blocks an SM (``prod_min10``) and the two rows of a lane a warp apart
  (``prod_warp_rows``). B3 / B28 in segments of 16 words (32 past 32 Ki
  lanes x members) joined by exact bits (``BT_AHEAD`` 16 steps read
  ahead, at most 32 segments a block, B28's member on the grid's x axis)
  against 8 and 32 steps ahead, at most 16
  segments, B28's member on y (``bt_member_y``), each word's bits resolved
  for both entering bits off the chain (``bt_resolved``), the segments on a
  (lane block, segment) grid in two launches (``bt_grid2``), the parent's
  one thread a lane and, unchecked, the walk with no loads or no stores;
  segments of 16 to 256 words (:data:`BT_SEGS`) on the shipped build and
  three others. B13 (``csrc/viterbi_dense.cu``, K = 2 and 8) one row of the
  product a thread up to 8 Ki lanes and one thread a lane past them (both
  read ahead: 16 steps at K = 2, 8 for rows and 2 for a lane above)
  against the rows or one thread a lane on every lane count
  (``dense_prod_rows``, ``dense_prod_lane``, the latter 4 and 8 steps
  ahead), the parent's one thread a lane with one load a step
  (``dense_prod_parent``), the table read as scalars with the odd stride
  K*K + 1 (``dense_prod_scalar``), two rows a thread at K >= 4, blocks of
  64 and 256, 16 and 8 steps ahead at every K and at least 8 blocks an
  SM. B15 (``csrc/viterbi_dense.cu``, K = 2 and 8) in segments of 128
  steps joined by exact K-state maps, one warp a segment of 32 lanes, its
  words read 16 ahead, against 8 and 32 ahead, blocks of 16 and 8 lanes
  (16 also with 64-step segments, and with 8 ahead) and the parent's one
  thread a lane (``dbt_parent``), with segments of 128 to 1,024 steps
  (:data:`DBT_SEGS`) on the shipped build and three others, at 4,096 x
  16,384 and at two_state's flushes. The reduced kernels at 4,096 x 16,384 (M = 2 and 5, B26 also at 3
  and 4, B1 also on 32, 48 and 64 Ki lanes, and S = 16 at M = 2) and at
  the largest mixed-model flush (8 records padded to 512 Ki: 4,096 x
  1,024; M = 2, 3), B14 at 4,096 x 16,384, B13 there, on 4, 8, 32, 48
  and 64 Ki lanes and at two_state's scaffold flushes (8 records padded to
  64 Ki and 512 Ki: 128 and 1,024 lanes of 4,096 steps).

- ``compose``: the compose bench's chains (``csrc/fb_onehot.cu``) through
  their C entries on its 64 Mi seeded symbols as 1,024 x 65,536 and 4,096 x
  16,384: T1 (B9), T2, T3 and T4 at G = 1 (one chain a lane, the parent
  layout of T2-T4), 8, 16 and 32 sub-lanes (:data:`COMPOSE_G`), on the
  shipped build, with T2 and T3's float streams read 16 rows ahead
  (``ahead16``), T4's index streams read 8 and 32 double steps ahead
  (``t4_ahead8``, ``t4_ahead32``) and, unchecked, with every alpha store
  behind a test no lane passes (``diag_nostore``): T2 bit for bit T1 and
  T4 bit for bit T3 at each G, T3's largest relative difference from the
  sequential chain.

Each variant's outputs are held against its group's unchanged build (bit
for bit for B16, B18, B19, B13 and the decode chains, within rtol 1e-5 / atol 1e-3 for the B5 layouts;
the ``diag_*`` variants drop work to find what bounds B5, the
state-split chains or the decode chains and are not checked).  Times: CUDA events, median of 15.  One JSON line per variant on
stdout, after the card's name and power limit (``nvidia-smi``); exits 2
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import HmmParams
from cpgisland_tpu_torch.ops import _kernels, fb_chunked
from cpgisland_tpu_torch.ops import fb_onehot as FB
from cpgisland_tpu_torch.ops import fb_pallas as FP
from cpgisland_tpu_torch.ops import viterbi_onehot as OH
from cpgisland_tpu_torch.ops import viterbi_pallas as VP
from cpgisland_tpu_torch.ops.prepared import prepare_chunked, prepare_seq
from cpgisland_tpu_torch.tools.bench_compose import card_line

OUT_DIR = _kernels.BUILD_DIR.parent / "kernel_variants"

# The state-split chains with a warp a state: warp k of a block of K warps
# carries state k of 32 lanes; each step's K values go through shared memory
# (two buffers, so one barrier a step suffices) and every store is a whole
# 128-byte row.  The operations and their order are the shipped kernels'.
WARP_KERNELS = r"""
template <int K>
__global__ void __launch_bounds__(K * 32)
fb_fwd_warp_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
                   const float* __restrict__ a0, const float* __restrict__ A,
                   const float* __restrict__ B, float* __restrict__ alphas, int Tp, int NL,
                   int S) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_x[2][K][32];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  const int k = threadIdx.x / 32, l = threadIdx.x % 32;
  const int n = blockIdx.x * 32 + l, ln = min(n, NL - 1);
  const size_t nl = (size_t)NL;
  float a_col[K];
#pragma unroll
  for (int j = 0; j < K; ++j) a_col[j] = s_A[j * K + k];
  const float* b_row = s_B + k * S;
  float v = a0[(size_t)k * nl + ln];
  float* out = alphas + (size_t)k * nl + n;
  if (n < NL) out[0] = v;
  const int len = lens[ln];
  const int32_t* p = steps + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_ints(p, nl, 1, 1, Tp, q);
  for (int t0 = 1; t0 < Tp; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < Tp) {
        s_x[t & 1][k][l] = v;
        __syncthreads();
        float x[K];
#pragma unroll
        for (int j = 0; j < K; ++j) x[j] = s_x[t & 1][j][l];
        const float inv = __fdiv_rn(1.0f, seq_sum<K>(x));
        float acc = __fmul_rn(x[0], a_col[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], a_col[j]));
        const int o = min(max(q[r], 0), S - 1);
        const float nv = __fmul_rn(__fmul_rn(acc, b_row[o]), inv);
        v = t < len ? nv : v;
        if (n < NL) out[(size_t)t * K * nl] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

template <int K>
__global__ void __launch_bounds__(K * 32)
fb_bwd_warp_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                   const float* __restrict__ cs_next, const float* __restrict__ beta0,
                   const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ betas, int Tp, int NL, int S, int T) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_x[2][K][32];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  const int k = threadIdx.x / 32, l = threadIdx.x % 32;
  const int n = blockIdx.x * 32 + l, ln = min(n, NL - 1);
  const size_t nl = (size_t)NL;
  float a_row[K];
#pragma unroll
  for (int j = 0; j < K; ++j) a_row[j] = s_A[k * K + j];
  const float* b_row = s_B + k * S;
  float beta = beta0[(size_t)k * nl + ln];
  float* out = betas + (size_t)k * nl + n;
  const int len = lens[ln];
  const int32_t* p = steps_next + ln;
  const float* c = cs_next + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cq[LOOKAHEAD], cqn[LOOKAHEAD];
  load_ints(p, nl, Tp - 1, -1, Tp, q);
  load_floats(c, nl, Tp - 1, -1, Tp, cq);
  for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
    load_ints(p, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, qn);
    load_floats(c, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, cqn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0) {
        const int o = min(max(q[r], 0), S - 1);
        const float bi = __fmul_rn(b_row[o], __fdiv_rn(1.0f, cq[r]));
        s_x[t & 1][k][l] = __fmul_rn(bi, beta);
        __syncthreads();
        float acc = __fmul_rn(a_row[0], s_x[t & 1][0][l]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(a_row[j], s_x[t & 1][j][l]));
        beta = (t <= T - 2 && t + 1 < len) ? acc : beta;
        if (n < NL) out[(size_t)t * K * nl] = beta;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      cq[r] = cqn[r];
    }
  }
}
"""

# The state-split chains as first written: the group exchanges v (B16) or w
# (B18) and each step forms its own division, B[k, o] load and product, with
# a test of t at every step.
SIMPLE_KERNELS = r"""
// One float a thread, the group's K values (one state a thread).
template <int K>
__device__ __forceinline__ void one_gather(float x, float (&all)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) all[j] = __shfl_sync(0xffffffffu, x, j, SPLIT_KP);
}

template <int K>
__global__ void __launch_bounds__(SPLIT_THREADS)
fb_fwd_simple_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
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
  float v = own ? a0[(size_t)kc * nl + ln] : 0.0f;
  float* out = alphas + (size_t)kc * nl + n;
  if (stores) out[0] = v;
  const int len = lens[ln];
  const int32_t* p = steps + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_ints(p, nl, 1, 1, Tp, q);
  for (int t0 = 1; t0 < Tp; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < Tp) {
        float x[K];
        one_gather<K>(v, x);
        const float inv = __fdiv_rn(1.0f, seq_sum<K>(x));
        float acc = __fmul_rn(x[0], a_col[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], a_col[j]));
        const int o = min(max(q[r], 0), S - 1);
        const float nv = __fmul_rn(__fmul_rn(acc, b_row[o]), inv);
        v = t < len ? nv : v;
        if (stores) out[(size_t)t * K * nl] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

template <int K>
__global__ void __launch_bounds__(SPLIT_THREADS)
fb_bwd_simple_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                    const float* __restrict__ cs_next, const float* __restrict__ beta0,
                    const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ betas, int Tp, int NL, int S, int T) {
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
  float beta = own ? beta0[(size_t)kc * nl + ln] : 0.0f;
  float* out = betas + (size_t)kc * nl + n;
  const int len = lens[ln];
  const int32_t* p = steps_next + ln;
  const float* c = cs_next + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cq[LOOKAHEAD], cqn[LOOKAHEAD];
  load_ints(p, nl, Tp - 1, -1, Tp, q);
  load_floats(c, nl, Tp - 1, -1, Tp, cq);
  for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
    load_ints(p, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, qn);
    load_floats(c, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, cqn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0) {
        const int o = min(max(q[r], 0), S - 1);
        const float bi = __fmul_rn(b_row[o], __fdiv_rn(1.0f, cq[r]));
        float w[K];
        one_gather<K>(__fmul_rn(bi, beta), w);
        float acc = __fmul_rn(a_row[0], w[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(a_row[j], w[j]));
        beta = (t <= T - 2 && t + 1 < len) ? acc : beta;
        if (stores) out[(size_t)t * K * nl] = beta;
      }
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      cq[r] = cqn[r];
    }
  }
}

"""

# The state-split chains with SPT_SPT states a thread (SPT_KP = 8 / SPT_SPT
# threads a lane, 16 lanes a block): a K-float exchange a step as in the
# shipped kernels (one state a thread), each thread SPT_SPT of the columns
# (B16) or rows (B18), each store instruction SPT_SPT x 4 lanes wide; B18's
# divisions spread SPT_DIV a thread a group.  The operations and their order
# are the shipped kernels'.
SPT_KERNELS = r"""
#define SPT_SPT 2                    // states a thread
#define SPT_KP (8 / SPT_SPT)         // threads a lane: 8 states, K..7 zeros
#define SPT_LANES 16                 // lanes a block
#define SPT_THREADS (SPT_LANES * SPT_KP)
#define SPT_DIV (LOOKAHEAD / SPT_KP)  // B18's divisions a thread a group

// (this thread's place g in its lane's group, lane n) of this thread; it
// carries states g * SPT_SPT + e, e < SPT_SPT; lanes past NL read lane
// NL - 1.
__device__ __forceinline__ void spt_coords(int NL, int& g, int& n, int& ln) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  g = i % SPT_KP;
  n = i / SPT_KP;
  ln = min(n, NL - 1);
}

// The group's K values of u (state j from thread j / SPT_SPT), state 0
// first.
template <int K>
__device__ __forceinline__ void spt_gather(const float (&u)[SPT_SPT], float (&all)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    all[j] = __shfl_sync(0xffffffffu, u[j % SPT_SPT], j / SPT_SPT, SPT_KP);
}

// A thread's states and tables: own[e] (state k0 + e < K), column (B16) or
// row (B18) k0 + e of A, row k0 + e of B (clamped to a real state).
template <int K, bool COLS>
struct SptStates {
  bool own[SPT_SPT];
  float a[SPT_SPT][K];
  const float* b[SPT_SPT];
  int kc[SPT_SPT];
  __device__ __forceinline__ SptStates(const float* s_A, const float* s_B, int S, int k0) {
#pragma unroll
    for (int e = 0; e < SPT_SPT; ++e) {
      own[e] = k0 + e < K;
      kc[e] = min(k0 + e, K - 1);
#pragma unroll
      for (int j = 0; j < K; ++j)
        a[e][j] = own[e] ? s_A[COLS ? j * K + kc[e] : kc[e] * K + j] : 0.0f;
      b[e] = s_B + kc[e] * S;
    }
  }
};

// The forward carries this thread's v_t as u * s: u its raw products (sum_j
// v_{t-1}[j] A[j, k]) * B[k, o_t] and s = 1 / sum v_{t-1}, the product the
// one-thread chain rounds last (v_0 = a0 * 1, exact).  The group exchanges
// u, and each thread forms v[j] = u[j] * s itself, so a step issues its
// exchange before its division and the two latencies overlap.  x: the
// group's u entering the step (the next step's on return); b: B[k, o_t];
// dst: state k0's row of the step (state k0 + e at dst + e nl).
template <int K>
__device__ __forceinline__ void fwd_spt_step(const SptStates<K, true>& st,
                                               const float (&b)[SPT_SPT], bool live,
                                               float (&x)[K], float (&u)[SPT_SPT], float& s,
                                               float* dst, size_t nl, bool in_range) {
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = __fmul_rn(x[j], s);
#pragma unroll
  for (int e = 0; e < SPT_SPT; ++e) {
    float acc = __fmul_rn(v[0], st.a[e][0]);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], st.a[e][j]));
    u[e] = live ? __fmul_rn(acc, b[e]) : u[e];
  }
  const float sum = seq_sum<K>(v);
  spt_gather<K>(u, x);
  const float inv = __fdiv_rn(1.0f, sum);
  s = live ? inv : s;
#pragma unroll
  for (int e = 0; e < SPT_SPT; ++e)
    store_if(dst + e * nl, __fmul_rn(u[e], s), in_range && st.own[e]);
}

// A group's B[k, o_t] for each of this thread's states, t = t0 + r (r <
// LOOKAHEAD), from its symbols q.
template <int K, bool COLS>
__device__ __forceinline__ void spt_emits(const SptStates<K, COLS>& st, int S,
                                            const int (&q)[LOOKAHEAD],
                                            float (&bq)[LOOKAHEAD][SPT_SPT]) {
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int o = min(max(q[r], 0), S - 1);
#pragma unroll
    for (int e = 0; e < SPT_SPT; ++e) bq[r][e] = st.b[e][o];
  }
}

template <int K>
__global__ void __launch_bounds__(SPT_THREADS)
fb_fwd_spt_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
                    const float* __restrict__ a0, const float* __restrict__ A,
                    const float* __restrict__ B, float* __restrict__ alphas, int Tp, int NL,
                    int S) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  int g, n, ln;
  spt_coords(NL, g, n, ln);
  const SptStates<K, true> st(s_A, s_B, S, g * SPT_SPT);
  const bool in_range = n < NL;
  const size_t nl = (size_t)NL;
  float* out = alphas + (size_t)st.kc[0] * nl + n;  // state k0's row, step 0
  float u[SPT_SPT], s = 1.0f;
#pragma unroll
  for (int e = 0; e < SPT_SPT; ++e) {
    u[e] = st.own[e] ? a0[(size_t)st.kc[e] * nl + ln] : 0.0f;
    store_if(out + e * nl, u[e], in_range && st.own[e]);
  }
  float x[K];
  spt_gather<K>(u, x);
  const int len = lens[ln];
  const int32_t* p = steps + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float bq[LOOKAHEAD][SPT_SPT];
  load_ints(p, nl, 1, 1, Tp, q);
  int t0 = 1;
  // Whole groups with no test of t: one straight run of LOOKAHEAD steps.
  for (; t0 + LOOKAHEAD <= Tp; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
    spt_emits(st, S, q, bq);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      fwd_spt_step<K>(st, bq[r], t < len, x, u, s, out + (size_t)t * K * nl, nl, in_range);
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  spt_emits(st, S, q, bq);
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = t0 + r;
    if (t < Tp)
      fwd_spt_step<K>(st, bq[r], t < len, x, u, s, out + (size_t)t * K * nl, nl, in_range);
  }
}

// A backward group's column scales B[k, o] * (1 / c) for each of this
// thread's states, t = Tp - 1 - (g0 + r): thread g of the lane's group
// divides for steps r = g SPT_DIV + e (its c, cm[e]) and the group reads
// each quotient by shuffle, SPT_DIV divisions a thread a group.
template <int K>
__device__ __forceinline__ void spt_scales(const SptStates<K, false>& st, int S,
                                             const int (&q)[LOOKAHEAD],
                                             const float (&cm)[SPT_DIV],
                                             float (&bq)[LOOKAHEAD][SPT_SPT]) {
  float inv[SPT_DIV];
#pragma unroll
  for (int e = 0; e < SPT_DIV; ++e) inv[e] = __fdiv_rn(1.0f, cm[e]);
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int o = min(max(q[r], 0), S - 1);
    const float ic = __shfl_sync(0xffffffffu, inv[r % SPT_DIV], r / SPT_DIV, SPT_KP);
#pragma unroll
    for (int e = 0; e < SPT_SPT; ++e) bq[r][e] = __fmul_rn(st.b[e][o], ic);
  }
}

// B18's step: w[k] = bi[k] * beta[k] exchanged, state j's nb[j] = sum_k
// A[j, k] * w[k], k in order; kept where ``keep``.
template <int K>
__device__ __forceinline__ void bwd_spt_step(const SptStates<K, false>& st,
                                               const float (&bi)[SPT_SPT], bool keep,
                                               float (&beta)[SPT_SPT], float* dst, size_t nl,
                                               bool in_range) {
  float w[SPT_SPT], wx[K];
#pragma unroll
  for (int e = 0; e < SPT_SPT; ++e) w[e] = __fmul_rn(bi[e], beta[e]);
  spt_gather<K>(w, wx);
#pragma unroll
  for (int e = 0; e < SPT_SPT; ++e) {
    float acc = __fmul_rn(st.a[e][0], wx[0]);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(st.a[e][j], wx[j]));
    beta[e] = keep ? acc : beta[e];
    store_if(dst + e * nl, beta[e], in_range && st.own[e]);
  }
}

template <int K>
__global__ void __launch_bounds__(SPT_THREADS)
fb_bwd_spt_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                    const float* __restrict__ cs_next, const float* __restrict__ beta0,
                    const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ betas, int Tp, int NL, int S, int T) {
  static_assert(LOOKAHEAD % SPT_KP == 0, "a group's threads divide for its steps");
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  int g, n, ln;
  spt_coords(NL, g, n, ln);
  const SptStates<K, false> st(s_A, s_B, S, g * SPT_SPT);
  const bool in_range = n < NL;
  const size_t nl = (size_t)NL;
  float* out = betas + (size_t)st.kc[0] * nl + n;  // state k0's row, step 0
  float beta[SPT_SPT];
#pragma unroll
  for (int e = 0; e < SPT_SPT; ++e) beta[e] = st.own[e] ? beta0[(size_t)st.kc[e] * nl + ln] : 0.0f;
  const int len = lens[ln];
  const int32_t* p = steps_next + ln;
  const float* c = cs_next + ln;
  // This thread's steps of the group starting at g0: Tp - 1 - (g0 + g SPT_DIV + e).
  const auto c_at = [&](int g0, float (&cm)[SPT_DIV]) {
#pragma unroll
    for (int e = 0; e < SPT_DIV; ++e) {
      const int t = Tp - 1 - (g0 + g * SPT_DIV + e);
      cm[e] = (t >= 0 && t < Tp) ? __ldg(c + (size_t)t * nl) : 1.0f;
    }
  };
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cm[SPT_DIV], cmn[SPT_DIV], bq[LOOKAHEAD][SPT_SPT];
  load_ints(p, nl, Tp - 1, -1, Tp, q);
  c_at(0, cm);
  int g0 = 0;
  // Whole groups with no test of t: one straight run of LOOKAHEAD steps.
  for (; g0 + LOOKAHEAD <= Tp; g0 += LOOKAHEAD) {
    load_ints(p, nl, Tp - 1 - (g0 + LOOKAHEAD), -1, Tp, qn);
    c_at(g0 + LOOKAHEAD, cmn);
    spt_scales(st, S, q, cm, bq);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (g0 + r);
      bwd_spt_step<K>(st, bq[r], t <= T - 2 && t + 1 < len, beta, out + (size_t)t * K * nl,
                        nl, in_range);
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
#pragma unroll
    for (int e = 0; e < SPT_DIV; ++e) cm[e] = cmn[e];
  }
  spt_scales(st, S, q, cm, bq);
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = Tp - 1 - (g0 + r);
    if (t >= 0)
      bwd_spt_step<K>(st, bq[r], t <= T - 2 && t + 1 < len, beta, out + (size_t)t * K * nl,
                        nl, in_range);
  }
}
"""

# The first state-split chains with their stores staged: blocks of 256
# threads (32 lanes) keep LOOKAHEAD steps' values in shared memory and write
# them as whole 128-byte rows between two barriers.
STAGE_KERNELS = r"""
// One float a thread, the group's K values (one state a thread).
template <int K>
__device__ __forceinline__ void one_gather(float x, float (&all)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) all[j] = __shfl_sync(0xffffffffu, x, j, SPLIT_KP);
}

template <int K>
__global__ void __launch_bounds__(256)
fb_fwd_stage_kernel(const int32_t* __restrict__ steps, const int32_t* __restrict__ lens,
                    const float* __restrict__ a0, const float* __restrict__ A,
                    const float* __restrict__ B, float* __restrict__ alphas, int Tp, int NL,
                    int S) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_st[LOOKAHEAD][K][32];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  int k, n, ln;
  split_coords(NL, k, n, ln);
  const bool own = k < K;
  const int kc = min(k, K - 1), lb = threadIdx.x / SPLIT_KP;
  const size_t nl = (size_t)NL;
  float a_col[K];
#pragma unroll
  for (int j = 0; j < K; ++j) a_col[j] = own ? s_A[j * K + kc] : 0.0f;
  const float* b_row = s_B + kc * S;
  float v = own ? a0[(size_t)kc * nl + ln] : 0.0f;
  if (own && n < NL) alphas[(size_t)kc * nl + n] = v;
  const int len = lens[ln];
  const int32_t* p = steps + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_ints(p, nl, 1, 1, Tp, q);
  for (int t0 = 1; t0 < Tp; t0 += LOOKAHEAD) {
    load_ints(p, nl, t0 + LOOKAHEAD, 1, Tp, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < Tp) {
        float x[K];
        one_gather<K>(v, x);
        const float inv = __fdiv_rn(1.0f, seq_sum<K>(x));
        float acc = __fmul_rn(x[0], a_col[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], a_col[j]));
        const int o = min(max(q[r], 0), S - 1);
        const float nv = __fmul_rn(__fmul_rn(acc, b_row[o]), inv);
        v = t < len ? nv : v;
        if (own) s_st[r][kc][lb] = v;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < LOOKAHEAD * K * 32; i += 256) {
      const int r = i / (K * 32), kk = (i / 32) % K, m = blockIdx.x * 32 + i % 32;
      if (t0 + r < Tp && m < NL) alphas[((size_t)(t0 + r) * K + kk) * nl + m] = s_st[r][kk][i % 32];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
}

template <int K>
__global__ void __launch_bounds__(256)
fb_bwd_stage_kernel(const int32_t* __restrict__ steps_next, const int32_t* __restrict__ lens,
                    const float* __restrict__ cs_next, const float* __restrict__ beta0,
                    const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ betas, int Tp, int NL, int S, int T) {
  __shared__ float s_A[K * K];
  __shared__ float s_B[K * MAX_S];
  __shared__ float s_st[LOOKAHEAD][K][32];
  load_tables<K>(s_A, s_B, A, B, S);
  __syncthreads();
  int k, n, ln;
  split_coords(NL, k, n, ln);
  const bool own = k < K;
  const int kc = min(k, K - 1), lb = threadIdx.x / SPLIT_KP;
  const size_t nl = (size_t)NL;
  float a_row[K];
#pragma unroll
  for (int j = 0; j < K; ++j) a_row[j] = own ? s_A[kc * K + j] : 0.0f;
  const float* b_row = s_B + kc * S;
  float beta = own ? beta0[(size_t)kc * nl + ln] : 0.0f;
  const int len = lens[ln];
  const int32_t* p = steps_next + ln;
  const float* c = cs_next + ln;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  float cq[LOOKAHEAD], cqn[LOOKAHEAD];
  load_ints(p, nl, Tp - 1, -1, Tp, q);
  load_floats(c, nl, Tp - 1, -1, Tp, cq);
  for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
    load_ints(p, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, qn);
    load_floats(c, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, cqn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0) {
        const int o = min(max(q[r], 0), S - 1);
        const float bi = __fmul_rn(b_row[o], __fdiv_rn(1.0f, cq[r]));
        float w[K];
        one_gather<K>(__fmul_rn(bi, beta), w);
        float acc = __fmul_rn(a_row[0], w[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(a_row[j], w[j]));
        beta = (t <= T - 2 && t + 1 < len) ? acc : beta;
        if (own) s_st[r][kc][lb] = beta;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < LOOKAHEAD * K * 32; i += 256) {
      const int r = i / (K * 32), kk = (i / 32) % K, m = blockIdx.x * 32 + i % 32;
      const int t = Tp - 1 - (k0 + r);
      if (t >= 0 && m < NL) betas[((size_t)t * K + kk) * nl + m] = s_st[r][kk][i % 32];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      q[r] = qn[r];
      cq[r] = cqn[r];
    }
  }
}
"""
_B20 = "// ---------------------------------------------------------------------------\n// B20:"
_FWD_LAUNCH = ("  fb_fwd_split_kernel<K><<<blocks_for(NL * SPLIT_KP, SPLIT_THREADS), SPLIT_THREADS, "
               "0, st>>>(")
_BWD_LAUNCH = _FWD_LAUNCH.replace("fb_fwd_", "fb_bwd_")
_STORE_IF = '"r"((unsigned)on)'
_THREADS = "#define SPLIT_THREADS 128"


def _spt_variant(spt: int) -> list:
    """The replacements that build SPT_KERNELS with ``spt`` states a thread
    and launch them for K >= 5."""
    body = SPT_KERNELS.replace("#define SPT_SPT 2 ", f"#define SPT_SPT {spt} ")
    launch = "  fb_{}_spt_kernel<K><<<blocks_for(NL * SPT_KP, SPT_THREADS), SPT_THREADS, 0, st>>>("
    return [(_B20, body + "\n" + _B20), (_FWD_LAUNCH, launch.format("fwd")),
            (_BWD_LAUNCH, launch.format("bwd"))]


# The one-thread chain at K >= 5: the C entries' K >= 5 cases (B16, B18 and
# B19) sent to the K <= 4 launchers' template.
_ONE_THREAD = [(f"case {k}: return CALL_{d}X({k});", f"case {k}: return CALL_{d}({k});")
               for d in "FBC" for k in range(5, 9)]
# B19's state split with its epilogue at every step: thread 0 of the lane
# divides and stores (a 16-byte row piece a warp a step) instead of thread r
# once a group for step r.
_CONF_STEP = [
    ("if (CONF) split_conf_sums<K>(aq[CONF ? r : 0][0], beta, mk, k == r, isl, tot);",
     "if (CONF) {\n        split_conf_sums<K>(aq[CONF ? r : 0][0], beta, mk, true, isl, tot);\n"
     "        split_conf_store(conf, nl, t, len, isl, tot, n < NL && k == 0);\n      }"),
    ("      split_conf_store(conf, nl, Tp - 1 - (k0 + k), len, isl, tot, n < NL);\n", ""),
    ("  if (CONF) split_conf_store(conf, nl, Tp - 1 - (k0 + k), len, isl, tot, n < NL);\n", "")]

# ---------------------------------------------------------------------------
# The decode group: where B2 / B6 / B27 (csrc/viterbi_onehot.cu) and B14
# (csrc/viterbi_dense.cu) take each step's pair or symbol and table row
# from.  Each text replaces the shipped code from its first anchor up to
# (not including) its second; the chain's operations are the same in all.
_OH_REGION = ("// B1, B2 and B6 share one chain body", "// B2 / B6, and with M > 1")
_DENSE_REGION = ("// B14: replaces _backpointers_kernel.", "// B15: replaces _backtrace_kernel.")
_B13_REGION = ("// B13: replaces cpgisland_tpu/ops/viterbi_pallas.py::_products_kernel.",
               "// TT steps of B14's chain")
_B13_LAUNCH = ("template <int K, int R>\nstatic int launch_products_r(",
               "template <int K>\nstatic int launch_backpointers(")

# B13 as the parent ran it: one thread a lane, one load a step (two steps
# unrolled), the table rows K*K + 1 floats apart read as scalars.
B13_PARENT_KERNEL = r"""// B13: replaces cpgisland_tpu/ops/viterbi_pallas.py::_products_kernel.  Per
// lane, the max-plus product of its bk step matrices, written as
// out[i*K + m, b] = C[i][m].  Reads 4 B per step (the step stream), writes
// 4*K*K B per lane.
template <int K>
__global__ void __launch_bounds__(THREADS)
dense_products_kernel(const int32_t* __restrict__ steps, const float* __restrict__ logAT,
                      const float* __restrict__ logB, float* __restrict__ out, int bk, int nb,
                      int S) {
  extern __shared__ float s_M[];
  load_step_table<K>(s_M, logAT, logB, S);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float C[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int m = 0; m < K; ++m) C[i][m] = (i == m) ? 0.0f : LOG_ZERO;
  const int32_t* p = steps + b;
#pragma unroll 2
  for (int k = 0; k < bk; ++k) {
    const int sym = min(__ldg(p + (size_t)k * nb), S);
    const float* Ms = s_M + sym * (K * K + 1);
    float N[K][K];
    // Column by column: M_s[:, j] is K lookups; new[i][j] = max_m C[i][m] + M[m][j].
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float col[K];
#pragma unroll
      for (int m = 0; m < K; ++m) col[m] = Ms[m * K + j];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float best = C[i][0] + col[0];
#pragma unroll
        for (int m = 1; m < K; ++m) best = fmaxf(best, C[i][m] + col[m]);
        N[i][j] = best;
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int m = 0; m < K; ++m) C[i][m] = N[i][m];
  }
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int m = 0; m < K; ++m) out[(size_t)(i * K + m) * nb + b] = C[i][m];
}

"""
B13_PARENT_LAUNCH = r"""template <int K>
static int launch_products(const void* steps, const void* logAT, const void* logB, void* out,
                           int bk, int nb, int S, cudaStream_t stream) {
  const size_t smem = table_bytes(K, S);
  int err = allow_smem(dense_products_kernel<K>, smem);
  if (err) return err;
  dense_products_kernel<K><<<grid_for(nb), THREADS, smem, stream>>>(
      (const int32_t*)steps, (const float*)logAT, (const float*)logB, (float*)out, bk, nb, S);
  return (int)cudaGetLastError();
}

"""
# B13's rows with the table read as scalars, rows K*K + 1 floats apart (an
# odd stride: B14's table).
_B13_STRIDE = ("#define PROD_STRIDE(KK) \\\n"
               "  ((((KK) + 3) / 4 * 4) % 8 == 0 ? ((KK) + 3) / 4 * 4 + 4 : ((KK) + 3) / 4 * 4)",
               "#define PROD_STRIDE(KK) ((KK) + 1)")
_B13_FLOAT4 = ("""    const float4* M4 = reinterpret_cast<const float4*>(s_M + min(q[i], S) * SP);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 x = M4[v];
      Mt[i][4 * v] = x.x;
      Mt[i][4 * v + 1] = x.y;
      Mt[i][4 * v + 2] = x.z;
      Mt[i][4 * v + 3] = x.w;
    }""", """    const float* Ms = s_M + min(q[i], S) * SP;
#pragma unroll
    for (int v = 0; v < K * K; ++v) Mt[i][v] = Ms[v];""")
_B13_ROWS_MAX = "#define DENSE_ROWS_MAX_LANES "
_B13_AHEAD = "#define PROD_AHEAD(KK) ((KK) <= 4 ? 16 : 8)"
_B13_LANE_AHEAD = "#define LANE_AHEAD(KK) ((KK) <= 4 ? 16 : 2)"

# The chain body (B1, B2, B6) as B2 / B6 ran before the read-ahead: 8 steps
# loaded, then run, then the next 8.
TILE8_OH_BODY = r"""template <bool WANT_BP, bool WANT_DMAX>
__device__ __forceinline__ void oh_backpointers_body(
    const int32_t* __restrict__ pair2, float d0, float d1, const float* __restrict__ s_tab,
    int32_t* __restrict__ bp, float* __restrict__ dexit, int32_t* __restrict__ ebits,
    float* __restrict__ dmax, int bk, int nb, int b) {
  int32_t E = 0b10;
  const int32_t* p = pair2 + b;
  for (int k0 = 0; k0 < bk; k0 += ROW_TILE) {
    int q[ROW_TILE];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) q[r] = __ldg(p + (size_t)(k0 + r) * nb);
    int32_t word = 0;
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
      const float* t = s_tab + 4 * q[r];
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
      if (WANT_DMAX) dmax[(size_t)(k0 + r) * nb + b] = fmaxf(d0, d1);
    }
    if (WANT_BP) bp[(size_t)(k0 / ROW_TILE) * nb + b] = word;
  }
  dexit[b] = d0;
  dexit[(size_t)nb + b] = d1;
  if (WANT_BP) ebits[b] = E;
}

"""

# The chain body with each word's table rows read before its steps run.
ROWS_FIRST_OH_BODY = r"""// One packed word of the reduced delta recursion: the ROW_TILE steps whose
// pairs are q[0..7].  Their table rows are read first, so no step of the
// chain waits on a shared-memory lookup; then the steps run in order.
// Returns the word (WANT_BP); with WANT_DMAX stores the chain max after
// step r at dmax_w[r * nb].
template <bool WANT_BP, bool WANT_DMAX>
__device__ __forceinline__ int32_t word_steps(const int* q, const float* __restrict__ s_tab,
                                              float& d0, float& d1, int32_t& E,
                                              float* __restrict__ dmax_w, int nb) {
  float t0[ROW_TILE], t1[ROW_TILE], t2[ROW_TILE], t3[ROW_TILE];
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) {
    const float* t = s_tab + 4 * q[r];
    t0[r] = t[0];
    t1[r] = t[1];
    t2[r] = t[2];
    t3[r] = t[3];
  }
  int32_t word = 0;
#pragma unroll
  for (int r = 0; r < ROW_TILE; ++r) {
    const float a0 = d0 + t0[r];
    const float a1 = d1 + t2[r];
    const float b0 = d0 + t1[r];
    const float b1 = d1 + t3[r];
    const int32_t bp0 = a1 > a0;
    const int32_t bp1 = b1 > b0;
    d0 = fmaxf(a0, a1);
    d1 = fmaxf(b0, b1);
    if (WANT_BP) {
      word |= (bp0 | (bp1 << 1)) << (2 * r);
      E = ((E >> bp0) & 1) | (((E >> bp1) & 1) << 1);
    }
    if (WANT_DMAX) dmax_w[(size_t)r * nb] = fmaxf(d0, d1);
  }
  return word;
}

template <bool WANT_BP, bool WANT_DMAX>
__device__ __forceinline__ void oh_backpointers_body(
    const int32_t* __restrict__ pair2, float d0, float d1, const float* __restrict__ s_tab,
    int32_t* __restrict__ bp, float* __restrict__ dexit, int32_t* __restrict__ ebits,
    float* __restrict__ dmax, int bk, int nb, int b) {
  int32_t E = 0b10;
  const int32_t* p = pair2 + b;
  int q[BP_AHEAD], qn[BP_AHEAD];
  load_pairs(p, nb, 0, bk, q);
  for (int k0 = 0; k0 < bk; k0 += BP_AHEAD) {
    load_pairs(p, nb, k0 + BP_AHEAD, bk, qn);
#pragma unroll
    for (int w = 0; w < BP_AHEAD / ROW_TILE; ++w) {
      const int kw = k0 + w * ROW_TILE;
      if (kw < bk) {
        const int32_t word = word_steps<WANT_BP, WANT_DMAX>(
            q + w * ROW_TILE, s_tab, d0, d1, E, WANT_DMAX ? dmax + (size_t)kw * nb + b : nullptr,
            nb);
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

"""

# The ring design: each thread copies its own lane's column with 4-byte
# cp.async (a warp's row is one 128-byte transaction) into a shared ring of
# RING_D stages of RING_R rows, RING_D - 1 stages ahead of the chain, and
# waits for its own oldest stage only (no block barrier).  A stage's rows
# past bk are not copied; every stage still commits a group, so the wait
# counts stay aligned.  The chain takes each stage's pairs / symbols into
# registers and runs the shipped steps (B14: dense_tile) on them.
_RING_ISSUE = r"""#define RING_R {R}
#define RING_D {D}
#define RING_T {T}
__device__ __forceinline__ void ring_issue(int32_t* slot, const int32_t* __restrict__ p, int nb,
                                           int k0, int bk) {{
#pragma unroll
  for (int r = 0; r < RING_R; ++r) {{
    const int k = k0 + r;
    if (k < bk) {{
      const unsigned dst = (unsigned)__cvta_generic_to_shared(slot + r * RING_T);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(p + (size_t)k * nb) : "memory");
    }}
  }}
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}}

"""
_RING_LOOP_HEAD = r"""  __shared__ int32_t s_ring[RING_D * RING_R * RING_T];
  int32_t* ring = s_ring + threadIdx.x;
#pragma unroll
  for (int s = 0; s < RING_D - 1; ++s)
    ring_issue(ring + s * RING_R * RING_T, p, nb, s * RING_R, bk);
  int slot = 0;
  for (int k0 = 0; k0 < bk; k0 += RING_R) {
    ring_issue(ring + (slot == 0 ? RING_D - 1 : slot - 1) * RING_R * RING_T, p, nb,
               k0 + (RING_D - 1) * RING_R, bk);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_D - 1) : "memory");
    int q[RING_R];
#pragma unroll
    for (int r = 0; r < RING_R; ++r) q[r] = ring[(slot * RING_R + r) * RING_T];
    slot = slot + 1 == RING_D ? 0 : slot + 1;
""".replace("{", "{{").replace("}", "}}")

RING_OH_BODY = _RING_ISSUE + r"""template <bool WANT_BP, bool WANT_DMAX>
__device__ __forceinline__ void oh_backpointers_body(
    const int32_t* __restrict__ pair2, float d0, float d1, const float* __restrict__ s_tab,
    int32_t* __restrict__ bp, float* __restrict__ dexit, int32_t* __restrict__ ebits,
    float* __restrict__ dmax, int bk, int nb, int b) {{
  int32_t E = 0b10;
  const int32_t* p = pair2 + b;
""" + _RING_LOOP_HEAD + r"""#pragma unroll
    for (int w = 0; w < RING_R / ROW_TILE; ++w) {{
      const int kw = k0 + w * ROW_TILE;
      if (kw < bk) {{
        int32_t word = 0;
#pragma unroll
        for (int r = 0; r < ROW_TILE; ++r) {{
          const float* t = s_tab + 4 * q[w * ROW_TILE + r];
          const float a0 = d0 + t[0];
          const float a1 = d1 + t[2];
          const float b0 = d0 + t[1];
          const float b1 = d1 + t[3];
          const int32_t bp0 = a1 > a0;
          const int32_t bp1 = b1 > b0;
          d0 = fmaxf(a0, a1);
          d1 = fmaxf(b0, b1);
          if (WANT_BP) {{
            word |= (bp0 | (bp1 << 1)) << (2 * r);
            E = ((E >> bp0) & 1) | (((E >> bp1) & 1) << 1);
          }}
          if (WANT_DMAX) dmax[(size_t)(kw + r) * nb + b] = fmaxf(d0, d1);
        }}
        if (WANT_BP) bp[(size_t)(kw / ROW_TILE) * nb + b] = word;
      }}
    }}
  }}
  dexit[b] = d0;
  dexit[(size_t)nb + b] = d1;
  if (WANT_BP) ebits[b] = E;
}}

"""

# B14 as it ran before the read-ahead: one load a step, the loop unrolled
# twice, each step's table row read inside the chain.
STEP1_DENSE_KERNEL = r"""template <int K>
__global__ void __launch_bounds__(THREADS)
dense_backpointers_kernel(const int32_t* __restrict__ steps, const float* __restrict__ v_enter,
                          const float* __restrict__ logAT, const float* __restrict__ logB,
                          int32_t* __restrict__ bp, float* __restrict__ dexit,
                          int32_t* __restrict__ ftab, int bk, int nb, int S) {
  extern __shared__ float s_M[];
  load_step_table<K>(s_M, logAT, logB, S);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float d[K];
#pragma unroll
  for (int m = 0; m < K; ++m) d[m] = v_enter[(size_t)m * nb + b];
  uint32_t E = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) E |= (uint32_t)j << (3 * j);
  const int32_t* p = steps + b;
#pragma unroll 2
  for (int k = 0; k < bk; ++k) {
    const int sym = min(__ldg(p + (size_t)k * nb), S);
    const float* Ms = s_M + sym * (K * K + 1);
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
    bp[(size_t)k * nb + b] = (int32_t)word;
  }
#pragma unroll
  for (int m = 0; m < K; ++m) dexit[(size_t)m * nb + b] = d[m];
  ftab[b] = (int32_t)E;
}

"""

RING_DENSE_KERNEL = _RING_ISSUE + r"""template <int K>
__global__ void __launch_bounds__(THREADS)
dense_backpointers_kernel(const int32_t* __restrict__ steps, const float* __restrict__ v_enter,
                          const float* __restrict__ logAT, const float* __restrict__ logB,
                          int32_t* __restrict__ bp, float* __restrict__ dexit,
                          int32_t* __restrict__ ftab, int bk, int nb, int S) {{
  constexpr int TT = K * K <= 4 ? 8 : 1;
  extern __shared__ float s_M[];
  load_step_table<K>(s_M, logAT, logB, S);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  float d[K];
#pragma unroll
  for (int m = 0; m < K; ++m) d[m] = v_enter[(size_t)m * nb + b];
  uint32_t E = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) E |= (uint32_t)j << (3 * j);
  const int32_t* p = steps + b;
""" + _RING_LOOP_HEAD + r"""#pragma unroll
    for (int h = 0; h < RING_R; h += TT)
      if (k0 + h < bk)
        dense_tile<K, TT>(q + h, s_M, S, d, E, bp + (size_t)(k0 + h) * nb + b, nb,
                          bk - (k0 + h));
  }}
#pragma unroll
  for (int m = 0; m < K; ++m) dexit[(size_t)m * nb + b] = d[m];
  ftab[b] = (int32_t)E;
}}

"""

# Blocks of 64 threads for the backpointer kernels alone (B1, B3, B13 and
# B15 keep 128).
_OH_THREADS64 = [
    ("template <bool WANT_DMAX, bool STACKED>\n__global__ void __launch_bounds__(THREADS)\n"
     "oh_backpointers_kernel",
     "template <bool WANT_DMAX, bool STACKED>\n__global__ void __launch_bounds__(64)\n"
     "oh_backpointers_kernel"),
    ("      <<<grid_for(nb, M), THREADS, 0, (cudaStream_t)stream>>>(\n"
     "          (const int32_t*)pair2, (const float*)v_red",
     "      <<<dim3((unsigned)((nb + 63) / 64), (unsigned)M), 64, 0, (cudaStream_t)stream>>>(\n"
     "          (const int32_t*)pair2, (const float*)v_red")]
_DENSE_THREADS64 = [
    ("template <int K>\n__global__ void __launch_bounds__(THREADS)\ndense_backpointers_kernel",
     "template <int K>\n__global__ void __launch_bounds__(64)\ndense_backpointers_kernel"),
    ("dense_backpointers_kernel<K><<<grid_for(nb), THREADS, smem, stream>>>(",
     "dense_backpointers_kernel<K><<<(unsigned)((nb + 63) / 64), 64, smem, stream>>>(")]


# B1 / B26 and B3 / B28 (csrc/viterbi_onehot.cu): the regions their
# kernels and launchers span, and the layouts measured against the shipped
# ones (a row of the product a thread; the walk in segments).
_PROD_REGION = ("// B1: replaces cpgisland_tpu/ops/viterbi_onehot.py::_oh_products_kernel;",
                "// B3: replaces _oh_backtrace_kernel;")
_PROD_ROWS_REGION = (_PROD_REGION[0], "// B1 / B26 past the rows' limits")
# The rows at every lane count (the shipped build takes one thread a lane
# past PROD_ROWS_MAX_LANES lanes, or PROD_ROWS_MAX_STACKED lanes x members).
_ROWS_ONLY = [("#define PROD_ROWS_MAX_LANES 49152", "#define PROD_ROWS_MAX_LANES 0x7fffffff"),
              ("#define PROD_ROWS_MAX_STACKED 32768", "#define PROD_ROWS_MAX_STACKED 0x7fffffff")]
_PROD_LAUNCH = ("template <bool STACKED>\nstatic int products(",
                "template <bool WANT_DMAX, bool STACKED>\nstatic int backpointers(")
_BT_KERNEL = ("template <bool STACKED>\n__global__ void __launch_bounds__(32 * BT_MAX_SEG)\n"
              "oh_backtrace_kernel", "static inline dim3 grid_for")
_BT_LAUNCH = ("template <bool STACKED>\nstatic int backtrace(", "// The C interface:")

# B1 / B26 one thread a lane carrying all four entries: as the parent ran
# it (8 steps loaded, then run), or with the pair stream read BP_AHEAD
# steps ahead as the shipped rows are.
_PROD_LANE_HEAD = r"""// B1: one thread a lane, the four entries of its product.
template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
oh_products_kernel(const int32_t* __restrict__ pair2, const float* __restrict__ tab,
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
"""
_PROD_LANE_STEP = r"""      const float* t = s_tab + 4 * q[{i}];
      const float a00 = t[0], a01 = t[1], a10 = t[2], a11 = t[3];
      const float n00 = fmaxf(c00 + a00, c01 + a10);
      const float n01 = fmaxf(c00 + a01, c01 + a11);
      const float n10 = fmaxf(c10 + a00, c11 + a10);
      const float n11 = fmaxf(c10 + a01, c11 + a11);
      c00 = n00; c01 = n01; c10 = n10; c11 = n11;
"""
_PROD_LANE_TAIL = r"""  float* o = out + (size_t)m * 4 * nb;
  o[b] = c00;
  o[(size_t)nb + b] = c01;
  o[2 * (size_t)nb + b] = c10;
  o[3 * (size_t)nb + b] = c11;
}

"""
PROD_PARENT_KERNEL = _PROD_LANE_HEAD + r"""  for (int k0 = 0; k0 < bk; k0 += ROW_TILE) {
    int q[ROW_TILE];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) q[r] = __ldg(p + (size_t)(k0 + r) * nb);
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r) {
""" + _PROD_LANE_STEP.format(i="r") + "    }\n  }\n" + _PROD_LANE_TAIL
PROD_LANE_AHEAD_KERNEL = _PROD_LANE_HEAD + r"""  int q[BP_AHEAD], qn[BP_AHEAD];
  load_pairs(p, nb, 0, bk, q);
  for (int k0 = 0; k0 < bk; k0 += BP_AHEAD) {
    load_pairs(p, nb, k0 + BP_AHEAD, bk, qn);
#pragma unroll
    for (int r = 0; r < BP_AHEAD; ++r) {
      if (k0 + r < bk) {
""" + _PROD_LANE_STEP.format(i="r") + r"""      }
    }
#pragma unroll
    for (int r = 0; r < BP_AHEAD; ++r) q[r] = qn[r];
  }
""" + _PROD_LANE_TAIL
PROD_LANE_LAUNCH = r"""template <bool STACKED>
static int products(const void* pair2, const void* tab, void* out, int bk, int nb, int nP,
                    int M, void* stream) {
  if (bad_args(bk, nb, nP, M)) return (int)cudaErrorInvalidValue;
  oh_products_kernel<STACKED><<<grid_for(nb, M), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pair2, (const float*)tab, (float*)out, bk, nb, nP);
  return (int)cudaGetLastError();
}

"""

# B3 / B28 as the parent ran them: one thread walks a whole lane, each
# word's pointers and 8 pairs loaded, then its steps run.
BT_PARENT_KERNEL = r"""template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
oh_backtrace_kernel(const int32_t* __restrict__ bp, const int32_t* __restrict__ pair2,
                    const int32_t* __restrict__ idtab, const int32_t* __restrict__ exit_bits,
                    int32_t* __restrict__ path, int bk, int nb, int nP) {
  __shared__ int32_t s_id[MAX_PAIRS * 2];
  const int m = STACKED ? blockIdx.y : 0;
  const int32_t* idtab_m = idtab + (size_t)m * nP * 2;
  for (int i = threadIdx.x; i < nP * 2; i += blockDim.x) s_id[i] = idtab_m[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int32_t* bp_m = bp + (size_t)m * (bk / ROW_TILE) * nb;
  int32_t* path_m = path + (size_t)m * bk * nb;
  int32_t bit = exit_bits[(size_t)m * nb + b];
  for (int w = bk / ROW_TILE - 1; w >= 0; --w) {
    const int32_t word = __ldg(bp_m + (size_t)w * nb + b);
    int q[ROW_TILE];
#pragma unroll
    for (int r = 0; r < ROW_TILE; ++r)
      q[r] = __ldg(pair2 + (size_t)(w * ROW_TILE + r) * nb + b);
#pragma unroll
    for (int r = ROW_TILE - 1; r >= 0; --r) {
      path_m[(size_t)(w * ROW_TILE + r) * nb + b] = s_id[2 * q[r] + bit];
      bit = (word >> (2 * r + bit)) & 1;
    }
  }
}

"""
BT_PARENT_LAUNCH = r"""template <bool STACKED>
static int backtrace(const void* bp, const void* pair2, const void* idtab,
                     const void* exit_bits, void* path, int bk, int nb, int nP, int M, int seg,
                     void* stream) {
  if (bad_args(bk, nb, nP, M)) return (int)cudaErrorInvalidValue;
  oh_backtrace_kernel<STACKED><<<grid_for(nb, M), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bp, (const int32_t*)pair2, (const int32_t*)idtab,
      (const int32_t*)exit_bits, (int32_t*)path, bk, nb, nP);
  return (int)cudaGetLastError();
}

"""

# The walk with each word's 8 bits resolved for both entering bits off the
# chain (they depend on the word only): the chain then does one select a
# word, at twice the bit operations.
_BT_WORD_WALK = r"""#pragma unroll
        for (int r = ROW_TILE - 1; r >= 0; --r) {
          out[(size_t)(kw + r) * nb] = s_id[2 * q[u * ROW_TILE + r] + bit];
          bit = (wq[u] >> (2 * r + bit)) & 1;
        }
"""
BT_RESOLVED_WALK = r"""        int32_t c0 = 0, c1 = 1, m0 = 0, m1 = 0;
#pragma unroll
        for (int r = ROW_TILE - 1; r >= 0; --r) {
          m0 |= c0 << r;
          m1 |= c1 << r;
          c0 = (wq[u] >> (2 * r + c0)) & 1;
          c1 = (wq[u] >> (2 * r + c1)) & 1;
        }
        const int32_t mk = bit ? m1 : m0;
#pragma unroll
        for (int r = ROW_TILE - 1; r >= 0; --r)
          out[(size_t)(kw + r) * nb] = s_id[2 * q[u * ROW_TILE + r] + ((mk >> r) & 1)];
        bit = bit ? c1 : c0;
"""

# The segments on a (lane block, segment, member) grid in two launches: the
# maps pass writes every segment's map to device memory, then the walk
# composes the maps above its segment from there (B7's (lane block,
# sub-lane) grid).
BT_GRID2_KERNEL = r"""__device__ uint8_t g_bt_maps[1 << 22];

template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
oh_bt_maps_kernel(const int32_t* __restrict__ bp, int bk, int nb, int seg) {
  const int G = gridDim.y, s = blockIdx.y, m = STACKED ? blockIdx.z : 0;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb || s == 0) return;
  const int nw = bk / ROW_TILE;
  const int lo = min(s * seg, nw), hi = min(lo + seg, nw);
  const int32_t* wp = bp + (size_t)m * nw * nb + b;
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
  g_bt_maps[((size_t)m * G + s) * nb + b] = (uint8_t)(f0 | (f1 << 1));
}

template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
oh_backtrace_kernel(const int32_t* __restrict__ bp, const int32_t* __restrict__ pair2,
                    const int32_t* __restrict__ idtab, const int32_t* __restrict__ exit_bits,
                    int32_t* __restrict__ path, int bk, int nb, int nP, int seg) {
  __shared__ int32_t s_id[MAX_PAIRS * 2];
  const int G = gridDim.y, s = blockIdx.y, m = STACKED ? blockIdx.z : 0;
  const int32_t* idtab_m = idtab + (size_t)m * nP * 2;
  for (int i = threadIdx.x; i < nP * 2; i += blockDim.x) s_id[i] = idtab_m[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const int nw = bk / ROW_TILE;
  const int lo = min(s * seg, nw), hi = min(lo + seg, nw);
  const int32_t* wp = bp + (size_t)m * nw * nb + b;
  int32_t bit = exit_bits[(size_t)m * nb + b];
  for (int t = G - 1; t > s; --t) bit = (g_bt_maps[((size_t)m * G + t) * nb + b] >> bit) & 1;
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
""" + _BT_WORD_WALK + r"""      }
    }
#pragma unroll
    for (int r = 0; r < BT_AHEAD; ++r) q[r] = qn[r];
#pragma unroll
    for (int u = 0; u < BT_AHEAD / ROW_TILE; ++u) wq[u] = wqn[u];
  }
}

"""
BT_GRID2_LAUNCH = r"""template <bool STACKED>
static int backtrace(const void* bp, const void* pair2, const void* idtab,
                     const void* exit_bits, void* path, int bk, int nb, int nP, int M, int seg,
                     void* stream) {
  if (bad_args(bk, nb, nP, M) || seg < 0) return (int)cudaErrorInvalidValue;
  const int nw = bk / ROW_TILE, need = (nw + BT_MAX_SEG - 1) / BT_MAX_SEG;
  if (seg == 0) seg = BT_SEG;
  if (seg < need) seg = need;
  const int G = nw > seg ? (nw + seg - 1) / seg : 1;
  if ((size_t)M * G * nb > (1u << 22)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nb + THREADS - 1) / THREADS), (unsigned)G, (unsigned)M);
  oh_bt_maps_kernel<STACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bp, bk, nb, seg);
  oh_backtrace_kernel<STACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bp, (const int32_t*)pair2, (const int32_t*)idtab,
      (const int32_t*)exit_bits, (int32_t*)path, bk, nb, nP, seg);
  return (int)cudaGetLastError();
}

"""

# B26 with the member on the grid's x axis and the lane block on y (B28's
# layout), and B28 with the member on y (B26's): blocks are dispatched x
# first, so with the member on x the M members' blocks of one lane block
# run side by side and read the shared pair stream together.
# B12 as the parent ran it: one thread per (lane, segment of Tt steps) in
# blocks of 128 lanes of one segment, a step's loads issued when it runs,
# two IEEE divisions a step, no block sums; B5's reduce over every
# segment's partial rows.  The C entry keeps the shipped signature and
# ignores SPB.
B12_PARENT_KERNEL = r"""// B12: the chunked counts over the split arm's cs-scaled streams, in B5's
// accumulator rows (so B5's reduce kernel finishes them).  One (lane,
// segment) over steps [t0, t1): gamma rows and log c as B5; for t >= 1 the
// pair bin (s_prev, s_cur, a, c) gains a_hat_{t-1}[a] * ((B_red[s_cur, c] *
// beta_t[c]) * (1 / c_t)), the twin's operand order.

__device__ __forceinline__ void cs_stats_segment(const float* al, const float* be,
                                                 const int32_t* p, const float* s_bred,
                                                 float* my, int bd, int t0, int t1, size_t nl,
                                                 int S) {
  const int nreal = S * S;
  const int EMIT = 4 * nreal;
  const int LL = EMIT + 2 * S;
  float ah0 = 0.0f, ah1 = 0.0f;
  if (t0 > 0) {
    const float p0 = al[(size_t)(2 * t0 - 2) * nl];
    const float p1 = al[(size_t)(2 * t0 - 1) * nl];
    const float ic = __fdiv_rn(1.0f, fmaxf(__fadd_rn(p0, p1), 1e-30f));
    ah0 = __fmul_rn(p0, ic);
    ah1 = __fmul_rn(p1, ic);
  }
  float ll = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const float a0 = al[(size_t)(2 * t) * nl];
    const float a1 = al[(size_t)(2 * t + 1) * nl];
    const float be0 = be[(size_t)(2 * t) * nl];
    const float be1 = be[(size_t)(2 * t + 1) * nl];
    const int pr = p[(size_t)t * nl];
    // A PAD pair carries its symbol: previous and current are both it.
    const int esym = pr < nreal ? pr % S : pr - nreal;
    const int sprev = pr < nreal ? pr / S : esym;
    const float cs = __fadd_rn(a0, a1);
    const float inv_cs = __fdiv_rn(1.0f, fmaxf(cs, 1e-30f));
    const float g0 = __fmul_rn(a0, be0), g1 = __fmul_rn(a1, be1);
    const float inv_g = __fdiv_rn(1.0f, fmaxf(__fadd_rn(g0, g1), 1e-30f));
    float* e = my + (EMIT + 2 * esym) * bd;
    e[0] = __fadd_rn(e[0], __fmul_rn(g0, inv_g));
    e[bd] = __fadd_rn(e[bd], __fmul_rn(g1, inv_g));
    ll = __fadd_rn(ll, logf(fmaxf(cs, 1e-30f)));
    if (t > 0) {
      const float w0 = __fmul_rn(__fmul_rn(s_bred[2 * esym], be0), inv_cs);
      const float w1 = __fmul_rn(__fmul_rn(s_bred[2 * esym + 1], be1), inv_cs);
      float* bin = my + ((sprev * S + esym) * 4) * bd;
      bin[0] = __fadd_rn(bin[0], __fmul_rn(ah0, w0));
      bin[bd] = __fadd_rn(bin[bd], __fmul_rn(ah0, w1));
      bin[2 * bd] = __fadd_rn(bin[2 * bd], __fmul_rn(ah1, w0));
      bin[3 * bd] = __fadd_rn(bin[3 * bd], __fmul_rn(ah1, w1));
    }
    ah0 = __fmul_rn(a0, inv_cs);
    ah1 = __fmul_rn(a1, inv_cs);
  }
  my[LL * bd] = ll;
}

// Grid (lane blocks, segments); part [nseg, R, NL].
__global__ void oh_stats_part_kernel(const float* __restrict__ alphas,
                                     const float* __restrict__ betas,
                                     const int32_t* __restrict__ pair,
                                     const int32_t* __restrict__ lens,
                                     const float* __restrict__ bred, float* __restrict__ part,
                                     int Tp, int NL, int S, int Tt) {
  extern __shared__ float acc[];  // [R][blockDim.x]
  __shared__ float s_bred[2 * MAX_S];
  const int R = 4 * S * S + 2 * S + 1;
  const int bd = blockDim.x;
  const size_t nl = (size_t)NL;
  for (int i = threadIdx.x; i < 2 * S; i += bd) s_bred[i] = bred[i];
  float* my = acc + threadIdx.x;
  for (int r = 0; r < R; ++r) my[r * bd] = 0.0f;
  __syncthreads();

  const int n = blockIdx.x * bd + threadIdx.x;
  if (n >= NL) return;
  const int seg = blockIdx.y;
  const int len = min(lens[n], Tp);
  const int t0 = seg * Tt;
  const int t1 = min(t0 + Tt, len);
  if (t0 < t1) cs_stats_segment(alphas + n, betas + n, pair + n, s_bred, my, bd, t0, t1, nl, S);
  float* out = part + (size_t)seg * R * nl + n;
  for (int r = 0; r < R; ++r) out[(size_t)r * nl] = my[r * bd];
}

"""
B12_PARENT_LAUNCH = r"""// B12: the part kernel, then B5's reduce (member 0 of 1).
static int launch_cs_stats(const void* alphas, const void* betas, const void* pair,
                           const void* lens, const void* bred, const void* gt, void* part,
                           void* macc, void* emit, void* ll, int Tp, int NL, int S, int K, int Tt,
                           cudaStream_t st) {
  if (S < 1 || S > MAX_S || K != 2 * S || Tp <= 0 || NL <= 0 || Tt <= 0)
    return (int)cudaErrorInvalidValue;
  const int R = 4 * S * S + 2 * S + 1;
  const int nseg = (Tp + Tt - 1) / Tt;
  if (nseg > 65535) return (int)cudaErrorInvalidValue;
  const int threads = (size_t)R * 128 * sizeof(float) <= 200 * 1024 ? 128 : 32;
  const size_t smem = (size_t)R * threads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        oh_stats_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((NL + threads - 1) / threads), (unsigned)nseg);
  oh_stats_part_kernel<<<grid, threads, smem, st>>>(
      (const float*)alphas, (const float*)betas, (const int32_t*)pair, (const int32_t*)lens,
      (const float*)bred, (float*)part, Tp, NL, S, Tt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((unsigned)((NL + REDUCE_THREADS - 1) / REDUCE_THREADS), (unsigned)R, 1);
  oh_seq_stats_reduce_kernel<<<rgrid, REDUCE_THREADS, 0, st>>>(
      (const float*)part, (const int32_t*)gt, (float*)macc, (float*)emit, (float*)ll, nseg, NL,
      S, K);
  return (int)cudaGetLastError();
}

"""
_B12_REDUCE = "// Grid (lane blocks, rows R, members): each lane's segments summed in order."
_B12_LAUNCH_AT = "// B5 / B25 (B12 with cs): the part kernel over"
_B12_ENTRY = ("return launch_seq_stats(true, alphas, betas, pair, lens, nullptr, bred, gt, "
              "nullptr, nullptr,\n                          nullptr, part, macc, emit, ll, Tp, NL, "
              "S, K, Tt, SPB, 1,")
B12_PARENT = [(_B12_REDUCE, B12_PARENT_KERNEL + _B12_REDUCE),
              (_B12_LAUNCH_AT, B12_PARENT_LAUNCH + _B12_LAUNCH_AT),
              (_B12_ENTRY, "return launch_cs_stats(alphas, betas, pair, lens, bred, gt, part, macc, "
                           "emit, ll, Tp, NL, S, K, Tt,")]

# B15 as the parent ran it: one thread a lane (blocks of 128) walking all
# bk steps, one load a step; the C entry keeps the shipped signature and
# ignores seg.
B15_PARENT_KERNEL = r"""template <int K>
__global__ void __launch_bounds__(THREADS)
dense_backtrace_kernel(const int32_t* __restrict__ bp, const int32_t* __restrict__ exits,
                       int32_t* __restrict__ path, int bk, int nb, int seg) {
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

"""
B15_PARENT_LAUNCH = r"""template <int K>
static int launch_backtrace(const void* bp, const void* exits, void* path, int bk, int nb,
                            int seg, cudaStream_t stream) {
  dense_backtrace_kernel<K><<<grid_for(nb), THREADS, 0, stream>>>(
      (const int32_t*)bp, (const int32_t*)exits, (int32_t*)path, bk, nb, seg);
  return (int)cudaGetLastError();
}

"""
_B15_KERNEL = ("template <int K>\n__global__ void __launch_bounds__(DBT_LANES * DBT_MAX_SEG)\n"
               "dense_backtrace_kernel", "static inline unsigned grid_for(int nb)")
_B15_LAUNCH = ("template <int K>\nstatic int launch_backtrace(", "#define DISPATCH_K(K, CALL)")
B15_PARENT = [(*_B15_KERNEL, B15_PARENT_KERNEL), (*_B15_LAUNCH, B15_PARENT_LAUNCH)]

# B15 with at most DBT_GRID blocks, each walking lane blocks b, b + DBT_GRID,
# ...: fewer blocks in flight, so the words phase 1 read may still be in L2
# when phase 2 reads them again (a lane block's words are 512 KB at 4,096
# steps).  The operations and their order are the shipped kernel's.
B15_PERSIST_KERNEL = r"""template <int K>
__global__ void __launch_bounds__(DBT_LANES * DBT_MAX_SEG)
dense_backtrace_kernel(const int32_t* __restrict__ bp, const int32_t* __restrict__ exits,
                       int32_t* __restrict__ path, int bk, int nb, int seg) {
  __shared__ uint32_t s_map[DBT_MAX_SEG * DBT_LANES];
  const int G = blockDim.x / DBT_LANES, s = threadIdx.x / DBT_LANES, l = threadIdx.x % DBT_LANES;
  const int lo = s * seg, hi = min(lo + seg, bk);
  const int nblk = (nb + DBT_LANES - 1) / DBT_LANES;
  for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {
    const int b = blk * DBT_LANES + l;
    const int32_t* wp = bp + b;
    int32_t w[DBT_AHEAD], wn[DBT_AHEAD];
    if (s > 0 && b < nb) {
      uint32_t f[K];
#pragma unroll
      for (int j = 0; j < K; ++j) f[j] = j;
      load_back_words(wp, nb, hi - DBT_AHEAD, lo, w);
      for (int k0 = hi - DBT_AHEAD; k0 + DBT_AHEAD > lo; k0 -= DBT_AHEAD) {
        load_back_words(wp, nb, k0 - DBT_AHEAD, lo, wn);
#pragma unroll
        for (int u = DBT_AHEAD - 1; u >= 0; --u) {
#pragma unroll
          for (int j = 0; j < K; ++j) f[j] = ((uint32_t)w[u] >> (3 * f[j])) & 7u;
        }
#pragma unroll
        for (int u = 0; u < DBT_AHEAD; ++u) w[u] = wn[u];
      }
      uint32_t map = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) map |= f[j] << (3 * j);
      s_map[s * DBT_LANES + l] = map;
    }
    __syncthreads();
    if (b < nb) {
      uint32_t state = (uint32_t)exits[b];
      for (int t = G - 1; t > s; --t) state = (s_map[t * DBT_LANES + l] >> (3 * state)) & 7u;
      int32_t* out = path + b;
      load_back_words(wp, nb, hi - DBT_AHEAD, lo, w);
      for (int k0 = hi - DBT_AHEAD; k0 + DBT_AHEAD > lo; k0 -= DBT_AHEAD) {
        load_back_words(wp, nb, k0 - DBT_AHEAD, lo, wn);
#pragma unroll
        for (int u = DBT_AHEAD - 1; u >= 0; --u) {
          if (k0 + u >= lo) {
            out[(size_t)(k0 + u) * nb] = (int32_t)state;
            state = ((uint32_t)w[u] >> (3 * state)) & 7u;
          }
        }
#pragma unroll
        for (int u = 0; u < DBT_AHEAD; ++u) w[u] = wn[u];
      }
    }
    __syncthreads();
  }
}

"""
_B15_GRID = ("dense_backtrace_kernel<K><<<(unsigned)((nb + DBT_LANES - 1) / DBT_LANES),",
             "dense_backtrace_kernel<K><<<(unsigned)min((nb + DBT_LANES - 1) / DBT_LANES, "
             "DBT_GRID),")


def _persist(blocks: int) -> list:
    return [(*_B15_KERNEL, B15_PERSIST_KERNEL), _B15_GRID,
            ("#define DBT_AHEAD 16", f"#define DBT_AHEAD 16\n#define DBT_GRID {blocks}")]

def _swap(*pairs):
    def fn(text: str) -> str:
        for a, b in pairs:
            if a not in text:
                raise RuntimeError(f"{a!r} not in the span")
            text = text.replace(a, b)
        return text
    return fn


_M_X = ("const int m = STACKED ? blockIdx.y : 0;", "const int m = STACKED ? blockIdx.x : 0;")
PROD_MEMBER_X = [
    *_ROWS_ONLY,
    (*_PROD_ROWS_REGION, _swap(_M_X, ("const int b = blockIdx.x * (PROD_THREADS / 2)",
                                 "const int b = (STACKED ? blockIdx.y : blockIdx.x) * "
                                 "(PROD_THREADS / 2)"))),
    (*_PROD_LAUNCH, _swap(("dim3(((unsigned)nb + lanes - 1) / lanes, (unsigned)M)",
                           "STACKED ? dim3((unsigned)M, ((unsigned)nb + lanes - 1) / lanes)\n"
                           "                 : dim3(((unsigned)nb + lanes - 1) / lanes)")))]
BT_MEMBER_Y = [
    (*_BT_KERNEL, _swap(_M_X[::-1], ("const int b = (STACKED ? blockIdx.y : blockIdx.x) * 32 + l;",
                                     "const int b = blockIdx.x * 32 + l;"))),
    (*_BT_LAUNCH, _swap(("STACKED ? dim3((unsigned)M, blocks) : dim3(blocks)",
                         "dim3(blocks, (unsigned)M)")))]

# B1 / B26 with at least 10 blocks an SM (48 registers: at M = 5 on 16,384
# lanes the rows' 1,280 blocks then fit one wave), and with the two rows of
# a lane a warp apart (warp w runs row w % 2 of 32 lanes, so each warp's
# loads and stores are whole 128-byte rows, and the two rows' loads of one
# pair meet in L1).
_PROD_MIN10 = ("__global__ void __launch_bounds__(PROD_THREADS)\noh_products_kernel",
               "__global__ void __launch_bounds__(PROD_THREADS, 10)\noh_products_kernel")
_PROD_WARP_ROWS = ("  const int i = threadIdx.x % 2;\n"
                   "  const int b = blockIdx.x * (PROD_THREADS / 2) + threadIdx.x / 2;",
                   "  const int w = threadIdx.x / 32, i = w % 2;\n"
                   "  const int b = blockIdx.x * (PROD_THREADS / 2) + (w / 2) * 32 + "
                   "threadIdx.x % 32;")

# Diagnostics of the segmented walk, not checked: its loads replaced by
# words and pairs made from the step and the lane (no memory read), or its
# stores (and their table lookups) dropped behind a test no pair passes.
_BT_NOLOAD = [
    ("    wd[u] = w >= lo ? __ldg(wp + (size_t)w * nb) : (int32_t)0xAAAAAAAAu;",
     "    wd[u] = w >= lo ? (int32_t)((w * 0x9E3779B1u) ^ ((size_t)wp >> 2)) : "
     "(int32_t)0xAAAAAAAAu;"),
    ("    wd[u] = in ? __ldg(wp + (size_t)(kw / ROW_TILE) * nb) : 0;",
     "    wd[u] = in ? (int32_t)((kw * 0x9E3779B1u) ^ ((size_t)wp >> 2)) : 0;"),
    ("      q[u * ROW_TILE + r] = in ? __ldg(pp + (size_t)(kw + r) * nb) : 0;",
     "      q[u * ROW_TILE + r] = in ? (int)(((kw + r) * 5 + ((size_t)pp >> 2)) & 15) : 0;")]
_BT_NOSTORE = [("          out[(size_t)(kw + r) * nb] = s_id[2 * q[u * ROW_TILE + r] + bit];",
                "          if (q[u * ROW_TILE + r] < 0)\n"
                "            out[(size_t)(kw + r) * nb] = s_id[2 * q[u * ROW_TILE + r] + bit];")]


def _ring(body: str, region, R: int, D: int, T: int = 128) -> list:
    """The ring design in ``region``: RING_R steps a stage, RING_D stages,
    blocks of RING_T threads."""
    return [(*region, body.format(R=R, D=D, T=T))]


# Diagnostics, not checked: the shipped chains with their loads replaced by
# pairs / symbols made from the step and the lane (no memory read), so the
# chain's own pace shows.
_NOLOAD = "    q[r] = k < bk ? __ldg(p + (size_t)k * nb) : 0;"
_OH_NOLOAD = (_NOLOAD, "    q[r] = (int)((k * 5 + ((size_t)p >> 2)) & 15);")
_DENSE_NOLOAD = (_NOLOAD, "    q[r] = (int)((k * 5 + ((size_t)p >> 2)) & 3);")

# The forward chains' alpha stores (B4 / B9 / T2's fwd_range, T3's
# comp_range) behind a test no lane passes: the chains run, nothing is written.
_NOSTORE_FWD = ("        out[(size_t)(2 * t) * nl] = v0;\n        out[(size_t)(2 * t + 1) * nl] = v1;\n",
                "        if (len < 0) {\n          out[(size_t)(2 * t) * nl] = v0;\n"
                "          out[(size_t)(2 * t + 1) * nl] = v1;\n        }\n")
_COMP_STORES = ("        out[(size_t)(2 * t) * nl] = i0;\n        out[(size_t)(2 * t + 1) * nl] = i1;\n"
                "        out[(size_t)(2 * t + 2) * nl] = v0;\n        out[(size_t)(2 * t + 3) * nl] = v1;\n")
_NOSTORE_COMP = (_COMP_STORES, "        if (len < 0) {\n" + _COMP_STORES + "        }\n")
# name -> (source stem, replacements); a replacement of three strings
# replaces the source from its first up to its second with its third (or
# with what its third, a function, makes of that span).
VARIANTS = {
    "dense/base": ("fb_dense", []),
    "dense/threads64": ("fb_dense", [("#define CHAIN_THREADS 32", "#define CHAIN_THREADS 64")]),
    "dense/threads128": ("fb_dense", [("#define CHAIN_THREADS 32", "#define CHAIN_THREADS 128")]),
    "dense/lookahead16": ("fb_dense", [("#define LOOKAHEAD 8", "#define LOOKAHEAD 16")]),
    "dense/frcp": ("fb_dense", [("__fdiv_rn(1.0f, seq_sum<K>(v))", "__frcp_rn(seq_sum<K>(v))"),
                                ("__fdiv_rn(1.0f, c)", "__frcp_rn(c)")]),
    "split/base": ("fb_dense", []),
    "split/threads32": ("fb_dense", [(_THREADS, "#define SPLIT_THREADS 32")]),
    "split/threads64": ("fb_dense", [(_THREADS, "#define SPLIT_THREADS 64")]),
    "split/threads256": ("fb_dense", [(_THREADS, "#define SPLIT_THREADS 256")]),
    "split/spt2": ("fb_dense", _spt_variant(2)),
    "split/spt4": ("fb_dense", _spt_variant(4)),
    "split/frcp": ("fb_dense", [("__fdiv_rn(1.0f, sum)", "__frcp_rn(sum)"),
                                ("__fdiv_rn(1.0f, cm)", "__frcp_rn(cm)")]),
    "split/branch_store": ("fb_dense", [(
        '  asm volatile("{\\n\\t.reg .pred q;\\n\\tsetp.ne.u32 q, %2, 0;\\n\\t@q st.global.f32 [%0], '
        '%1;\\n\\t}"\n               ::"l"(p), "f"(v), "r"((unsigned)on));', "  if (on) *p = v;")]),
    "split/simple": ("fb_dense", [
        (_B20, SIMPLE_KERNELS + "\n" + _B20),
        (_FWD_LAUNCH, _FWD_LAUNCH.replace("split", "simple")),
        (_BWD_LAUNCH, _BWD_LAUNCH.replace("split", "simple"))]),
    "split/warp": ("fb_dense", [
        (_B20, WARP_KERNELS + "\n" + _B20),
        (_FWD_LAUNCH, "  fb_fwd_warp_kernel<K><<<blocks_for(NL, 32), K * 32, 0, st>>>("),
        (_BWD_LAUNCH, "  fb_bwd_warp_kernel<K><<<blocks_for(NL, 32), K * 32, 0, st>>>(")]),
    "split/stage": ("fb_dense", [
        (_B20, STAGE_KERNELS + "\n" + _B20),
        (_FWD_LAUNCH, "  fb_fwd_stage_kernel<K><<<blocks_for(NL * SPLIT_KP, 256), 256, 0, st>>>("),
        (_BWD_LAUNCH, "  fb_bwd_stage_kernel<K><<<blocks_for(NL * SPLIT_KP, 256), 256, 0, st>>>(")]),
    "split/one_thread": ("fb_dense", _ONE_THREAD),
    "split/conf_step": ("fb_dense", _CONF_STEP),
    "split/diag_nostore": ("fb_dense", [(_STORE_IF, '"r"(0u)')]),
    "stats/base": ("fb_onehot", []),
    "stats/lanes128": ("fb_onehot", [("#define STATS_LANES 32", "#define STATS_LANES 128")]),
    "stats/ahead4": ("fb_onehot", [("#define STATS_AHEAD 8", "#define STATS_AHEAD 4")]),
    "stats/ahead12": ("fb_onehot", [("#define STATS_AHEAD 8", "#define STATS_AHEAD 12")]),
    "stats/ahead16": ("fb_onehot", [("#define STATS_AHEAD 8", "#define STATS_AHEAD 16")]),
    "stats/fdiv": ("fb_onehot", [("__frcp_rn(", "__fdiv_rn(1.0f, ")]),
    "stats/diag_nolog": ("fb_onehot", [("logf(fmaxf(cs, 1e-30f))", "fmaxf(cs, 1e-30f)")]),
    "stats/b12_parent": ("fb_onehot", B12_PARENT),
    "stats/diag_loads": ("fb_onehot", [(
        "stats_step<false, CS>(q.a0[r], q.a1[r], q.b0[r], q.b1[r], q.d[r], ah0, ah1, ll, my,\n"
        "                              bd, s_tab, s_bred, s_igt, enters_full, enters_red, pair0, nl, S,\n"
        "                              K);",
        "ll = __fadd_rn(ll, q.a0[r] + q.a1[r] + q.b0[r] + q.b1[r] + (float)q.d[r]);")]),
    "decode/oh_base": ("viterbi_onehot", []),
    "decode/oh_tile8": ("viterbi_onehot", [(*_OH_REGION, TILE8_OH_BODY)]),
    "decode/oh_rows_first": ("viterbi_onehot", [(*_OH_REGION, ROWS_FIRST_OH_BODY)]),
    "decode/oh_ahead8": ("viterbi_onehot", [("#define BP_AHEAD 16", "#define BP_AHEAD 8")]),
    "decode/oh_ahead32": ("viterbi_onehot", [("#define BP_AHEAD 16", "#define BP_AHEAD 32")]),
    "decode/oh_ring16x5": ("viterbi_onehot", _ring(RING_OH_BODY, _OH_REGION, 16, 5)),
    "decode/oh_threads64": ("viterbi_onehot", _OH_THREADS64),
    "decode/oh_diag_noload": ("viterbi_onehot", [_OH_NOLOAD]),
    "decode/prod_parent": ("viterbi_onehot", [(*_PROD_REGION, PROD_PARENT_KERNEL),
                                              (*_PROD_LAUNCH, PROD_LANE_LAUNCH)]),
    "decode/prod_lane_ahead": ("viterbi_onehot", [(*_PROD_REGION, PROD_LANE_AHEAD_KERNEL),
                                                  (*_PROD_LAUNCH, PROD_LANE_LAUNCH)]),
    "decode/prod_rows": ("viterbi_onehot", _ROWS_ONLY),
    "decode/prod_threads64": ("viterbi_onehot", [*_ROWS_ONLY, ("#define PROD_THREADS 128",
                                                               "#define PROD_THREADS 64")]),
    "decode/prod_threads256": ("viterbi_onehot", [*_ROWS_ONLY, ("#define PROD_THREADS 128",
                                                                "#define PROD_THREADS 256")]),
    "decode/bt_parent": ("viterbi_onehot", [(*_BT_KERNEL, BT_PARENT_KERNEL),
                                            (*_BT_LAUNCH, BT_PARENT_LAUNCH)]),
    "decode/bt_ahead8": ("viterbi_onehot", [("#define BT_AHEAD 16", "#define BT_AHEAD 8")]),
    "decode/bt_ahead32": ("viterbi_onehot", [("#define BT_AHEAD 16", "#define BT_AHEAD 32")]),
    "decode/bt_max16": ("viterbi_onehot", [("#define BT_MAX_SEG 32", "#define BT_MAX_SEG 16")]),
    "decode/bt_member_y": ("viterbi_onehot", BT_MEMBER_Y),
    "decode/prod_member_x": ("viterbi_onehot", PROD_MEMBER_X),
    "decode/prod_min10": ("viterbi_onehot", [*_ROWS_ONLY, _PROD_MIN10]),
    "decode/prod_warp_rows": ("viterbi_onehot", [*_ROWS_ONLY, _PROD_WARP_ROWS]),
    "decode/bt_resolved": ("viterbi_onehot", [(_BT_WORD_WALK, BT_RESOLVED_WALK)]),
    "decode/bt_grid2": ("viterbi_onehot", [(*_BT_KERNEL, BT_GRID2_KERNEL),
                                           (*_BT_LAUNCH, BT_GRID2_LAUNCH)]),
    "decode/bt_diag_noload": ("viterbi_onehot", _BT_NOLOAD),
    "decode/bt_diag_nostore": ("viterbi_onehot", _BT_NOSTORE),
    "decode/dense_base": ("viterbi_dense", []),
    "decode/dense_step1": ("viterbi_dense", [(*_DENSE_REGION, STEP1_DENSE_KERNEL)]),
    "decode/dense_rows_inline": ("viterbi_dense", [("constexpr int TT = K * K <= 4 ? 8 : 1;",
                                                    "constexpr int TT = 1;")]),
    "decode/dense_ahead8": ("viterbi_dense", [("#define STEP_AHEAD 16", "#define STEP_AHEAD 8")]),
    "decode/dense_ahead32": ("viterbi_dense", [("#define STEP_AHEAD 16",
                                                "#define STEP_AHEAD 32")]),
    "decode/dense_ring16x5": ("viterbi_dense", _ring(RING_DENSE_KERNEL, _DENSE_REGION, 16, 5)),
    "decode/dense_threads64": ("viterbi_dense", _DENSE_THREADS64),
    "decode/dense_diag_noload": ("viterbi_dense", [_DENSE_NOLOAD]),
    "decode/dense_prod_parent": ("viterbi_dense", [(*_B13_REGION, B13_PARENT_KERNEL),
                                                   (*_B13_LAUNCH, B13_PARENT_LAUNCH)]),
    "decode/dense_prod_lane": ("viterbi_dense", [(_B13_ROWS_MAX + "8192",
                                                  _B13_ROWS_MAX + "0")]),
    "decode/dense_prod_rows": ("viterbi_dense", [(_B13_ROWS_MAX + "8192",
                                                  _B13_ROWS_MAX + "0x7fffffff")]),
    "decode/dense_prod_lane_ahead4": ("viterbi_dense", [
        (_B13_ROWS_MAX + "8192", _B13_ROWS_MAX + "0"), (_B13_LANE_AHEAD, _B13_LANE_AHEAD[:-2] + "4)")]),
    "decode/dense_prod_lane_ahead8": ("viterbi_dense", [
        (_B13_ROWS_MAX + "8192", _B13_ROWS_MAX + "0"), (_B13_LANE_AHEAD, _B13_LANE_AHEAD[:-2] + "8)")]),
    "decode/dense_prod_rows2": ("viterbi_dense", [("launch_products_r<K, 1>(",
                                                   "launch_products_r<K, (K >= 4 ? 2 : 1)>(")]),
    "decode/dense_prod_scalar": ("viterbi_dense", [_B13_STRIDE, _B13_FLOAT4]),
    "decode/dense_prod_threads64": ("viterbi_dense", [("#define PROD_THREADS 128",
                                                       "#define PROD_THREADS 64")]),
    "decode/dense_prod_threads256": ("viterbi_dense", [("#define PROD_THREADS 128",
                                                        "#define PROD_THREADS 256")]),
    "decode/dense_prod_ahead16": ("viterbi_dense", [(_B13_AHEAD, "#define PROD_AHEAD(KK) 16")]),
    "decode/dense_prod_ahead8": ("viterbi_dense", [(_B13_AHEAD, "#define PROD_AHEAD(KK) 8")]),
    "decode/dbt_parent": ("viterbi_dense", B15_PARENT),
    "decode/dbt_ahead8": ("viterbi_dense", [("#define DBT_AHEAD 16", "#define DBT_AHEAD 8")]),
    "decode/dbt_ahead32": ("viterbi_dense", [("#define DBT_AHEAD 16", "#define DBT_AHEAD 32")]),
    "decode/dbt_lanes16": ("viterbi_dense", [("#define DBT_LANES 32", "#define DBT_LANES 16")]),
    "decode/dbt_lanes16_seg64": ("viterbi_dense", [("#define DBT_LANES 32", "#define DBT_LANES 16"),
                                                   ("#define DBT_MAX_SEG 32",
                                                    "#define DBT_MAX_SEG 64"),
                                                   ("#define DBT_SEG 128", "#define DBT_SEG 64")]),
    "decode/dbt_lanes8": ("viterbi_dense", [("#define DBT_LANES 32", "#define DBT_LANES 8")]),
    "decode/dbt_grid48": ("viterbi_dense", _persist(48)),
    "decode/dbt_grid80": ("viterbi_dense", _persist(80)),
    "decode/dbt_grid132": ("viterbi_dense", _persist(132)),
    "decode/dbt_ahead8_lanes16": ("viterbi_dense", [("#define DBT_LANES 32",
                                                     "#define DBT_LANES 16"),
                                                    ("#define DBT_AHEAD 16",
                                                     "#define DBT_AHEAD 8")]),
    "compose/base": ("fb_onehot", []),
    "compose/ahead16": ("fb_onehot", [("#define STRM_AHEAD 8", "#define STRM_AHEAD 16")]),
    "compose/diag_nostore": ("fb_onehot", [_NOSTORE_FWD, _NOSTORE_COMP]),
    "compose/t4_ahead8": ("fb_onehot", [("#define COMPSEL_AHEAD 16", "#define COMPSEL_AHEAD 8")]),
    "compose/t4_ahead32": ("fb_onehot", [("#define COMPSEL_AHEAD 16",
                                          "#define COMPSEL_AHEAD 32")]),
    "decode/dense_prod_min8": ("viterbi_dense", [(
        "template <int K, int R>\n__global__ void __launch_bounds__(PROD_THREADS)\n"
        "dense_products_kernel",
        "template <int K, int R>\n__global__ void __launch_bounds__(PROD_THREADS, 8)\n"
        "dense_products_kernel")]),
}
_SPB_CHECK = ("(SPB != 1 && SPB != 4)", "(SPB < 1)")  # lanes128 runs one segment a block
SEGMENTS = (128, 256, 512, 1024)
# The kernels whose registers and spills each variant build prints.
PTXAS_OF = {"dense": ("_Z17fb_fwd_sub_kernelILi2E", "_Z17fb_bwd_sub_kernelILi2E",
                      "_Z22fb_bwd_sub_conf_kernelILi2E", "_Z13fb_bwd_kernelILi2ELb1E"),
            "split": ("_Z19fb_fwd_split_kernel", "_Z19fb_bwd_split_kernel",
                      "_Z24fb_bwd_split_conf_kernel", "_Z13fb_bwd_kernelILi8ELb1E",
                      "_Z18fb_fwd_warp",
                      "_Z17fb_fwd_spt_kernel", "_Z17fb_bwd_spt_kernel",
                      "_Z20fb_fwd_simple", "_Z20fb_bwd_simple",
                      "_Z18fb_bwd_warp", "_Z19fb_fwd_stage", "_Z19fb_bwd_stage",
                      "_Z13fb_fwd_kernelILi8E", "_Z13fb_bwd_kernelILi8ELb0E"),
            "stats": ("_Z24oh_seq_stats_part_kernel", "_Z20oh_stats_part_kernel"),
            "compose": ("_Z17oh_fwd_sub_kernel", "_Z18oh_fwd_strm_kernel",
                        "_Z18oh_fwd_comp_kernel", "_Z22oh_fwd_comp_sub_kernel",
                        "_Z25oh_fwd_compsel_sub_kernel",
                        "_Z13oh_fwd_kernel"),
            "decode": ("_Z22oh_backpointers_kernel", "_Z25dense_backpointers_kernel",
                       "_Z21dense_products_kernel",
                       "_Z18oh_products_kernel", "_Z23oh_products_lane_kernel",
                       "_Z19oh_backtrace_kernel",
                       "_Z17oh_bt_maps_kernel", "_Z22dense_backtrace_kernel")}
SPLIT_K = (5, 8)
_P, _I = ctypes.c_void_p, ctypes.c_int


# variant -> the source its build compiled.
SOURCES = {}


def build_all(groups, only=None) -> dict:
    """variant -> the loaded library, for the variants of ``groups`` (those
    in ``only`` and each group's base builds, where given; all nvcc runs
    started together)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (stem, reps) in VARIANTS.items():
        if name.split("/")[0] not in groups:
            continue
        if only and name not in only and not (name.endswith("base") and any(
                VARIANTS[o][0] == stem and o.split("/")[0] == name.split("/")[0] for o in only)):
            continue
        src = (_kernels._CSRC / f"{stem}.cu").read_text()
        for rep in reps + ([_SPB_CHECK] if stem == "fb_onehot" else []):
            missing = [a for a in rep[:-1] if a not in src]
            if missing:
                raise RuntimeError(f"{name}: {missing[0]!r} not in {stem}.cu")
            if len(rep) == 3:
                i, j = src.index(rep[0]), src.index(rep[1])
                src = src[:i] + (rep[2](src[i:j]) if callable(rep[2]) else rep[2]) + src[j:]
            else:
                src = src.replace(*rep)
        SOURCES[name] = src
        tag = name.replace("/", "_")
        path, lib = OUT_DIR / f"{tag}.cu", OUT_DIR / f"lib{tag}.so"
        path.write_text(src)
        procs[name] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels._CSRC), "-o", str(lib),
             str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
        print(json.dumps({"variant": name, "ptxas": ptxas(err, PTXAS_OF[name.split("/")[0]])}),
              flush=True)
    return libs


def ptxas(report: str, names) -> dict:
    """Kernel (mangled) -> its ptxas registers and spills, for the kernels
    whose names start with one of ``names``."""
    out, lines = {}, report.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            if fn.startswith(names):
                out[fn] = " | ".join(x.split("info    :")[-1].strip() for x in lines[i + 2 : i + 4])
    return out


def c_fn(lib, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
    fn.restype = _I

    def call(tensors, ints):
        err = fn(*[t.data_ptr() for t in tensors], *ints,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return call


def time_ms(fn, runs: int = 15) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ragged(rng, S: int, NL: int, Tp: int, dev):
    chunks = rng.integers(0, S, size=(NL, Tp)).astype(np.uint8)
    lengths = np.full(NL, Tp, np.int32)
    lengths[-1] = Tp // 5
    cut = rng.random(NL) < 0.25
    lengths[:-1][cut[:-1]] = rng.integers(1, Tp, size=int(cut[:-1].sum()))
    chunks[np.arange(Tp)[None, :] >= lengths[:, None]] = S
    return torch.from_numpy(chunks).to(dev), torch.from_numpy(lengths).to(dev)


def dense_inputs(rng, dev) -> dict:
    """geometry -> (steps2, lens2, a0, beta0, G) for two_state."""
    two = presets.two_state_cpg(device=dev)
    prep = prepare_chunked(4, *ragged(rng, 4, 1024, 65536, dev), t_tile=512, onehot=False)
    _, a0, beta0, _ = fb_chunked._batch_lane_setup(two, prep)
    n = 8192
    obs = torch.from_numpy(rng.integers(0, 4, size=n * n).astype(np.uint8)).to(dev)
    seq = prepare_seq(4, obs, n * n - 3000, lane_T=n, onehot=False)
    v = lambda: torch.from_numpy(rng.random((2, n)).astype(np.float32) + 0.01).to(dev)  # noqa: E731
    lens = seq.lane_lens[None, :].contiguous()
    return {"train": (prep.steps2, prep.lens2, a0, beta0, 32),
            "post16": (seq.steps2, lens, v(), v(), 16), "post8": (seq.steps2, lens, v(), v(), 8)}


def split_inputs(rng, dev) -> dict:
    """(K, geometry) -> (steps2, lens2, a0, beta0, A, B) for a seeded random
    K-state model over 4 symbols: 1,024 ragged chunks of 65,536 steps and
    8,192 lanes of 8,192 steps."""
    prep = prepare_chunked(4, *ragged(rng, 4, 1024, 65536, dev), t_tile=512, onehot=False)
    n = 8192
    obs = torch.from_numpy(rng.integers(0, 4, size=n * n).astype(np.uint8)).to(dev)
    seq = prepare_seq(4, obs, n * n - 3000, lane_T=n, onehot=False)
    out = {}
    for K in SPLIT_K:
        A = torch.from_numpy(rng.dirichlet(np.ones(K), size=K).astype(np.float32)).to(dev)
        B = torch.from_numpy(rng.dirichlet(np.ones(4), size=K).astype(np.float32)).to(dev)
        for geo, (steps, lens) in (("train", (prep.steps2, prep.lens2)),
                                   ("post", (seq.steps2, seq.lane_lens[None, :].contiguous()))):
            NL = steps.shape[1]
            v = lambda: torch.from_numpy(  # noqa: E731
                rng.random((K, NL)).astype(np.float32) + 0.01).to(dev)
            out[(K, geo)] = (steps, lens, v(), v(), A, B)
    return out


def run_split(name, lib, inputs, ref) -> dict:
    """B16, B18 and B19 (the island mask: the first half of the states) of
    the variant at K = 5 and 8: ms and bit equality with the shipped
    build's outputs."""
    fwd, bwd = c_fn(lib, "fb_fwd", 7, 5), c_fn(lib, "fb_bwd", 8, 6)
    conf_fn = c_fn(lib, "fb_bwd_conf", 10, 6)
    row = {"variant": name}
    for (K, geo), (steps, lens, a0, b0, A, B) in inputs.items():
        Tp, NL = steps.shape
        dev = steps.device
        al, dummy = torch.empty((Tp, K, NL), device=dev), torch.empty((1,), device=dev)
        f = lambda: fwd([steps, lens, a0, A, B, al, dummy], [Tp, NL, K, 4, 1])  # noqa: E731
        row[f"fwd_k{K}_{geo}_ms"] = time_ms(f)
        f()
        _, sn, csn = FP.backward_inputs(steps, al)
        be = torch.empty_like(al)
        g = lambda: bwd([sn, lens, csn, b0, A, B, be, dummy], [Tp, NL, K, 4, Tp, 1])  # noqa: E731
        row[f"bwd_k{K}_{geo}_ms"] = time_ms(g)
        g()
        mask = (torch.arange(K, device=dev) < K // 2).float()
        cf = torch.empty((Tp, NL), device=dev)
        h = lambda: conf_fn([sn, lens, csn, b0, al, mask, A, B, cf, dummy],  # noqa: E731
                            [Tp, NL, K, 4, Tp, 1])
        row[f"conf_k{K}_{geo}_ms"] = time_ms(h)
        h()
        key = (K, geo)
        if name.startswith("split/diag"):
            pass
        elif key not in ref:
            ref[key] = (al, be, cf)
        else:
            row[f"k{K}_{geo}_bit_equal"] = bool(torch.equal(al, ref[key][0])
                                                and torch.equal(be, ref[key][1]))
            row[f"conf_k{K}_{geo}_bit_equal"] = bool(torch.equal(cf, ref[key][2]))
        del sn, csn
    return row


def stats_inputs(rng, dev) -> dict:
    """shape -> B5's operands (the flagship) on B4's streams: ragged chunks
    of 65,536 steps (1,024, and the genome's 1,390) with zero enters, and
    seq lanes of 8,192 steps (8,192, and the genome's 11,121) with random
    enters, every lane's t == 0 pair but lane 0's; and B12's (``split*``)
    on B9's and B10's streams over the same chunks."""
    fl = presets.durbin_cpg8(device=dev)
    gt = OH._groups(fl)
    tab = FB.prob_tab_ext(fl, gt)
    head = (tab, FB.reduced_emissions(fl, gt), gt.to(torch.int32).contiguous())
    out = {}
    for NL in (1024, 1390):
        prep = prepare_chunked(4, *ragged(rng, 4, NL, 65536, dev), t_tile=512)
        _, a0_raw, beta0, _ = fb_chunked._batch_lane_setup(fl, prep)
        a0 = torch.gather(a0_raw.T, 1, gt[prep.esym2[0].long()]).T.contiguous()
        b0 = torch.gather(beta0.T, 1, gt[prep.esym2[-1].long()]).T.contiguous()
        al, be = FB.oh_fwdbwd(prep.pair2, prep.pairn2, prep.lens2, a0, b0, tab, 65536)
        z = lambda r: torch.zeros((r, NL), dtype=torch.float32, device=dev)  # noqa: E731
        out[f"train{NL}"] = (al, be, prep.pair2, prep.lens2, *head, z(8), z(2), z(1))
        # B12 on the split arm's streams (B9's alphas, B10's cs-scaled betas).
        al = FB.oh_fwd(prep.pair2, prep.lens2, a0, tab)
        be = FB.oh_bwd(prep.pairn2, prep.lens2, FB.cs_next_of(al), b0, tab, 65536)
        out[f"split{NL}"] = (al, be, prep.pair2, prep.lens2, *head[1:])
    for NL in (8192, 11121):
        obs = torch.from_numpy(rng.integers(0, 4, size=NL * 8192).astype(np.uint8)).to(dev)
        seq = prepare_seq(4, obs, NL * 8192 - 3000, lane_T=8192)
        lens = seq.lane_lens[None, :].contiguous()
        v = lambda r: torch.from_numpy(  # noqa: E731
            rng.random((r, NL)).astype(np.float32) + 0.01).to(dev)
        al, be = FB.oh_fwdbwd(seq.pair2, seq.pairn2, lens, v(2), v(2), tab, 8192)
        p0 = torch.ones((1, NL), dtype=torch.float32, device=dev)
        p0[0, 0] = 0.0
        out[f"seq{NL}"] = (al, be, seq.pair2, lens, *head, v(8), v(2), p0)
    return out


def run_dense(name, lib, inputs, A, B, ref) -> dict:
    """B16, B18 and B19 (island mask [1, 0]; at the geometry's G and at
    G = 1, the one-thread chain) of the variant at K = 2: ms and bit
    equality with the shipped build's outputs."""
    fwd, bwd = c_fn(lib, "fb_fwd", 7, 5), c_fn(lib, "fb_bwd", 8, 6)
    conf_fn = c_fn(lib, "fb_bwd_conf", 10, 6)
    mask = torch.tensor([1.0, 0.0], device=A.device)
    row = {"variant": name}
    for geo, (steps, lens, a0, b0, G) in inputs.items():
        Tp, NL = steps.shape
        al, pb = torch.empty((Tp, 2, NL), device=steps.device), torch.empty((G, 4, NL),
                                                                               device=steps.device)
        f = lambda: fwd([steps, lens, a0, A, B, al, pb], [Tp, NL, 2, 4, G])  # noqa: E731
        row[f"fwd_{geo}_ms"] = time_ms(f)
        f()
        _, sn, csn = FP.backward_inputs(steps, al)
        be, qb = torch.empty_like(al), torch.empty((G, 5, NL), device=steps.device)
        g = lambda: bwd([sn, lens, csn, b0, A, B, be, qb], [Tp, NL, 2, 4, Tp, G])  # noqa: E731
        row[f"bwd_{geo}_ms"] = time_ms(g)
        g()
        confs = []
        for cG, tag in ((G, ""), (1, "_g1")):
            cf = torch.empty((Tp, NL), device=steps.device)
            h = lambda: conf_fn([sn, lens, csn, b0, al, mask, A, B, cf, qb],  # noqa: E731
                                [Tp, NL, 2, 4, Tp, cG])
            row[f"conf{tag}_{geo}_ms"] = time_ms(h)
            h()
            confs.append(cf)
        if geo not in ref:
            ref[geo] = (al, be, *confs)
        else:
            row[f"{geo}_bit_equal"] = bool(torch.equal(al, ref[geo][0])
                                           and torch.equal(be, ref[geo][1])
                                           and torch.equal(confs[0], ref[geo][2])
                                           and torch.equal(confs[1], ref[geo][3]))
    return row


def run_stats(name, lib, inputs, want) -> dict:
    """B5 (``train*`` and ``seq*`` shapes) and B12 (``split*``) of the
    variant at each of SEGMENTS: ms and agreement with the plain
    version."""
    fns = {"oh_seq_stats": c_fn(lib, "oh_seq_stats", 14, 6),
           "oh_stats": c_fn(lib, "oh_stats", 10, 6)}
    spb = 1 if name == "stats/lanes128" else 4
    row = {"variant": name}
    for shape, sa in inputs.items():
        Tp, NL = sa[2].shape
        fn = fns["oh_stats" if shape.startswith("split") else "oh_seq_stats"]
        for seg in SEGMENTS:
            # every segment's row set: the parent's B12 sums no blocks
            part = torch.empty((-(-Tp // seg), 73, NL), device=sa[0].device)
            out = [torch.empty((r, NL), device=sa[0].device) for r in (64, 8, 1)]
            f = lambda: fn([*sa, part, *out], [Tp, NL, 4, 8, seg, spb])  # noqa: E731
            row[f"{shape}_{seg}_ms"] = time_ms(f)
            f()
            if not name.startswith("stats/diag"):
                row[f"{shape}_{seg}_agrees"] = all(
                    torch.allclose(a, b, rtol=1e-5, atol=1e-3) for a, b in zip(out, want[shape]))
    return row


def _members(dev, M: int, S: int = 4) -> list:
    """The flagship (S = 4) or dinuc_cpg (S = 16) plus M - 1 random
    partition=2 members of its alphabet, their states renumbered at random
    (chip_smoke's stacked decode)."""
    gen = torch.Generator().manual_seed(0)
    out = [presets.durbin_cpg8(device=dev) if S == 4 else presets.dinuc_cpg(device=dev)]
    for _ in range(M - 1):
        q = presets.random_hmm(gen, 2 * S, S, partition=2, device=dev)
        perm = torch.randperm(2 * S, generator=gen).to(dev)
        out.append(HmmParams(q.log_pi[perm], q.log_A[perm][:, perm], q.log_B[perm]))
    return out


def _oh_operands(rng, members, steps2, prev0, resets, pre=None):
    """(pair2, v_red [M, 2, nb], tabs [M, nP, 4], idtabs [M, nP, 2], bp
    [M, bk/8, nb], exit bits [M, nb]) of a stacked decode over ``steps2``,
    with random entering vectors and exit bits; bp is the plain version's
    pointers from those vectors."""
    _, _, tabs, idtabs, pair2, _, e_out, nreal = OH.stacked_prepared(members, steps2, prev0,
                                                                     resets, pre)
    pair2 = OH._pad_pair_rows(pair2, e_out, nreal)
    M, nb = len(members), pair2.shape[1]
    v = rng.normal(scale=3.0, size=(M, 2, nb)).astype(np.float32)
    v_red = torch.from_numpy(v - v.max(axis=1, keepdims=True)).to(steps2.device)
    tabs, idtabs = torch.stack(tabs).contiguous(), torch.stack(idtabs).contiguous()
    bp = OH.oh_backpointers_stacked_plain(pair2, v_red, tabs)[0]
    bits = torch.from_numpy(rng.integers(0, 2, size=(M, nb)).astype(np.int32)).to(steps2.device)
    return pair2, v_red, tabs, idtabs, bp, bits


def decode_inputs(rng, dev, bk: int = 4096, nb: int = 16384, T: int = 512 << 10) -> dict:
    """geometry -> the reduced decode's operands: ``big``, 4,096 x 16,384
    steps of the flagship's alphabet (PAD runs, sparse resets) under M = 5
    members (``wide``, its pair stream side by side to B1_WIDE_NB lanes);
    ``big16``, the same geometry over dinuc_cpg's 16 symbols under
    M = 2; ``flush``, the largest mixed-model flush (8 records padded to
    512 Ki symbols, one flat reset stream: 4,096 x 1,024) under M = 3; and
    ``dense2`` / ``dense8``, B13 / B14's 4,096 x 16,384 symbol streams (PAD
    runs) with two_state's and the flagship's tables, and ``dense_wide``
    the same stream side by side to the most of B13_WIDE_NB lanes."""
    steps = rng.integers(0, 4, size=(bk, nb)).astype(np.int32)
    for k0, b, n in zip(rng.integers(0, bk, size=nb // 4), rng.integers(0, nb, size=nb // 4),
                        rng.integers(1, 200, size=nb // 4)):
        steps[k0 : k0 + n, b] = 4
    steps_d = torch.from_numpy(steps).to(dev)
    resets = torch.from_numpy(rng.random((bk, nb)) < 1e-4).to(dev)
    out = {"big": _oh_operands(rng, _members(dev, 5), steps_d, 1, resets)}
    out["wide"] = out["big"][0].repeat(1, -(-max(B1_WIDE_NB) // nb))
    steps16 = rng.integers(0, 16, size=(bk, nb)).astype(np.int32)
    steps16[steps == 4] = 16
    out["big16"] = _oh_operands(rng, _members(dev, 2, S=16), torch.from_numpy(steps16).to(dev),
                                1, resets)
    rows = torch.from_numpy(rng.integers(0, 4, size=(8, T)).astype(np.uint8)).to(dev)
    lengths = torch.from_numpy(np.array([T, T // 2, 3 * T // 4, T // 7, T, T // 3, T - 9, T // 128],
                                        np.int32)).to(dev)
    concat, padded, fresets, fbk, pre = OH.prepare_decode_flat(4, rows, lengths, bk)
    fsteps = padded.reshape(-1, fbk).T
    out["flush"] = _oh_operands(rng, _members(dev, 3), fsteps, None, fresets, pre)
    for K, params in ((2, presets.two_state_cpg(device=dev)), (8, presets.durbin_cpg8(device=dev))):
        v = rng.normal(scale=3.0, size=(K, nb)).astype(np.float32)
        logAT, logB = VP._tables(params)
        out[f"dense{K}"] = (steps_d, torch.from_numpy(v - v.max(axis=0)).to(dev), logAT, logB)
    out["dense_wide"] = steps_d.repeat(1, -(-max(B13_WIDE_NB) // nb))
    for Tf in B13_FLUSH_T:
        out[f"dense_flush{Tf}"] = dense_flush_steps(rows[:, :Tf], lengths.long() * Tf // T, bk)
    # B15's operands: B14's pointers (the package's kernel) from random
    # entering vectors, random exit states, at 16,384 lanes and the flushes.
    for K in (2, 8):
        _, _, logAT, logB = out[f"dense{K}"]
        for tag, st in [("", steps_d)] + [(f"_flush{Tf}", out[f"dense_flush{Tf}"])
                                          for Tf in B13_FLUSH_T]:
            n = st.shape[1]
            v = rng.normal(scale=3.0, size=(K, n)).astype(np.float32)
            bp = VP.dense_backpointers(st, torch.from_numpy(v - v.max(axis=0)).to(dev), logAT,
                                       logB)[0]
            exits = torch.from_numpy(rng.integers(0, K, size=n).astype(np.int32)).to(dev)
            out[f"bt{K}{tag}"] = (bp, exits)
    return out


def dense_flush_steps(rows, lengths, bk: int):
    """B13's symbols for a two_state flush of ``rows`` (records padded to
    one length, lengths ``lengths``), laid out as
    ``viterbi_parallel._dense_batch`` lays them: each record's steps after
    its first symbol, PAD past its length, in blocks of bk, record r's
    block b on lane r * nb + b."""
    N, T = rows.shape
    obs = torch.where(torch.arange(T, device=rows.device)[None, :] >= lengths[:, None], 4,
                      rows.to(torch.int32))
    S = T - 1
    bk = min(bk, max(8, S))
    nb = -(-S // bk)
    steps = torch.cat([obs[:, 1:], torch.full((N, nb * bk - S), 4, dtype=torch.int32,
                                              device=rows.device)], dim=1)
    return steps.reshape(N * nb, bk).T.contiguous()


# B15's segment lengths (steps) swept at 16,384 lanes and at the flushes on
# the builds of DBT_SWEEP (4,096-step lanes: 128 is the least the kernel
# takes there, 32 segments).
DBT_SEGS = (128, 256, 512, 1024)
DBT_SWEEP = ("decode/dense_base", "decode/dbt_ahead8", "decode/dbt_ahead32",
             "decode/dbt_lanes16")
# B3 / B28's segment lengths (words) swept at both geometries; a length
# whose lanes would need more segments than the build's BT_MAX_SEG (the
# kernel would lengthen it) is skipped.
BT_SEGS = (16, 32, 64, 128, 256)
# B1's lanes beside 16,384: the 4,096 x 16,384 stream side by side.
B1_WIDE_NB = (32768, 49152, 65536)
# B13's beside 16,384: a 16 Mi span's 4,096 lanes up to the one-pass decode
# of a 2^28 record's 65,536.
B13_WIDE_NB = (4096, 8192, 32768, 49152, 65536)
# B13 at two_state's scaffold flushes: 8 records padded to 64 Ki and to 512
# Ki symbols (128 and 1,024 lanes of 4,096 steps; 512 Ki is the most a
# small record pads to).
B13_FLUSH_T = (64 << 10, 512 << 10)


def _oh_calls(lib, name, inputs) -> list:
    """The reduced decode kernels of a viterbi_onehot build, as (key, C
    function, operands, int arguments, outputs, segment sweep): B2, B6,
    B27 (both arms), B1, B26, B3 and B28 at 4,096 x 16,384 (M = 2; B26,
    B27 and B28 also at M = 5, B26 at M = 3 and 4, B1 also on
    B1_WIDE_NB lanes, and at S = 16), and B2, B27, B1, B26, B3 and B28 at
    the flush (M = 2, 3).  B3 / B28 take the kernel's own segment length
    (seg 0); the sweep's lengths are passed."""
    b2, b6 = c_fn(lib, "oh_backpointers", 6, 3), c_fn(lib, "oh_backpointers_scores", 7, 3)
    b27 = c_fn(lib, "oh_backpointers_stacked", 6, 4)
    b27s = c_fn(lib, "oh_backpointers_stacked_scores", 7, 4)
    b1, b26 = c_fn(lib, "oh_products", 3, 3), c_fn(lib, "oh_products_stacked", 3, 4)
    b3, b28 = c_fn(lib, "oh_backtrace", 5, 4), c_fn(lib, "oh_backtrace_stacked", 5, 5)
    sweep = name in ("decode/oh_base", "decode/bt_max16", "decode/bt_member_y",
                     "decode/bt_resolved", "decode/bt_grid2")
    calls = []
    for geo, Ms in (("big", (2, 5)), ("big16", (2,)), ("flush", (2, 3))):
        pair2, v_red, tabs, idtabs, bp, bits = inputs[geo]
        bk, nb = pair2.shape
        nP, dev = tabs.shape[1], pair2.device
        segs = [g for g in BT_SEGS if sweep and geo != "big16"
                and -(-bk // 8 // g) <= _define(name, "BT_MAX_SEG")]

        def out(*lead, scores=False):
            return [torch.empty(lead + (bk // 8, nb), dtype=torch.int32, device=dev),
                    torch.empty(lead + (2, nb), device=dev),
                    torch.empty(lead + (nb,), dtype=torch.int32, device=dev)] + (
                        [torch.empty(lead + (bk, nb), device=dev)] if scores else [])
        one = [pair2, v_red[0], tabs[0]]
        first = lambda t: t[0].contiguous()  # noqa: E731
        calls.append((f"b2_{geo}", b2, one, [bk, nb, nP], out(), ()))
        calls.append((f"b1_{geo}", b1, [pair2, tabs[0]], [bk, nb, nP],
                      [torch.empty((4, nb), device=dev)], ()))
        calls.append((f"b3_{geo}", b3, [first(bp), pair2, first(idtabs), first(bits)],
                      [bk, nb, nP, 0], [torch.empty((bk, nb), dtype=torch.int32, device=dev)],
                      segs))
        if geo == "big":
            for wide in B1_WIDE_NB:
                w = inputs["wide"][:, :wide].contiguous()
                calls.append((f"b1_nb{wide}_big", b1, [w, tabs[0]], [bk, wide, nP],
                              [torch.empty((4, wide), device=dev)], ()))
            for M in (3, 4):
                calls.append((f"b26_m{M}_big", b26, [pair2, tabs[:M].contiguous()],
                              [bk, nb, nP, M], [torch.empty((M, 4, nb), device=dev)], ()))
            calls.append(("b6_big", b6, one, [bk, nb, nP], out(scores=True), ()))
            calls.append(("b27s_m2_big", b27s, [pair2, v_red[:2].contiguous(),
                                                tabs[:2].contiguous()],
                          [bk, nb, nP, 2], out(2, scores=True), ()))
        for M in Ms:
            head = lambda t: t[:M].contiguous()  # noqa: E731
            calls.append((f"b27_m{M}_{geo}", b27, [pair2, head(v_red), head(tabs)],
                          [bk, nb, nP, M], out(M), ()))
            calls.append((f"b26_m{M}_{geo}", b26, [pair2, head(tabs)], [bk, nb, nP, M],
                          [torch.empty((M, 4, nb), device=dev)], ()))
            calls.append((f"b28_m{M}_{geo}", b28, [head(bp), pair2, head(idtabs), head(bits)],
                          [bk, nb, nP, M, 0],
                          [torch.empty((M, bk, nb), dtype=torch.int32, device=dev)],
                          segs if M != 3 else ()))
    return calls


def run_decode(name, lib, inputs, ref) -> dict:
    """The variant's reduced decode kernels (:func:`_oh_calls`; B3 / B28
    also at each of BT_SEGS for the segmented builds), or its B14 at K = 2
    and 8, its B13 at K = 2 and 8 on 16,384 and each of B13_WIDE_NB lanes
    and at two_state's flushes (B13_FLUSH_T), and its B15 at K = 2 and 8 on
    16,384 lanes and at the flushes (also at each of DBT_SEGS for the
    builds of DBT_SWEEP): ms and bit equality with the shipped build's
    outputs."""
    if VARIANTS[name][0] == "viterbi_onehot":
        calls = _oh_calls(lib, name, inputs)
    else:
        calls = []
        b14 = c_fn(lib, "dense_backpointers", 7, 4)
        b13 = c_fn(lib, "dense_products", 4, 4)
        b15 = c_fn(lib, "dense_backtrace", 3, 4)
        for K in (2, 8):
            steps, v, logAT, logB = inputs[f"dense{K}"]
            bk, nb = steps.shape
            S, dev = logB.shape[1], steps.device
            outs = [torch.empty((bk, nb), dtype=torch.int32, device=dev),
                    torch.empty((K, nb), device=dev),
                    torch.empty((nb,), dtype=torch.int32, device=dev)]
            calls.append((f"b14_k{K}", b14, [steps, v, logAT, logB], [bk, nb, K, S], outs, ()))
            wide = [(f"_nb{w}", inputs["dense_wide"][:, :w].contiguous()) for w in B13_WIDE_NB]
            flush = [(f"_flush{inputs[f'dense_flush{T}'].shape[1]}", inputs[f"dense_flush{T}"])
                     for T in B13_FLUSH_T]
            for tag, st in [("", steps)] + wide + flush:
                calls.append((f"b13_k{K}{tag}", b13, [st, logAT, logB], [bk, st.shape[1], K, S],
                              [torch.empty((K * K, st.shape[1]), device=dev)], ()))
            for tag in [""] + [f"_flush{T}" for T in B13_FLUSH_T]:
                bp, exits = inputs[f"bt{K}{tag}"]
                n = bp.shape[1]
                calls.append((f"b15_k{K}{tag and '_flush' + str(n)}", b15, [bp, exits],
                              [bk, n, K, 0],
                              [torch.empty((bk, n), dtype=torch.int32, device=dev)],
                              DBT_SEGS if name in DBT_SWEEP else ()))
    checked = "_diag_" not in name
    row = {"variant": name}
    for key, fn, operands, ints, outs, segs in calls:
        runs = [(key, ints)] + [(f"{key}_seg{g}", ints[:-1] + [g]) for g in segs]
        for rkey, rints in runs:
            def launch(fn=fn, tensors=operands + outs, ints=rints):
                fn(tensors, ints)
            row[f"{rkey}_ms"] = time_ms(launch)
            launch()
            if not checked:
                continue
            if key not in ref:
                ref[key] = [x.clone() for x in outs]
            else:
                row[f"{rkey}_bit_equal"] = all(torch.equal(a, b) for a, b in zip(outs, ref[key]))
    return row


# T1 (B9) and T2-T4 at the compose bench's 64 Mi symbols as (lanes, steps),
# each at these G (G = 1: the one-chain kernels, the parent layout of T2-T4).
COMPOSE_SHAPES = ((1024, 65536), (4096, 16384))
COMPOSE_G = (1, 8, 16, 32)


def compose_inputs(dev) -> dict:
    """(lanes, steps) -> the bench's seeded operands of T1-T4 and the
    alphas / products scratch."""
    from cpgisland_tpu_torch.ops import fb_compose as FC
    from cpgisland_tpu_torch.tools import bench_compose as BC

    tab, tab_ext = BC.pair_tables(dev)
    tables = FC.composed_tables(tab)
    out = {}
    for NL, Tp in COMPOSE_SHAPES:
        pair2, lens2, a0 = BC.inputs(NL * Tp, Tp, dev)
        out[(NL, Tp)] = dict(
            pair2=pair2, lens2=lens2, a0=a0, tab_ext=tab_ext, mats=FC.mat_streams(tab, pair2),
            comp=FC.composed_streams(tab, pair2), idx=FC.compsel_index(pair2, 4), tables=tables,
            alphas=torch.empty((Tp, 2, NL), device=dev),
            pbuf=torch.empty((max(COMPOSE_G), 4, NL), device=dev))
    return out


def run_compose(name, lib, inputs, ref) -> dict:
    """T1 (``oh_fwd``), T2 (``oh_fwd_strm``), T3 (``oh_fwd_comp``) and T4
    (``oh_fwd_compsel``) of the variant through their C entries at each
    shape and each of COMPOSE_G: ms, T2 bit for bit T1 and T4 bit for bit
    T3 at the same G, each kernel bit for bit the shipped build's at the
    same G (``ref``), and T3's largest relative difference from T1 at G = 1
    (the sequential chain)."""
    fns = {"t1": c_fn(lib, "oh_fwd", 6, 4), "t2": c_fn(lib, "oh_fwd_strm", 5, 3),
           "t3": c_fn(lib, "oh_fwd_comp", 5, 3), "t4": c_fn(lib, "oh_fwd_compsel", 8, 4)}
    checked = not name.startswith("compose/diag")
    row = {"variant": name}
    for (NL, Tp), x in inputs.items():
        calls = {
            "t1": lambda G: fns["t1"]([x["pair2"], x["lens2"], x["a0"], x["tab_ext"], x["alphas"],
                                       x["pbuf"]], [Tp, NL, x["tab_ext"].shape[0] - 1, G]),
            "t2": lambda G: fns["t2"]([x["mats"], x["lens2"], x["a0"], x["alphas"], x["pbuf"]],
                                      [Tp, NL, G]),
            "t3": lambda G: fns["t3"]([x["comp"], x["lens2"], x["a0"], x["alphas"], x["pbuf"]],
                                      [Tp // 2, NL, G]),
            "t4": lambda G: fns["t4"]([x["idx"], x["lens2"], x["a0"], *x["tables"], x["alphas"],
                                       x["pbuf"]], [Tp // 2, NL, 4, G])}
        for G in COMPOSE_G:
            outs = {}
            for k, call in calls.items():
                key = f"{NL}x{Tp}_G{G}_{k}"
                row[f"{key}_ms"] = time_ms(lambda: call(G))
                call(G)
                torch.cuda.synchronize()
                outs[k] = x["alphas"].clone()
                if not checked:
                    continue
                if (key, "base") not in ref:
                    ref[(key, "base")] = outs[k]
                else:
                    row[f"{key}_bit_equal_base"] = torch.equal(outs[k], ref[(key, "base")])
            if not checked:
                continue
            row[f"{NL}x{Tp}_G{G}_t2_equals_t1"] = torch.equal(outs["t2"], outs["t1"])
            row[f"{NL}x{Tp}_G{G}_t4_equals_t3"] = torch.equal(outs["t4"], outs["t3"])
            if G == 1:
                ref[(NL, Tp, "seq")] = outs["t1"]
            seq = ref[(NL, Tp, "seq")]
            row[f"{NL}x{Tp}_G{G}_t3_max_rel_vs_seq"] = float(
                ((outs["t3"].double() - seq.double()).abs()
                 / seq.double().abs().clamp_min(1e-3)).max())
    return row


def _define(name: str, macro: str) -> int:
    """The value of ``#define macro`` in the variant's built source."""
    return int(re.search(rf"^#define {macro} (\d+)", SOURCES[name], re.M).group(1))

GROUPS = ("dense", "split", "stats", "decode", "compose")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", action="append", choices=GROUPS,
                    help="run only these variant groups (repeatable; default all)")
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS),
                    help="run only these variants of the groups (repeatable; a group's base "
                         "build always runs: the others are held against it)")
    args = ap.parse_args(argv)
    groups = tuple(args.group or GROUPS)
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    libs = build_all(groups, args.variant)
    rng = np.random.default_rng(0)
    if "dense" in groups:
        A, B, _ = FP.tables(presets.two_state_cpg(device=dev))
        inputs, ref = dense_inputs(rng, dev), {}
        for name, lib in libs.items():
            if name.startswith("dense/"):
                print(json.dumps(run_dense(name, lib, inputs, A, B, ref)), flush=True)
        del inputs, ref
        torch.cuda.empty_cache()
    if "split" in groups:
        inputs, ref = split_inputs(rng, dev), {}
        for name, lib in libs.items():
            if name.startswith("split/"):
                print(json.dumps(run_split(name, lib, inputs, ref)), flush=True)
        del inputs, ref
        torch.cuda.empty_cache()
    if "stats" in groups:
        inputs = stats_inputs(rng, dev)
        want = {k: (FB.oh_stats_plain if k.startswith("split") else FB.oh_seq_stats_plain)(*sa)
                for k, sa in inputs.items()}
        for name, lib in libs.items():
            if name.startswith("stats/"):
                print(json.dumps(run_stats(name, lib, inputs, want)), flush=True)
        del inputs, want
        torch.cuda.empty_cache()
    if "compose" in groups:
        inputs, ref = compose_inputs(dev), {}
        order = sorted((n for n in libs if n.startswith("compose/")),
                       key=lambda n: n != "compose/base")
        for name in order:
            print(json.dumps(run_compose(name, libs[name], inputs, ref)), flush=True)
        del inputs, ref
        torch.cuda.empty_cache()
    if "decode" in groups:
        inputs, ref = decode_inputs(rng, dev), {}
        # The shipped builds first: every other variant is held against them.
        order = sorted((n for n in libs if n.startswith("decode/")),
                       key=lambda n: not n.endswith("_base"))
        for name in order:
            print(json.dumps(run_decode(name, libs[name], inputs, ref)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
