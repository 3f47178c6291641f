// The reduced one-hot chains' shared steps, included by csrc/fb_onehot.cu (B4,
// B7 and the chains beside them) and csrc/loglik.cu (the reduced scoring
// chain), so a sub-lane's transfer product and its forward message are one
// piece of code wherever they run.  Every operation is an explicit
// round-to-nearest intrinsic, the plain versions' order
// (cpgisland_tpu_torch/ops/fb_onehot.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_S 16
#define MAX_TAB ((MAX_S * MAX_S + 1) * 4)
#define LOOKAHEAD 16

// q[r] = the (clamped) pair at step first + step * r of a lane's stream; PAD
// pairs and steps outside [0, Tp) -> the identity row.
__device__ __forceinline__ void load_group(const int32_t* p, size_t stride, int first,
                                           int step, int Tp, int nreal,
                                           int (&q)[LOOKAHEAD]) {
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = first + step * r;
    const int v = (t >= 0 && t < Tp) ? __ldg(p + (size_t)t * stride) : nreal;
    q[r] = v < nreal ? v : nreal;
  }
}

// The step sources of the reduced forward chains.  A source reads the
// matrices of a group of AHEAD consecutive steps of a lane (``load``, a group
// ahead of the chain) and hands out step r's four entries 00, 01, 10, 11 from
// the group it read (``mat``).  PairSteps: the lane's pair stream and the
// table in shared memory (B4, B7, B9 and the chains beside them), a step's
// entries looked up when it runs; PAD pairs and steps outside [0, Tp) -> the
// identity row.  fb_onehot.cu adds T2's four streamed planes (StreamSteps).
struct PairSteps {
  static constexpr int AHEAD = LOOKAHEAD;
  struct Group {
    int q[AHEAD];
  };
  const int32_t* p;
  const float* s_tab;
  size_t nl;
  int Tp, nreal;
  __device__ __forceinline__ void load(int first, Group& g) const {
    load_group(p, nl, first, 1, Tp, nreal, g.q);
  }
  __device__ __forceinline__ void mat(const Group& g, int r, float (&m)[4]) const {
    const float* t = s_tab + 4 * g.q[r];
    m[0] = t[0];
    m[1] = t[1];
    m[2] = t[2];
    m[3] = t[3];
  }
  __device__ __forceinline__ bool real(const Group& g, int r) const { return g.q[r] < nreal; }
};

// A sub-lane's transfer product for the sub-lane scans: from the identity,
// C <- C . M_t over steps [tb, te) where lo <= t < hi (the direction's
// valid steps), the identity elsewhere; after every 8th step counted from
// tb, C times 1 / max(((C00 + C01) + C10) + C11, 1e-30).  Writes C00, C01,
// C10, C11 at dst[0..3] and returns whether a real step (not a PAD pair)
// fell on one of those valid steps.  The forward takes its step source (the
// product left to right); the backward the next-step pairs, its product Q
// with beta_tb = Q . beta_te up to scale.
template <class Src>
__device__ __forceinline__ bool sub_prod(const Src& src, int tb, int te, int lo, int hi,
                                         float* dst) {
  float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
  bool any = false;
  typename Src::Group q, qn;
  src.load(tb, q);
  for (int t0 = tb; t0 < te; t0 += Src::AHEAD) {
    src.load(t0 + Src::AHEAD, qn);
#pragma unroll
    for (int r = 0; r < Src::AHEAD; ++r) {
      const int t = t0 + r;
      if (t < te) {
        if (t >= lo && t < hi) {
          float m[4];
          src.mat(q, r, m);
          const float n00 = __fadd_rn(__fmul_rn(c00, m[0]), __fmul_rn(c01, m[2]));
          const float n01 = __fadd_rn(__fmul_rn(c00, m[1]), __fmul_rn(c01, m[3]));
          const float n10 = __fadd_rn(__fmul_rn(c10, m[0]), __fmul_rn(c11, m[2]));
          const float n11 = __fadd_rn(__fmul_rn(c10, m[1]), __fmul_rn(c11, m[3]));
          c00 = n00;
          c01 = n01;
          c10 = n10;
          c11 = n11;
          any = any || src.real(q, r);
        }
        // t - tb = (t0 - tb) + r with t0 - tb a multiple of AHEAD (of 8).
        if ((r & 7) == 7) {
          const float inv = __fdiv_rn(
              1.0f, fmaxf(__fadd_rn(__fadd_rn(__fadd_rn(c00, c01), c10), c11), 1e-30f));
          c00 = __fmul_rn(c00, inv);
          c01 = __fmul_rn(c01, inv);
          c10 = __fmul_rn(c10, inv);
          c11 = __fmul_rn(c11, inv);
        }
      }
    }
    q = qn;
  }
  dst[0] = c00;
  dst[1] = c01;
  dst[2] = c10;
  dst[3] = c11;
  return any;
}

// sub_prod over a lane's pair stream ``p`` and the table ``s_tab``.
__device__ __forceinline__ bool sub_prod(const int32_t* p, const float* s_tab, int tb, int te,
                                         int lo, int hi, int Tp, size_t nl, int nreal,
                                         float* dst) {
  return sub_prod(PairSteps{p, s_tab, nl, Tp, nreal}, tb, te, lo, hi, dst);
}

// The message that leaves a sub-lane, from the one that enters it and the
// sub-lane's product: (v . P) (FWD) or (P . v), over max(its total, 1e-30).
template <bool FWD>
__device__ __forceinline__ void sub_message(float& v0, float& v1, const float* P) {
  const float r0 = FWD ? __fadd_rn(__fmul_rn(v0, P[0]), __fmul_rn(v1, P[2]))
                       : __fadd_rn(__fmul_rn(P[0], v0), __fmul_rn(P[1], v1));
  const float r1 = FWD ? __fadd_rn(__fmul_rn(v0, P[1]), __fmul_rn(v1, P[3]))
                       : __fadd_rn(__fmul_rn(P[2], v0), __fmul_rn(P[3], v1));
  const float inv = __fdiv_rn(1.0f, fmaxf(__fadd_rn(r0, r1), 1e-30f));
  v0 = __fmul_rn(r0, inv);
  v1 = __fmul_rn(r1, inv);
}
