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

// A sub-lane's transfer product for the sub-lane scans: from the identity,
// C <- C . M_t over steps [tb, te) where lo <= t < hi (the direction's
// valid steps), the identity elsewhere; after every 8th step counted from
// tb, C times 1 / max(((C00 + C01) + C10) + C11, 1e-30).  Writes C00, C01,
// C10, C11 at dst[0..3] and returns whether a real pair (not a PAD) fell on
// one of those valid steps.  The forward takes the pair stream (the product
// left to right); the backward the next-step pairs, its product Q with
// beta_tb = Q . beta_te up to scale.
__device__ __forceinline__ bool sub_prod(const int32_t* p, const float* s_tab, int tb, int te,
                                         int lo, int hi, int Tp, size_t nl, int nreal,
                                         float* dst) {
  float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
  bool any = false;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_group(p, nl, tb, 1, Tp, nreal, q);
  for (int t0 = tb; t0 < te; t0 += LOOKAHEAD) {
    load_group(p, nl, t0 + LOOKAHEAD, 1, Tp, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      const int t = t0 + r;
      if (t < te) {
        if (t >= lo && t < hi) {
          const float* m = s_tab + 4 * q[r];
          const float n00 = __fadd_rn(__fmul_rn(c00, m[0]), __fmul_rn(c01, m[2]));
          const float n01 = __fadd_rn(__fmul_rn(c00, m[1]), __fmul_rn(c01, m[3]));
          const float n10 = __fadd_rn(__fmul_rn(c10, m[0]), __fmul_rn(c11, m[2]));
          const float n11 = __fadd_rn(__fmul_rn(c10, m[1]), __fmul_rn(c11, m[3]));
          c00 = n00;
          c01 = n01;
          c10 = n10;
          c11 = n11;
          any = any || q[r] < nreal;
        }
        // t - tb = (t0 - tb) + r with t0 - tb a multiple of LOOKAHEAD.
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
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  dst[0] = c00;
  dst[1] = c01;
  dst[2] = c10;
  dst[3] = c11;
  return any;
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
