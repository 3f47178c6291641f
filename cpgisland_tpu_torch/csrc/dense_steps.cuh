// The dense chains' shared steps, included by csrc/fb_dense.cu (B16-B20) and
// csrc/loglik.cu (the dense scoring chain): the forward contraction and the
// power-of-two scaling of the sub-lane products, one piece of code wherever
// they run (csrc/fb_onehot.cu's B10 takes the scaling too).  Every
// operation is an explicit round-to-nearest intrinsic, the plain versions'
// order (cpgisland_tpu_torch/ops/fb_pallas.py).
#pragma once

#include <cuda_runtime.h>

// Sequential K-term sum in round-to-nearest: x[0] + x[1] + ... + x[K-1].
template <int K>
__device__ __forceinline__ float seq_sum(const float (&x)[K]) {
  float s = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) s = __fadd_rn(s, x[k]);
  return s;
}

// A forward step's contraction without the division: nv[k] = (sum_j v[j]
// A[j, k]) * B[k, o], j in order, the chain's (fwd_range's) operations.
// B16's sub-lane product applies it to each row of its matrix; the scoring
// chain takes it as its raw vector.
template <int K>
__device__ __forceinline__ void fwd_contract(const float* s_A, const float* s_B, int S, int o,
                                             const float (&v)[K], float (&nv)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float acc = __fmul_rn(v[0], s_A[k]);
#pragma unroll
    for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], s_A[j * K + k]));
    nv[k] = __fmul_rn(acc, s_B[k * S + o]);
  }
}

// 2^e for -126 <= e <= 126: a normal float, so a product by it is exact
// unless the product leaves the normal range.
__device__ __forceinline__ float pow2f(int e) { return __int_as_float((e + 127) << 23); }

// x's binary exponent (frexp's: x = m 2^e, 0.5 <= m < 1, for a normal x;
// -126 for 0 and subnormals), clamped to [-126, 126].
__device__ __forceinline__ int scale_exp(float x) {
  return min(max(((__float_as_int(x) >> 23) & 0xff) - 126, -126), 126);
}
