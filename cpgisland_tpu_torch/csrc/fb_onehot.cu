// Reduced one-hot forward-backward: the fused arm's three kernels for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (cpgisland_tpu_torch/ops/_kernels.py).  Plain versions of the same
// functions, used on the CPU and as the reference on the card, live in
// cpgisland_tpu_torch/ops/fb_onehot.py (oh_prod_plain, oh_fwdbwd_plain,
// oh_seq_stats_plain).
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
// step matrices, each step renormalized by the product's total.  Bound: it
// reads 4 B per step and writes 16 B per lane, 0.27 GB at NL = 8192 lanes
// of 8192 steps (0.080 ms at 3.35 TB/s); each lane is one dependent chain
// of steps whose every step waits on four IEEE divisions, so like B4 it is
// latency-bound well above that.  The design: one thread per lane (32 to a
// block, so the warps spread over the SMs), the pair stream read a group of
// steps ahead of the chain (as in B4), and every product, sum and division
// an explicit round-to-nearest intrinsic in the plain version's order —
// ((n00 + n01) + n10) + n11 for the total — so it equals the plain version
// bit for bit.  (The TPU kernel renormalizes every 8 steps; the directions,
// all that its consumers read, are the same.)
//
// B4 oh_fwdbwd_kernel replaces cpgisland_tpu/ops/fb_onehot.py::
// _oh_fwdbwd_kernel.  Bound: it reads 8 B and writes 16 B per step and
// lane, 1.61 GB at NL = 1024, Tp = 65,536 (0.48 ms at 3.35 TB/s), but each
// lane is two dependent chains of Tp steps whose every step waits on an
// IEEE division, and the batch has only about a thousand lanes, so it is
// latency-bound several times above that.  The design: the forward and
// the backward chain of a lane are independent, so each gets its own
// thread (2 * NL threads, 32 to a block so the few warps spread over many
// SMs), and each thread reads its pair stream a group of steps ahead of the
// chain.  Bit equality with the plain version: every multiply and add is an
// explicit round-to-nearest intrinsic (__fmul_rn / __fadd_rn), so nvcc
// contracts nothing into an FMA, and 1/x is __fdiv_rn (IEEE), in the plain
// version's operand order — including the backward's raw contraction first,
// then the multiply by the previous beta's reciprocal sum.
//
// B5 oh_seq_stats_*_kernel replaces fb_onehot.py::_oh_seq_stats_kernel.
// Bound: it reads 20 B per valid step (two alphas, two betas, the pair),
// 1.34 GB at NL = 1024, Tp = 65,536 (0.40 ms).  It has no serial chain:
// the previous step's normalized alpha, which the TPU kernel carries
// because its tiles walk in order, is read from the stream.  So each lane's
// time splits into segments of Tt steps, one thread per (lane, segment),
// enough threads to fill the card; a second kernel sums each lane's
// segments in order (no atomics, so the result is the same every run).
// Only 4 of the K*K xi products of a step are nonzero (previous group x
// current group); they map one to one onto (pair, a, c), so each thread
// keeps 4 S^2 pair bins plus 2S emission bins in its own slice of shared
// memory (bank-conflict free: thread i owns bank i mod 32) and the second
// kernel writes bin (s_prev, s_cur, a, c) to macc row
// gt[s_prev, a] * K + gt[s_cur, c].  The sums run in another order than
// the plain version's, which agrees within a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_S 16
#define MAX_TAB ((MAX_S * MAX_S + 1) * 4)
#define FB_THREADS 32
#define LOOKAHEAD 16
#define REDUCE_THREADS 128

// ---------------------------------------------------------------------------
// B4: the forward and the self-normalized backward chain of each lane.

__device__ __forceinline__ void load_group(const int32_t* p, size_t stride, int first,
                                           int step, int Tp, int nreal,
                                           int (&q)[LOOKAHEAD]) {
#pragma unroll
  for (int r = 0; r < LOOKAHEAD; ++r) {
    const int t = first + step * r;
    const int v = (t >= 0 && t < Tp) ? __ldg(p + (size_t)t * stride) : nreal;
    q[r] = v < nreal ? v : nreal;  // PAD pairs -> the identity row
  }
}

__global__ void __launch_bounds__(FB_THREADS)
oh_fwdbwd_kernel(const int32_t* __restrict__ pair, const int32_t* __restrict__ pairn,
                 const int32_t* __restrict__ lens, const float* __restrict__ a0,
                 const float* __restrict__ beta0, const float* __restrict__ tab,
                 float* __restrict__ alphas, float* __restrict__ betas,
                 int Tp, int NL, int nreal, int T) {
  __shared__ float s_tab[MAX_TAB];
  for (int i = threadIdx.x; i < (nreal + 1) * 4; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int len = lens[n];
  int q[LOOKAHEAD], qn[LOOKAHEAD];

  if (blockIdx.y == 0) {
    // Forward: alpha_t = (alpha_{t-1} . M_t) * (1 / sum alpha_{t-1}) on
    // valid steps; the entering vector at t == 0; carried past len.
    const float e0 = a0[n], e1 = a0[nl + n];
    float v0 = e0, v1 = e1;
    const int32_t* p = pair + n;
    float* out = alphas + n;
    load_group(p, nl, 0, 1, Tp, nreal, q);
    for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
      load_group(p, nl, t0 + LOOKAHEAD, 1, Tp, nreal, qn);
#pragma unroll
      for (int r = 0; r < LOOKAHEAD; ++r) {
        const int t = t0 + r;
        if (t < Tp) {
          const float* m = s_tab + 4 * q[r];
          const float inv = __fdiv_rn(1.0f, __fadd_rn(v0, v1));
          const float raw0 = __fadd_rn(__fmul_rn(v0, m[0]), __fmul_rn(v1, m[2]));
          const float raw1 = __fadd_rn(__fmul_rn(v0, m[1]), __fmul_rn(v1, m[3]));
          if (t == 0) {
            v0 = e0;
            v1 = e1;
          } else if (t < len) {
            v0 = __fmul_rn(raw0, inv);
            v1 = __fmul_rn(raw1, inv);
          }
          out[(size_t)(2 * t) * nl] = v0;
          out[(size_t)(2 * t + 1) * nl] = v1;
        }
      }
#pragma unroll
      for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
    }
  } else {
    // Backward, t = Tp-1 down to 0: beta_t = (M_{t+1} . beta_{t+1}) *
    // (1 / sum beta_{t+1}) where t <= T-2 and t+1 < len, else carried.
    float b0 = beta0[n], b1 = beta0[nl + n];
    const int32_t* p = pairn + n;
    float* out = betas + n;
    load_group(p, nl, Tp - 1, -1, Tp, nreal, q);
    for (int k0 = 0; k0 < Tp; k0 += LOOKAHEAD) {
      load_group(p, nl, Tp - 1 - (k0 + LOOKAHEAD), -1, Tp, nreal, qn);
#pragma unroll
      for (int r = 0; r < LOOKAHEAD; ++r) {
        const int t = Tp - 1 - (k0 + r);
        if (t >= 0) {
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
}

// ---------------------------------------------------------------------------
// B7: the per-lane transfer products.

__global__ void __launch_bounds__(FB_THREADS)
oh_prod_kernel(const int32_t* __restrict__ pair, const float* __restrict__ tab,
               float* __restrict__ out, int Tp, int NL, int nreal) {
  __shared__ float s_tab[MAX_TAB];
  for (int i = threadIdx.x; i < (nreal + 1) * 4; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int32_t* p = pair + n;
  float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
  int q[LOOKAHEAD], qn[LOOKAHEAD];
  load_group(p, nl, 0, 1, Tp, nreal, q);
  for (int t0 = 0; t0 < Tp; t0 += LOOKAHEAD) {
    load_group(p, nl, t0 + LOOKAHEAD, 1, Tp, nreal, qn);
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) {
      if (t0 + r < Tp) {
        // new[i, c] = C[i, 0] * T[0, c] + C[i, 1] * T[1, c], then each
        // entry over the total (fb_onehot.py:162-167, the twin's order).
        const float* m = s_tab + 4 * q[r];
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
    }
#pragma unroll
    for (int r = 0; r < LOOKAHEAD; ++r) q[r] = qn[r];
  }
  out[n] = c00;
  out[nl + n] = c01;
  out[2 * nl + n] = c10;
  out[3 * nl + n] = c11;
}

// ---------------------------------------------------------------------------
// B5: z-normalized counts.  Per-lane accumulator rows (R = 4 S^2 + 2S + 1):
// [0, 4 S^2) pair bins ((s_prev * S + s_cur) * 4 + a * 2 + c), then the 2S
// emission rows (2 * s + a), then the loglik.

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
  const int nreal = S * S;
  const int EMIT = 4 * nreal;
  const int LL = EMIT + 2 * S;
  const int R = LL + 1;
  const int bd = blockDim.x;
  for (int i = threadIdx.x; i < (nreal + 1) * 4; i += bd) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < 2 * S; i += bd) {
    s_bred[i] = bred[i];
    s_igt[gt[i]] = i;
  }
  float* my = acc + threadIdx.x;
  for (int r = 0; r < R; ++r) my[r * bd] = 0.0f;
  __syncthreads();

  const int n = blockIdx.x * bd + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int seg = blockIdx.y;
  const int len = min(lens[n], Tp);
  const int t0 = seg * Tt;
  const int t1 = min(t0 + Tt, len);
  if (t0 < t1) {
    // Normalized alpha of the step before the segment.
    float ah0 = 0.0f, ah1 = 0.0f;
    if (t0 > 0) {
      const float p0 = alphas[(size_t)(2 * t0 - 2) * nl + n];
      const float p1 = alphas[(size_t)(2 * t0 - 1) * nl + n];
      const float ic = 1.0f / fmaxf(p0 + p1, 1e-30f);
      ah0 = p0 * ic;
      ah1 = p1 * ic;
    }
    float ll = 0.0f;
    for (int t = t0; t < t1; ++t) {
      const float a0 = alphas[(size_t)(2 * t) * nl + n];
      const float a1 = alphas[(size_t)(2 * t + 1) * nl + n];
      const float be0 = betas[(size_t)(2 * t) * nl + n];
      const float be1 = betas[(size_t)(2 * t + 1) * nl + n];
      const int p = pair[(size_t)t * nl + n];
      // A PAD pair carries its symbol: previous and current are both it.
      const int esym = p < nreal ? p % S : p - nreal;
      const int sprev = p < nreal ? p / S : esym;
      const float cs = a0 + a1;
      const float inv_cs = 1.0f / fmaxf(cs, 1e-30f);
      const float g0 = a0 * be0, g1 = a1 * be1;
      const float inv_g = 1.0f / fmaxf(g0 + g1, 1e-30f);
      my[(EMIT + 2 * esym) * bd] += g0 * inv_g;
      my[(EMIT + 2 * esym + 1) * bd] += g1 * inv_g;
      ll += logf(fmaxf(cs, 1e-30f));
      const float* m = s_tab + 4 * (p < nreal ? p : nreal);
      // z = sum_ac aprev[a] T[a, c] beta[c]; xi[a, c] = aprev[a] w[c] / z
      // with w[c] = B_red[esym, c] beta[c] (the table supplies A * B).
      if (t > 0) {
        const float z = ah0 * (m[0] * be0 + m[1] * be1) + ah1 * (m[2] * be0 + m[3] * be1);
        const float inv_z = 1.0f / fmaxf(z, 1e-30f);
        const float wz0 = s_bred[2 * esym] * be0 * inv_z;
        const float wz1 = s_bred[2 * esym + 1] * be1 * inv_z;
        float* bin = my + ((sprev * S + esym) * 4) * bd;
        bin[0] += ah0 * wz0;
        bin[bd] += ah0 * wz1;
        bin[2 * bd] += ah1 * wz0;
        bin[3 * bd] += ah1 * wz1;
      } else if (pair0m[n] != 0.0f) {
        // Within-lane t == 0: the previous alpha is the entering message
        // (reduced for z, full K for the counts), masked by pair0m.
        const float e0 = enters_red[n], e1 = enters_red[nl + n];
        const float z = e0 * (m[0] * be0 + m[1] * be1) + e1 * (m[2] * be0 + m[3] * be1);
        const float inv_z = pair0m[n] * (1.0f / fmaxf(z, 1e-30f));
        const float wz0 = s_bred[2 * esym] * be0 * inv_z;
        const float wz1 = s_bred[2 * esym + 1] * be1 * inv_z;
        for (int i = 0; i < K; ++i) {
          const float ef = enters_full[(size_t)i * nl + n];
          const int sa = s_igt[i];
          float* bin = my + (((sa >> 1) * S + esym) * 4 + (sa & 1) * 2) * bd;
          bin[0] += ef * wz0;
          bin[bd] += ef * wz1;
        }
      }
      ah0 = a0 * inv_cs;
      ah1 = a1 * inv_cs;
    }
    my[LL * bd] = ll;
  }
  float* out = part + (size_t)seg * R * nl + n;
  for (int r = 0; r < R; ++r) out[(size_t)r * nl] = my[r * bd];
}

__global__ void __launch_bounds__(REDUCE_THREADS)
oh_seq_stats_reduce_kernel(const float* __restrict__ part, const int32_t* __restrict__ gt,
                           float* __restrict__ macc, float* __restrict__ emit,
                           float* __restrict__ ll, int nseg, int NL, int S, int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= NL) return;
  const size_t nl = (size_t)NL;
  const int r = blockIdx.y;
  const int nbins = 4 * S * S;
  const int R = nbins + 2 * S + 1;
  float s = 0.0f;
  for (int g = 0; g < nseg; ++g) s += part[((size_t)g * R + r) * nl + n];
  if (r < nbins) {
    const int p = r >> 2, a = (r >> 1) & 1, c = r & 1;
    const int row = gt[2 * (p / S) + a] * K + gt[2 * (p % S) + c];
    macc[(size_t)row * nl + n] = s;
  } else if (r < nbins + 2 * S) {
    emit[(size_t)(r - nbins) * nl + n] = s;
  } else {
    ll[n] = s;
  }
}

// The C interface: every pointer and the stream arrive as void*, sizes as
// int.  Each function launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.
extern "C" {

int oh_prod(const void* pair, const void* tab, void* out, int Tp, int NL, int nreal,
            void* stream) {
  if (nreal < 1 || nreal > MAX_S * MAX_S || Tp <= 0 || NL <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((NL + FB_THREADS - 1) / FB_THREADS);
  oh_prod_kernel<<<blocks, FB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pair, (const float*)tab, (float*)out, Tp, NL, nreal);
  return (int)cudaGetLastError();
}

int oh_fwdbwd(const void* pair, const void* pairn, const void* lens, const void* a0,
              const void* beta0, const void* tab, void* alphas, void* betas, int Tp,
              int NL, int nreal, int T, void* stream) {
  if (nreal < 1 || nreal > MAX_S * MAX_S || Tp <= 0 || NL <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((NL + FB_THREADS - 1) / FB_THREADS), 2);
  oh_fwdbwd_kernel<<<grid, FB_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pair, (const int32_t*)pairn, (const int32_t*)lens, (const float*)a0,
      (const float*)beta0, (const float*)tab, (float*)alphas, (float*)betas, Tp, NL, nreal, T);
  return (int)cudaGetLastError();
}

int oh_seq_stats(const void* alphas, const void* betas, const void* pair, const void* lens,
                 const void* tab, const void* bred, const void* gt, const void* enters_full,
                 const void* enters_red, const void* pair0m, void* part, void* macc,
                 void* emit, void* ll, int Tp, int NL, int S, int K, int Tt, void* stream) {
  if (S < 1 || S > MAX_S || K != 2 * S || Tp <= 0 || NL <= 0 || Tt <= 0)
    return (int)cudaErrorInvalidValue;
  const int R = 4 * S * S + 2 * S + 1;
  const int nseg = (Tp + Tt - 1) / Tt;
  if (nseg > 65535) return (int)cudaErrorInvalidValue;
  const int threads = (size_t)R * 128 * sizeof(float) <= 200 * 1024 ? 128 : 32;
  const size_t smem = (size_t)R * threads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        oh_seq_stats_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((NL + threads - 1) / threads), (unsigned)nseg);
  oh_seq_stats_part_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)alphas, (const float*)betas, (const int32_t*)pair, (const int32_t*)lens,
      (const float*)tab, (const float*)bred, (const int32_t*)gt, (const float*)enters_full,
      (const float*)enters_red, (const float*)pair0m, (float*)part, Tp, NL, S, K, Tt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((unsigned)((NL + REDUCE_THREADS - 1) / REDUCE_THREADS), (unsigned)R);
  oh_seq_stats_reduce_kernel<<<rgrid, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const int32_t*)gt, (float*)macc, (float*)emit, (float*)ll, nseg,
      NL, S, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
