// K4: the bundle-adjustment observation pass of one LM iteration.
//
// Replaces the Pallas TPU kernel ydorbslam_tpu/optim/lm_kernel.py
// lm_obs_pallas (kernel body _lm_obs_kernel).  Local BA launches it once
// per LM iteration plus once per solve: 1 + 5 robust and 1 + 10 plain
// passes, 17 per keyframe.
//
// What it computes, for every observation (o, p) of a point-grouped
// problem with O observation slots per point (inputs (32, O, P) float32,
// row layout I_* of ydorbslam_tpu_torch/optim/lm_kernel.py):
//   x, y, zr = R X + t;  z = max(zr, 1e-6);  u, v, ur projected (stereo);
//   residuals ru, rv, rr;  mask = ok * (zr > 1e-3);  weights wu = inv_s2 *
//   mask, wr = wu * stereo;  chi2;  the Huber IRLS weight and cost
//   (delta^2 5.991 mono, 7.815 stereo) when use_huber;
//   pose Jacobian rows Ju, Jv, Jr (3 x 6) and point Jacobian rows (3 x 3);
// and writes, at (k, o, p) of outq (64, O, P):
//   k = i*6+j:     Hcc[i][j] = sum_c w_c Jc_i[c] Jc_j[c]   (36)
//   k = 36+i:      bc[i]     = sum_c w_c Jc_i[c] r[c]       (6)
//   k = 42+i*3+kk: B[i][kk]  = sum_c w_c Jc_i[c] Jp_kk[c]   (18)
//   k = 60..63:    0
// and at (k, p) of outp (16, P), summed over the point's O observations:
//   k = i*3+j: Hpp[i][j];  k = 9+i: bp[i];  k = 12: robust cost;  13..15: 0.
// The formulas and their order are those of the plain version
// (lm_obs_plain) and of schur._flat_system.  _build.py compiles this file
// with -fmad=false, so no multiply and add are contracted into an FMA and
// each operation rounds once, as in the plain version; what remains is
// the order of the per-point sums over O.  The kernel is held to the
// plain version within rtol 2e-4, atol 2e-3.
//
// What bounds it on an H100: memory.  At the slice's P = 4096, O = 16
// it reads 27 rows and writes 64 + 16/O rows per observation, about
// 25 MB per launch against ~130 flops per observation; at 3.35 TB/s
// that is ~8 us, and the 4096 threads (32 blocks) cannot fill 132 SMs,
// so latency sets the time at this size.
//
// Design: one thread per point p loops over its O observations and keeps
// the 13 per-point sums in registers (the TPU kernel's in-kernel O
// reduction, without atomics, so it is deterministic).  Every read of
// (i, o, p) and every write of (k, o, p) is coalesced across the
// neighbouring points of a warp.  The layout is the TPU kernel's, so the
// caller unpacks kernel and plain outputs the same way; P and O are
// arbitrary (no 512 / 8 multiples).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNin = 32;
constexpr int kOutQ = 64;
constexpr int kOutP = 16;

enum {
  I_R00 = 0, I_T0 = 9, I_X = 12, I_OU = 15, I_OV = 16, I_OR = 17, I_IS2 = 18,
  I_STEREO = 19, I_OK = 20, I_HUB = 21, I_FX = 22, I_FY = 23, I_CX = 24,
  I_CY = 25, I_BF = 26
};

__global__ void __launch_bounds__(kThreads)
lm_obs_kernel(const float* __restrict__ in, int O, int P, float* __restrict__ outq,
              float* __restrict__ outp) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const size_t plane = static_cast<size_t>(O) * P;  // one input/output row
  float acc[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) acc[k] = 0.f;

  for (int o = 0; o < O; ++o) {
    const size_t q = static_cast<size_t>(o) * P + p;
    auto row = [&](int i) { return in[i * plane + q]; };
    float R[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = row(I_R00 + k);
    const float t0 = row(I_T0), t1 = row(I_T0 + 1), t2 = row(I_T0 + 2);
    const float X = row(I_X), Y = row(I_X + 1), Z = row(I_X + 2);
    const float fx = row(I_FX), fy = row(I_FY), cx = row(I_CX), cy = row(I_CY);
    const float bf = row(I_BF);

    const float x = R[0] * X + R[1] * Y + R[2] * Z + t0;
    const float y = R[3] * X + R[4] * Y + R[5] * Z + t1;
    const float zr = R[6] * X + R[7] * Y + R[8] * Z + t2;
    const float z = fmaxf(zr, 1e-6f);
    const float iz = 1.0f / z;
    const float u = fx * x * iz + cx;
    const float v = fy * y * iz + cy;
    const float ur = u - bf * iz;
    const float r[3] = {row(I_OU) - u, row(I_OV) - v, row(I_OR) - ur};

    const float mask = row(I_OK) * (zr > 1e-3f ? 1.f : 0.f);
    const float wu0 = row(I_IS2) * mask;
    const float stereo = row(I_STEREO);
    const float wr0 = wu0 * stereo;
    const float chi2 = r[0] * r[0] * wu0 + r[1] * r[1] * wu0 + r[2] * r[2] * wr0;
    const float delta2 = stereo > 0.5f ? 7.815f : 5.991f;
    const bool use_huber = row(I_HUB) > 0.5f;
    const float s = sqrtf(fmaxf(chi2, 1e-12f));
    const float d = sqrtf(delta2);
    const float rho = chi2 <= delta2 ? chi2 : 2.0f * d * s - delta2;
    const float cost = (use_huber ? rho : chi2) * mask;
    const float hub =
        (use_huber && chi2 > delta2) ? sqrtf(delta2 / fmaxf(chi2, 1e-12f)) : 1.f;
    const float w[3] = {wu0 * hub, wu0 * hub, wr0 * hub};

    const float iz2 = iz * iz;
    const float a = fx * iz;
    const float c3 = -fx * x * iz2;
    const float dd = fy * iz;
    const float e = -fy * y * iz2;
    const float cr = c3 + bf * iz2;
    // Jc[i][c]: pose Jacobian column i of residual row c (u, v, ur).
    const float Jc[6][3] = {
        {-a, 0.f, -a},
        {0.f, -dd, 0.f},
        {-c3, -e, -cr},
        {-c3 * y, -(-dd * z + e * y), -cr * y},
        {-(a * z - c3 * x), e * x, -(a * z - cr * x)},
        {a * y, -dd * x, a * y},
    };
    // Jp[k][c]: point Jacobian column k of residual row c.
    float Jp[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Jp[k][0] = -(a * R[k] + c3 * R[6 + k]);
      Jp[k][1] = -(dd * R[3 + k] + e * R[6 + k]);
      Jp[k][2] = -(a * R[k] + cr * R[6 + k]);
    }
    auto rowsum = [&](const float* A, const float* Bv) {
      return w[0] * A[0] * Bv[0] + w[1] * A[1] * Bv[1] + w[2] * A[2] * Bv[2];
    };

    float* oq = outq + q;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) oq[(i * 6 + j) * plane] = rowsum(Jc[i], Jc[j]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) oq[(36 + i) * plane] = rowsum(Jc[i], r);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) oq[(42 + i * 3 + k) * plane] = rowsum(Jc[i], Jp[k]);
    }
#pragma unroll
    for (int k = 60; k < kOutQ; ++k) oq[k * plane] = 0.f;

#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[i * 3 + j] += rowsum(Jp[i], Jp[j]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[9 + i] += rowsum(Jp[i], r);
    acc[12] += cost;
  }
#pragma unroll
  for (int k = 0; k < 13; ++k) outp[static_cast<size_t>(k) * P + p] = acc[k];
#pragma unroll
  for (int k = 13; k < kOutP; ++k) outp[static_cast<size_t>(k) * P + p] = 0.f;
}

}  // namespace

// in: (32, O, P) float32; outq: (64, O, P); outp: (16, P).  The wrapper
// (ops/kernels.py) passes 0 < P, 0 < O and 64 * O * P < 2^62.
extern "C" int ydorb_lm_obs(const float* in, int O, int P, float* outq, float* outp,
                            cudaStream_t stream) {
  static_assert(kNin == 32, "input rows");
  const dim3 grid((P + kThreads - 1) / kThreads);
  lm_obs_kernel<<<grid, kThreads, 0, stream>>>(in, O, P, outq, outp);
  return static_cast<int>(cudaGetLastError());
}
