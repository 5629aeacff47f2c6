// K3: gated Hamming best/second search batched over B keyframe pairs.
//
// Replaces the Pallas TPU kernel ydorbslam_tpu/ops/pallas_kernels.py
// pair_best2_pallas (kernel body _pair_best2_kernel).  Local mapping runs
// it three times per keyframe: the triangulation search against the 10
// covisible neighbours (mode "epi") and the two fusion passes against the
// first- and second-order neighbours (mode "proj", B = 20).
//
// What it computes, for every pair p, a-row m and b-column n:
//   gate  = mode-specific (below) && valid_a && valid_b
//   d     = popcount(desc_a[p, m] ^ desc_b[p, n]) over 8 uint32 words
// and per (p, m) the smallest gated d (best), the second smallest
// (second) and the column of the best (idx), with K2's rule: columns in
// ascending order, a strict `<` update, so the lowest column wins a tie,
// a tied duplicate counts as second, the sentinels are 10000 and idx
// stays -1 when no column passes.
//   "proj": |u_b-u_a| <= r, |v_b-v_a| <= r, oct_lo <= oct_b <= oct_hi and
//           the fuse chi2 gate (du^2+dv^2+dur^2)*isf2 <= 7.81 when the
//           b keypoint has a right-x, else (du^2+dv^2)*isf2 <= 5.99;
//   "epi":  (a*u_b + b*v_b + c)^2 < thr * sigma2_b and |oct_b-oct_a| <= 1.
// Attribute lanes are those of the JAX package and of the plain version
// (ydorbslam_tpu_torch/ops/hamming.py::pair_gates):
//   proj a: u, v, ur_pred, r, -, oct_lo, oct_hi, valid
//   proj b: u, v, right_u, octave, valid, isf2, -, -
//   epi  a: la, lb, lc, thr, octave, valid, -, -
//   epi  b: u, v, sigma2, octave, valid, -, -, -
// The gate arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn: one rounding
// per operation in the plain version's order, so nvcc cannot contract a
// multiply and an add into an FMA, and a pair on the boundary of the
// epipolar band or the chi2 gate is decided exactly as the plain version
// decides it.  The results are identical.
//
// What bounds it on an H100: integer and compare throughput.  At
// B = 20, M = N = 1024 it is 21 M pairs, each a handful of float
// operations for the gate and, where it passes, 8 XOR + popcount.  The
// inputs (B * (M + N) * 64 bytes, 2.6 MB) sit in L2.
//
// Design: K2's.  One thread per a-row keeps its descriptor, attributes
// and three running results in registers; the grid's y dimension is the
// pair.  The block stages 128 b-columns of its pair at a time, in their
// natural (N, 8) layout, in shared memory, where every thread reads the
// same column at once (a broadcast).  The popcount runs only for pairs
// that pass the gate.  The mode is a template parameter.  M and N are
// arbitrary (no 128-multiples, the TPU tiling's constraint): the ragged
// edges are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;    // a-rows per block, one thread each
constexpr int kTileN = 128;  // b-columns staged per shared-memory tile
constexpr int kInvalid = 10000;

enum Mode { kProj = 0, kEpi = 1 };

__device__ __forceinline__ void update(int d, int n, int& best, int& second, int& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = n;
  } else if (d < second) {
    second = d;
  }
}

template <int MODE>
__device__ __forceinline__ bool gate(const float* a, const float* b) {
  if (MODE == kProj) {
    const float du = __fsub_rn(b[0], a[0]);
    const float dv = __fsub_rn(b[1], a[1]);
    const float dur = __fsub_rn(b[2], a[2]);
    const float mono2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
    const bool chi2_ok =
        b[2] >= 0.f ? __fmul_rn(__fadd_rn(mono2, __fmul_rn(dur, dur)), b[5]) <= 7.81f
                    : __fmul_rn(mono2, b[5]) <= 5.99f;
    return b[3] >= a[5] && b[3] <= a[6] && fabsf(du) <= a[3] && fabsf(dv) <= a[3] &&
           chi2_ok;
  } else {
    const float num = __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])), a[2]);
    return fabsf(__fsub_rn(b[3], a[4])) <= 1.f && __fmul_rn(num, num) < __fmul_rn(a[3], b[2]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kRows)
pair_best2_kernel(const uint32_t* __restrict__ desc_a, const float* __restrict__ attr_a,
                  const uint32_t* __restrict__ desc_b, const float* __restrict__ attr_b,
                  int B, int M, int N, int* __restrict__ out) {
  __shared__ uint32_t s_desc[kTileN][8];
  __shared__ float s_attr[kTileN][8];

  const int p = blockIdx.y;
  const int m = blockIdx.x * kRows + threadIdx.x;
  const bool live = m < M;
  const size_t arow = (static_cast<size_t>(p) * M + (live ? m : 0)) * 8;
  const uint32_t* db = desc_b + static_cast<size_t>(p) * N * 8;
  const float* ab = attr_b + static_cast<size_t>(p) * N * 8;

  uint32_t a[8];
  float at[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    a[w] = live ? desc_a[arow + w] : 0u;
    at[w] = live ? attr_a[arow + w] : 0.f;
  }
  const int valid_lane = MODE == kProj ? 7 : 5;
  const bool aval = live && at[valid_lane] > 0.5f;

  int best = kInvalid, second = kInvalid, idx = -1;
  for (int j0 = 0; j0 < N; j0 += kTileN) {
    const int n_tile = min(kTileN, N - j0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < n_tile * 8; i += kRows) {
      s_desc[i / 8][i % 8] = db[static_cast<size_t>(j0) * 8 + i];
      s_attr[i / 8][i % 8] = ab[static_cast<size_t>(j0) * 8 + i];
    }
    __syncthreads();
    if (!aval) continue;
    for (int t = 0; t < n_tile; ++t) {
      if (!(s_attr[t][4] > 0.5f) || !gate<MODE>(at, s_attr[t])) continue;
      int d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ s_desc[t][w]);
      update(d, j0 + t, best, second, idx);
    }
  }
  if (!live) return;
  const size_t o = static_cast<size_t>(p) * M + m;
  const size_t plane = static_cast<size_t>(B) * M;
  out[o] = idx;
  out[plane + o] = best;
  out[2 * plane + o] = second;
}

}  // namespace

// out: (3, B, M) int32 planes idx, best, second.  mode 0 = "proj",
// 1 = "epi".  The wrapper (ops/kernels.py) passes 0 < M, 0 < B < 65536,
// and B * max(M, N) * 8 < 2^62.
extern "C" int ydorb_pair_best2(const void* desc_a, const float* attr_a,
                                const void* desc_b, const float* attr_b,
                                int B, int M, int N, int mode, int* out,
                                cudaStream_t stream) {
  const dim3 grid((M + kRows - 1) / kRows, B);
  const uint32_t* da = static_cast<const uint32_t*>(desc_a);
  const uint32_t* dbp = static_cast<const uint32_t*>(desc_b);
  if (mode == kEpi) {
    pair_best2_kernel<kEpi><<<grid, kRows, 0, stream>>>(da, attr_a, dbp, attr_b, B, M, N, out);
  } else {
    pair_best2_kernel<kProj><<<grid, kRows, 0, stream>>>(da, attr_a, dbp, attr_b, B, M, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}
