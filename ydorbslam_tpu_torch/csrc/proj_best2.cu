// K2: gated Hamming best/second search for 256-bit descriptors, for a
// narrow and a wide window radius in one pass.
//
// Replaces the Pallas TPU kernel ydorbslam_tpu/ops/pallas_kernels.py
// proj_best2_pallas (kernel body _proj_best2_kernel).
//
// What it computes, for every a-row m against every b-column n:
//   gate(r) = valid_a && valid_b && oct_lo <= octave_b <= oct_hi
//             && |u_b - u_a| <= r && |v_b - v_a| <= r
//             && (!check_ur || right_u_b < 0 || |right_u_b - ur_a| <= r)
//   d       = popcount(desc_a[m] ^ desc_b[n]) over the 8 uint32 words.
// and per radius (narrow, wide) the smallest gated d (best), the second
// smallest (second) and the column of the best (idx).  The rule is the
// TPU kernel's: columns are visited in ascending order and
//   if (d < best) { second = best; best = d; idx = n; }
//   else if (d < second) { second = d; }
// so the lowest column wins a tie, a tied duplicate of the best counts
// as second, both start at the sentinel 10000 and idx stays -1 when no
// column passes.  The attribute lanes are those of the JAX package:
//   attr_a (M, 8): u, v, ur_pred, r_narrow, r_wide, oct_lo, oct_hi, valid
//   attr_b (N, 8): u, v, right_u, octave, valid, -, -, -
// Gates compare float32 values exactly as the plain PyTorch version does
// (ydorbslam_tpu_torch/ops/hamming.py::proj_best2_plain), so the results
// are identical.
//
// What bounds it on an H100: integer and compare throughput.  At the
// slice's M = N = 1024 it is 1 M pairs, ~8 M popcounts and ~10 compares
// per pair; the 72 KB of inputs are L2-resident.  With one thread per
// a-row, M = 1024 gives only 16 blocks, so most SMs idle: latency, not
// throughput, sets the time at this size.
//
// Design: one thread per a-row keeps its descriptor, attributes and the
// six running results in registers.  The block stages 128 b-columns at a
// time (descriptors and attributes) in shared memory, where every thread
// reads the same column at the same time (a broadcast, no bank
// conflicts).  The descriptor XOR + __popc runs only for pairs that pass
// a gate.  b is read in its natural (N, 8) row layout; the TPU kernel's
// transposed b-side is a Mosaic layout workaround and is not carried
// over, nor are its 128-multiple shapes: M and N are arbitrary and the
// ragged edges are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;    // a-rows per block, one thread each
constexpr int kTileN = 128;  // b-columns staged per shared-memory tile
constexpr int kInvalid = 10000;

__device__ __forceinline__ void update(int d, int n, int& best, int& second, int& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = n;
  } else if (d < second) {
    second = d;
  }
}

__global__ void __launch_bounds__(kRows)
proj_best2_kernel(const uint32_t* __restrict__ desc_a, const float* __restrict__ attr_a,
                  const uint32_t* __restrict__ desc_b, const float* __restrict__ attr_b,
                  int M, int N, int check_ur, int* __restrict__ out) {
  __shared__ uint32_t s_desc[kTileN][8];
  __shared__ float s_u[kTileN], s_v[kTileN], s_ur[kTileN], s_oct[kTileN];
  __shared__ int s_valid[kTileN];

  const int m = blockIdx.x * kRows + threadIdx.x;
  const bool live = m < M;
  uint32_t a[8];
  float au = 0.f, av = 0.f, aur = 0.f, rn = 0.f, rw = 0.f, lo = 0.f, hi = 0.f;
  bool aval = false;
  if (live) {
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = desc_a[m * 8 + w];
    const float* at = attr_a + m * 8;
    au = at[0]; av = at[1]; aur = at[2]; rn = at[3]; rw = at[4];
    lo = at[5]; hi = at[6]; aval = at[7] > 0.5f;
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = 0u;
  }

  int best_n = kInvalid, second_n = kInvalid, idx_n = -1;
  int best_w = kInvalid, second_w = kInvalid, idx_w = -1;
  for (int j0 = 0; j0 < N; j0 += kTileN) {
    const int n_tile = min(kTileN, N - j0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < n_tile * 8; i += kRows) {
      s_desc[i / 8][i % 8] = desc_b[(j0 + i / 8) * 8 + i % 8];
    }
    for (int t = threadIdx.x; t < n_tile; t += kRows) {
      const float* bt = attr_b + (j0 + t) * 8;
      s_u[t] = bt[0];
      s_v[t] = bt[1];
      s_ur[t] = bt[2];
      s_oct[t] = bt[3];
      s_valid[t] = bt[4] > 0.5f;
    }
    __syncthreads();
    if (!aval) continue;
    for (int t = 0; t < n_tile; ++t) {
      if (!s_valid[t] || s_oct[t] < lo || s_oct[t] > hi) continue;
      const float du = fabsf(s_u[t] - au);
      const float dv = fabsf(s_v[t] - av);
      const bool ur_free = !check_ur || s_ur[t] < 0.f;
      const float dur = fabsf(s_ur[t] - aur);
      const bool gn = du <= rn && dv <= rn && (ur_free || dur <= rn);
      const bool gw = du <= rw && dv <= rw && (ur_free || dur <= rw);
      if (!gn && !gw) continue;
      int d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ s_desc[t][w]);
      if (gn) update(d, j0 + t, best_n, second_n, idx_n);
      if (gw) update(d, j0 + t, best_w, second_w, idx_w);
    }
  }
  if (!live) return;
  out[0 * M + m] = idx_n;
  out[1 * M + m] = best_n;
  out[2 * M + m] = second_n;
  out[3 * M + m] = idx_w;
  out[4 * M + m] = best_w;
  out[5 * M + m] = second_w;
}

}  // namespace

// out: (6, M) int32 rows idx_n, best_n, second_n, idx_w, best_w, second_w.
// The wrapper (ops/kernels.py) passes 0 < M < 2^28 and N < 2^28, so the
// row offsets m * 8 and n * 8 fit an int.
extern "C" int ydorb_proj_best2(const void* desc_a, const float* attr_a,
                                const void* desc_b, const float* attr_b,
                                int M, int N, int check_ur, int* out,
                                cudaStream_t stream) {
  const dim3 grid((M + kRows - 1) / kRows);
  proj_best2_kernel<<<grid, kRows, 0, stream>>>(
      static_cast<const uint32_t*>(desc_a), attr_a,
      static_cast<const uint32_t*>(desc_b), attr_b, M, N, check_ur, out);
  return static_cast<int>(cudaGetLastError());
}
