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
// smallest (second) and the column of the best (idx), under the TPU
// kernel's sequential rule (best2.cuh): the lowest column wins a tie, a
// tied duplicate of the best counts as second, both start at the
// sentinel 10000 and idx stays -1 when no column passes.  The attribute
// lanes are those of the JAX package:
//   attr_a (M, 8): u, v, ur_pred, r_narrow, r_wide, oct_lo, oct_hi, valid
//   attr_b (N, 8): u, v, right_u, octave, valid, -, -, -
// Gates compare float32 values exactly as the plain PyTorch version does
// (ydorbslam_tpu_torch/ops/hamming.py::proj_best2_plain), so the results
// are identical.
//
// What bounds it on an H100: operations.  The gate costs 11 lane
// operations per pair (16 with check_ur), and only the pairs that pass it
// need the distance (8 __popc, 15 more operations) and the updates.  At
// the main path's two shapes, counted by chip_smoke.py on the inputs of
// its run (the pairs that pass are < 1 %), that is:
//   1024 x 1024, check_ur (motion search): 1.05 M pairs, ~0.5 us at
//     33.5 T lane-ops/s;
//   8192 x 1024, no check_ur (local-map search): 8.4 M pairs, ~2.8 us.
// The bytes (64 per a-row and per b-column) take under 0.2 us at
// 3.35 TB/s.
//
// Design.  The TPU kernel's serial scan of the columns of each a-row (and
// a first port of it here: one thread per row, 16 blocks at M = 1024) is
// replaced by a split of the columns over the lanes of a warp and an
// exact merge (best2.cuh).  A warp scans an a-row's column groups of 8
// chunks of 32 columns, lane l the columns l, l + 32, ..., after a
// pre-test of the group's |du|, |dv| against the larger radius that
// skips most groups.
// The pairs that pass go to the warp's queue, and the distances are
// computed 32 at a time by the whole warp.  Each lane keeps the six
// running values (best, second, idx per radius) in registers; the 32
// lane states are merged with shuffles (best2::warp_merge).
// A block of 8 warps serves 8 to 128 a-rows (best2::rows_per_warp: the
// fewest rows that fit the grid in one wave), so both main-path shapes
// put every SM to work (128 blocks at M = 1024).  More blocks at
// M = 1024, with a row's columns split over 2 warps, were slower: every
// block stages the whole b-side.  The block stages b in shared memory
// once per tile of 512 columns, double-buffered with cp.async: descriptors as rows
// (read only for queued pairs) and the 5 used attribute lanes word-major,
// so 32 lanes read 32 consecutive words without bank conflicts.  b keeps
// its natural (N, 8) layout in device memory; the TPU kernel's transposed
// b-side and its 128-multiple shapes are not carried over: M and N are
// arbitrary.  The a-rows are staged once and read as 16-byte pieces.
// Popcounting every pair instead of the gated ones (a branch-free
// variant) was slower at every main-path shape (PERF.md).

#include "best2.cuh"

namespace {

using best2::kPitch;
using best2::kTile;

constexpr int kAttrB = 5;  // staged b lanes: u, v, right_u, octave, valid

// Adds the queued pair of this lane to the row's states: e = its column
// in the window that starts at w0 | narrow << 16 | wide << 17; -1: none.
__device__ __forceinline__ void take(int e, const uint4& a0, const uint4& a1, const uint32_t* smem,
                                     int w0, best2::State& sn, best2::State& sw) {
  if (e < 0) return;
  const int c = w0 + (e & 0xffff);
  const int d = best2::distance(a0, a1, best2::Group(smem, best2::stage_words<kAttrB>(), c).row(0));
  best2::update(sn, e & (1 << 16) ? d : best2::kInvalid, c);
  best2::update(sw, e & (1 << 17) ? d : best2::kInvalid, c);
}

__global__ void __launch_bounds__(best2::kWarps * 32)
proj_best2_kernel(const uint32_t* __restrict__ desc_a, const float* __restrict__ attr_a,
                  const uint32_t* __restrict__ desc_b, const float* __restrict__ attr_b,
                  int M, int N, int check_ur, int rows_per_warp, int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kStage = best2::stage_words<kAttrB>();
  constexpr int kWarps = best2::kWarps;
  constexpr int kGroup = best2::kGroup;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_first = blockIdx.x * kWarps * rows_per_warp;  // row k of this warp: warp + k * kWarps
  const int rows = min(rows_per_warp, (M - m_first - warp + kWarps - 1) / kWarps);
  const uint32_t* s_rows = smem + best2::rows_offset<kAttrB>();
  int* queue = reinterpret_cast<int*>(smem + best2::queue_offset<kAttrB>()) + warp * best2::kQueue;
  // Per a-row r, the states merged so far: narrow at 2r, wide at 2r + 1.
  best2::State* merged = reinterpret_cast<best2::State*>(smem + best2::states_offset<kAttrB>());
  if (lane == 0) {
    for (int k = 0; k < rows; ++k) {
      const int r = warp + k * kWarps;
      merged[2 * r] = merged[2 * r + 1] = best2::empty();
    }
  }

  // Scans the staged columns [w0, w0 + n) for each row of this warp and
  // merges the row's states into merged[2r], merged[2r + 1].
  auto scan = [&](int w0, int n) {
    for (int k = 0; k < rows; ++k) {
      const int r = warp + k * kWarps;
      const uint32_t* ar = s_rows + r * best2::kRowWords;
      const float4 at0 = *reinterpret_cast<const float4*>(ar + 8);
      const float4 at1 = *reinterpret_cast<const float4*>(ar + 12);
      if (!(at1.w > 0.5f)) continue;  // invalid a-row: no column passes
      const uint4 a0 = *reinterpret_cast<const uint4*>(ar);
      const uint4 a1 = *reinterpret_cast<const uint4*>(ar + 4);
      const float au = at0.x, av = at0.y, aur = at0.z, rn = at0.w;
      const float rw = at1.x, lo = at1.y, hi = at1.z;
      // Either gate needs |du| and |dv| within the larger radius.
      const float r_max = fmaxf(rn, rw);
      best2::State sn = best2::empty(), sw = best2::empty();
      int queued = 0;
      for (int g0 = 0; g0 < n; g0 += 32 * kGroup) {
        // Lane l takes columns g0 + 32 u + l, u < kGroup, of the window;
        // past its end they read stale staged values and are masked.
        const best2::Group grp(smem, kStage, w0 + g0);
        const float* s_u = best2::attrs(grp.stage) + grp.base + lane;
        const float* s_v = s_u + kPitch;
        const float* s_ur = s_v + kPitch;
        const float* s_oct = s_ur + kPitch;
        const float* s_valid = s_oct + kPitch;
        const int lim = n - g0 - lane;  // column u is in the window iff 32 u < lim
        unsigned pre = 0u;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          pre |= static_cast<unsigned>((32 * u < lim) & (fabsf(s_u[32 * u] - au) <= r_max) &
                                       (fabsf(s_v[32 * u] - av) <= r_max)) << u;
        }
        const unsigned todo = __reduce_or_sync(0xffffffffu, pre);  // the chunks to gate
        if (todo == 0u) continue;  // warp-uniform
        unsigned hits_n = 0u, hits_w = 0u;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (!((todo >> u) & 1u)) continue;  // warp-uniform
          const float oct = s_oct[32 * u], ur = s_ur[32 * u];
          const float du = fabsf(s_u[32 * u] - au);
          const float dv = fabsf(s_v[32 * u] - av);
          const float dur = fabsf(ur - aur);
          const bool base_ok = (32 * u < lim) & (s_valid[32 * u] > 0.5f) & (oct >= lo) & (oct <= hi);
          const bool ur_free = !check_ur | (ur < 0.f);
          const bool gn = base_ok & (du <= rn) & (dv <= rn) & (ur_free | (dur <= rn));
          const bool gw = base_ok & (du <= rw) & (dv <= rw) & (ur_free | (dur <= rw));
          hits_n |= static_cast<unsigned>(gn) << u;
          hits_w |= static_cast<unsigned>(gw) << u;
        }
        const unsigned hits = hits_n | hits_w;
        if (!__any_sync(0xffffffffu, hits != 0u)) continue;
        queued = best2::queue_push(queue, queued, hits, [&](int u) {
          return (g0 + 32 * u + lane) | ((hits_n >> u) & 1u) << 16 | ((hits_w >> u) & 1u) << 17;
        });
        int head = 0;
        for (; queued - head >= 32; head += 32) {
          take(best2::queue_take(queue, head, 32), a0, a1, smem, w0, sn, sw);
        }
        if (head > 0) queued = best2::queue_compact(queue, head, queued);
      }
      if (queued > 0) {  // warp-uniform
        take(best2::queue_take(queue, 0, queued), a0, a1, smem, w0, sn, sw);
        __syncwarp();  // taken before the next row appends
      }
      sn = best2::warp_merge(sn);
      sw = best2::warp_merge(sw);
      if (lane == 0) {
        merged[2 * r] = best2::merge(merged[2 * r], sn);
        merged[2 * r + 1] = best2::merge(merged[2 * r + 1], sw);
      }
    }
  };

  // The block's a-rows join the first stage's copy.
  best2::stage_rows(smem + best2::rows_offset<kAttrB>(), desc_a, attr_a, m_first,
                    min(kWarps * rows_per_warp, M - m_first));
  if (N <= 2 * kTile) {
    // The main path's N = 1024: both stages hold all columns, one scan.
    best2::stage<kAttrB>(smem, desc_b, attr_b, 0, min(kTile, N));
    if (N > kTile) best2::stage<kAttrB>(smem + kStage, desc_b, attr_b, kTile, N - kTile);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (N > 0) scan(0, N);
  } else {
    // Tiles of kTile columns, the next one copied while this one is scanned.
    const int n_tiles = (N + kTile - 1) / kTile;
    best2::stage<kAttrB>(smem, desc_b, attr_b, 0, kTile);
    for (int j = 0; j < n_tiles; ++j) {
      const int j0 = j * kTile;
      if (j + 1 < n_tiles) {
        best2::stage<kAttrB>(smem + ((j + 1) & 1) * kStage, desc_b, attr_b, j0 + kTile,
                             min(kTile, N - j0 - kTile));
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // tile j is in shared memory
      scan(j0, min(kTile, N - j0));
      __syncthreads();  // tile j is consumed before its buffer is refilled
    }
  }
  if (lane == 0) {
    for (int k = 0; k < rows; ++k) {
      const int r = warp + k * kWarps;
      const best2::State n = merged[2 * r], w = merged[2 * r + 1];
      const int m = m_first + r;
      out[0 * M + m] = n.idx;
      out[1 * M + m] = n.best;
      out[2 * M + m] = n.second;
      out[3 * M + m] = w.idx;
      out[4 * M + m] = w.best;
      out[5 * M + m] = w.second;
    }
  }
}

cudaError_t launch(const uint32_t* da, const float* aa, const uint32_t* db, const float* ab,
                   int M, int N, int check_ur, int* out, cudaStream_t stream) {
  constexpr int smem = best2::smem_bytes<kAttrB, 2>();
  static std::atomic<int> resident[best2::kMaxDevices];
  int slots = 0;
  const cudaError_t err = best2::resident_blocks(proj_best2_kernel, smem, resident, slots);
  if (err != cudaSuccess) return err;
  const int rows = best2::rows_per_warp(slots, M, 1, 1);
  proj_best2_kernel<<<best2::row_blocks(M, rows), best2::kWarps * 32, smem, stream>>>(
      da, aa, db, ab, M, N, check_ur, rows, out);
  return cudaGetLastError();
}

}  // namespace

// out: (6, M) int32 rows idx_n, best_n, second_n, idx_w, best_w, second_w.
// The wrapper (ops/kernels.py) passes 0 < M < 2^28, 0 <= N < 2^28, the
// tensors' device and a stream on it, and desc_a, attr_a and desc_b at
// 16-byte boundaries (they are copied as 16-byte pieces).
extern "C" int ydorb_proj_best2(const void* desc_a, const float* attr_a,
                                const void* desc_b, const float* attr_b,
                                int M, int N, int check_ur, int* out, int device,
                                cudaStream_t stream) {
  const ydorb::DeviceGuard guard(device);
  return static_cast<int>(launch(static_cast<const uint32_t*>(desc_a), attr_a,
                                 static_cast<const uint32_t*>(desc_b), attr_b, M, N, check_ur,
                                 out, stream));
}
