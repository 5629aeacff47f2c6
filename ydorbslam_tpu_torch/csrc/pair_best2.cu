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
// (second) and the column of the best (idx), under K2's sequential rule
// (best2.cuh): the lowest column wins a tie, a tied duplicate counts as
// second, the sentinels are 10000 and idx stays -1 when no column passes.
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
// What bounds it on an H100: operations.  The gate costs 18 lane
// operations per pair ("proj") or 11 ("epi"), and only the pairs that pass
// it need the distance (8 __popc, 15 more operations) and the update.  At
// the main path's shapes, B = 20 and M = N = 1024 ("proj") is 21 M pairs,
// ~11 us at 33.5 T lane-ops/s, and B = 10 ("epi") 10.5 M pairs, ~3.5 us;
// the bytes (B * (M + N) * 64) take under 1 us at 3.35 TB/s.
// chip_smoke.py computes the bound of each run from its inputs.
//
// Design: K2's (proj_best2.cu), with the same merge and queue
// (best2.cuh).  The pair is the grid's y axis.  A warp owns a-rows of its
// pair; its lanes split the columns of the staged b-tile, and the lane
// states are merged exactly by best2::warp_merge.  "proj" gates one row at
// a time behind the pre-test of its window; "epi" has no such pre-test,
// so a warp gates 4 rows at once against each b value it reads.  A block
// serves 8 to 128 a-rows of one pair (best2::rows_per_warp over the B
// pairs) and stages that pair's b-side once per tile of 512 columns,
// double-buffered with cp.async, descriptors as rows and the gate's
// attribute lanes word-major.  The mode is a template parameter.  M and N
// are arbitrary (no 128-multiples, the TPU tiling's constraint).

#include "best2.cuh"

namespace {

using best2::kPitch;
using best2::kTile;

enum Mode { kProj = 0, kEpi = 1 };

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

// b lanes the gates read: proj 0-5 (lane 5 is isf2), epi 0-4.
template <int MODE>
__host__ __device__ constexpr int attr_lanes() {
  return MODE == kProj ? 6 : 5;
}

// A-rows a warp scans together, sharing each staged b value it reads:
// "epi" has no cheap pre-test to skip columns, so its cost is the gate of
// every pair, and 4 rows per read of b cut its shared-memory loads and
// loop overhead 4-fold.  "proj" keeps one row, whose pre-test skips most
// column groups (a union over 4 rows would skip few).
template <int MODE>
__host__ __device__ constexpr int rows_together() {
  return MODE == kEpi ? 4 : 1;
}

// Adds the queued pair of this lane to its row's state: e = its column in
// the window that starts at w0 | i << 16 for row i of the RB scanned
// together, whose descriptor is at a_rows + i * a_stride; -1: none.
template <int RB>
__device__ __forceinline__ void take(int e, const uint32_t* a_rows, int a_stride,
                                     const uint32_t* smem, int stage_words, int w0,
                                     best2::State (&s)[RB]) {
  if (e < 0) return;
  const int c = w0 + (e & 0xffff), i = e >> 16;
  const uint32_t* ar = a_rows + i * a_stride;
  const int d = best2::distance(*reinterpret_cast<const uint4*>(ar),
                                *reinterpret_cast<const uint4*>(ar + 4),
                                best2::Group(smem, stage_words, c).row(0));
#pragma unroll
  for (int j = 0; j < RB; ++j) best2::update(s[j], i == j ? d : best2::kInvalid, c);
}

// The window part of the "proj" gate, computed as gate() computes it, so
// a column that fails it fails the gate.
__device__ __forceinline__ bool near(const float* a, float bu, float bv) {
  return (fabsf(__fsub_rn(bu, a[0])) <= a[3]) & (fabsf(__fsub_rn(bv, a[1])) <= a[3]);
}

template <int MODE>
__global__ void __launch_bounds__(best2::kWarps * 32)
pair_best2_kernel(const uint32_t* __restrict__ desc_a, const float* __restrict__ attr_a,
                  const uint32_t* __restrict__ desc_b, const float* __restrict__ attr_b,
                  int B, int M, int N, int rows_per_warp, int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int A = attr_lanes<MODE>();
  constexpr int kStage = best2::stage_words<A>();
  constexpr int kValidA = MODE == kProj ? 7 : 5;
  // The octave lanes every gate compares first: a[kOctA] (oct_lo, or the
  // a octave) and b[3].  A NaN there fails the gate whatever the rest.
  constexpr int kOctA = MODE == kProj ? 5 : 4;
  const float nan = __int_as_float(0x7fffffff);
  constexpr int kWarps = best2::kWarps;
  constexpr int RB = rows_together<MODE>();
  // 32-column chunks per group, so that a group's (row, chunk) hits fill
  // the kGroup bits of a queue push.
  constexpr int G = best2::kGroup / RB;
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_first = blockIdx.x * kWarps * rows_per_warp;  // row k of this warp: warp + k * kWarps
  const int rows = min(rows_per_warp, (M - m_first - warp + kWarps - 1) / kWarps);
  const uint32_t* db = desc_b + static_cast<size_t>(p) * N * 8;
  const float* ab = attr_b + static_cast<size_t>(p) * N * 8;
  const uint32_t* s_rows = smem + best2::rows_offset<A>();
  int* queue = reinterpret_cast<int*>(smem + best2::queue_offset<A>()) + warp * best2::kQueue;
  best2::State* merged = reinterpret_cast<best2::State*>(smem + best2::states_offset<A>());
  if (lane == 0) {
    for (int k = 0; k < rows; ++k) merged[warp + k * kWarps] = best2::empty();
  }

  // Scans the staged columns [w0, w0 + n) for the rows of this warp, RB
  // at a time, and merges each row's state into merged[r].  Row i of a
  // set is row k0 + i of the warp, block row warp + (k0 + i) * kWarps.
  auto scan = [&](int w0, int n) {
    constexpr int kStride = kWarps * best2::kRowWords;  // between rows i and i + 1
    for (int k0 = 0; k0 < rows; k0 += RB) {
      const uint32_t* a_rows = s_rows + (warp + k0 * kWarps) * best2::kRowWords;
      float at[RB][8];
      bool any = false;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const uint32_t* ar = a_rows + i * kStride;
        const float4 at0 = k0 + i < rows ? *reinterpret_cast<const float4*>(ar + 8) : float4{};
        const float4 at1 = k0 + i < rows ? *reinterpret_cast<const float4*>(ar + 12) : float4{};
        const float t[8] = {at0.x, at0.y, at0.z, at0.w, at1.x, at1.y, at1.z, at1.w};
#pragma unroll
        for (int l = 0; l < 8; ++l) at[i][l] = t[l];
        // An invalid a-row (or none) passes no column.
        const bool valid = at[i][kValidA] > 0.5f;
        any |= valid;
        at[i][kOctA] = valid ? at[i][kOctA] : nan;
      }
      if (!any) continue;  // warp-uniform
      best2::State s[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) s[i] = best2::empty();
      int queued = 0;
      for (int g0 = 0; g0 < n; g0 += 32 * G) {
        // Lane l takes columns g0 + 32 u + l, u < G, of the window; past
        // its end they read stale staged values and are masked.
        const best2::Group grp(smem, kStage, w0 + g0);
        const float* s_attr = best2::attrs(grp.stage) + grp.base + lane;
        const int lim = n - g0 - lane;  // column u is in the window iff 32 u < lim
        unsigned todo = (1u << G) - 1u;  // the chunks to gate
        if (MODE == kProj) {
          unsigned pre = 0u;
#pragma unroll
          for (int u = 0; u < G; ++u) {
            pre |= static_cast<unsigned>((32 * u < lim) &
                                         near(at[0], s_attr[32 * u], s_attr[kPitch + 32 * u])) << u;
          }
          todo = __reduce_or_sync(0xffffffffu, pre);
          if (todo == 0u) continue;  // warp-uniform
        }
        unsigned hits = 0u;  // bit i * G + u: row i passes at chunk u
#pragma unroll
        for (int u = 0; u < G; ++u) {
          if (!((todo >> u) & 1u)) continue;  // warp-uniform
          float bt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int l = 0; l < A; ++l) bt[l] = s_attr[l * kPitch + 32 * u];
          bt[3] = (32 * u < lim) & (bt[4] > 0.5f) ? bt[3] : nan;  // column out or invalid
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const bool g = gate<MODE>(at[i], bt);
            hits |= static_cast<unsigned>(g) << (i * G + u);
          }
        }
        if (!__any_sync(0xffffffffu, hits != 0u)) continue;
        queued = best2::queue_push(queue, queued, hits, [&](int bit) {
          return (g0 + 32 * (bit % G) + lane) | (bit / G) << 16;
        });
        int head = 0;
        for (; queued - head >= 32; head += 32) {
          take(best2::queue_take(queue, head, 32), a_rows, kStride, smem, kStage, w0, s);
        }
        if (head > 0) queued = best2::queue_compact(queue, head, queued);
      }
      if (queued > 0) {  // warp-uniform
        take(best2::queue_take(queue, 0, queued), a_rows, kStride, smem, kStage, w0, s);
        __syncwarp();  // taken before the next rows append
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (k0 + i >= rows) break;  // warp-uniform
        const best2::State t = best2::warp_merge(s[i]);
        const int r = warp + (k0 + i) * kWarps;
        if (lane == 0) merged[r] = best2::merge(merged[r], t);
      }
    }
  };

  // The block's a-rows join the first stage's copy.
  best2::stage_rows(smem + best2::rows_offset<A>(), desc_a, attr_a,
                    static_cast<size_t>(p) * M + m_first, min(kWarps * rows_per_warp, M - m_first));
  if (N <= 2 * kTile) {
    // The main path's N = 1024: both stages hold all columns, one scan.
    best2::stage<A>(smem, db, ab, 0, min(kTile, N));
    if (N > kTile) best2::stage<A>(smem + kStage, db, ab, kTile, N - kTile);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (N > 0) scan(0, N);
  } else {
    // Tiles of kTile columns, the next one copied while this one is scanned.
    const int n_tiles = (N + kTile - 1) / kTile;
    best2::stage<A>(smem, db, ab, 0, kTile);
    for (int j = 0; j < n_tiles; ++j) {
      const int j0 = j * kTile;
      if (j + 1 < n_tiles) {
        best2::stage<A>(smem + ((j + 1) & 1) * kStage, db, ab, j0 + kTile,
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
  const size_t plane = static_cast<size_t>(B) * M;
  if (lane == 0) {
    for (int k = 0; k < rows; ++k) {
      const int r = warp + k * kWarps;
      const size_t o = static_cast<size_t>(p) * M + m_first + r;
      out[o] = merged[r].idx;
      out[plane + o] = merged[r].best;
      out[2 * plane + o] = merged[r].second;
    }
  }
}

template <int MODE>
cudaError_t launch(const uint32_t* da, const float* aa, const uint32_t* db, const float* ab,
                   int B, int M, int N, int* out, cudaStream_t stream) {
  constexpr int smem = best2::smem_bytes<attr_lanes<MODE>(), 1>();
  static std::atomic<int> resident[best2::kMaxDevices];
  int slots = 0;
  const cudaError_t err =
      best2::resident_blocks(pair_best2_kernel<MODE>, smem, resident, slots);
  if (err != cudaSuccess) return err;
  const int rows = best2::rows_per_warp(slots, M, B, rows_together<MODE>());
  const dim3 grid(best2::row_blocks(M, rows), B);
  pair_best2_kernel<MODE><<<grid, best2::kWarps * 32, smem, stream>>>(da, aa, db, ab, B, M, N,
                                                                    rows, out);
  return cudaGetLastError();
}

}  // namespace

// out: (3, B, M) int32 planes idx, best, second.  mode 0 = "proj",
// 1 = "epi".  The wrapper (ops/kernels.py) passes 0 < M, 0 < B < 65536,
// B * max(M, N) * 8 < 2^62, the tensors' device and a stream on it, and
// desc_a, attr_a and desc_b at 16-byte boundaries.
extern "C" int ydorb_pair_best2(const void* desc_a, const float* attr_a,
                                const void* desc_b, const float* attr_b,
                                int B, int M, int N, int mode, int* out, int device,
                                cudaStream_t stream) {
  const ydorb::DeviceGuard guard(device);
  const uint32_t* da = static_cast<const uint32_t*>(desc_a);
  const uint32_t* db = static_cast<const uint32_t*>(desc_b);
  const cudaError_t err = mode == kEpi
                              ? launch<kEpi>(da, attr_a, db, attr_b, B, M, N, out, stream)
                              : launch<kProj>(da, attr_a, db, attr_b, B, M, N, out, stream);
  return static_cast<int>(err);
}
