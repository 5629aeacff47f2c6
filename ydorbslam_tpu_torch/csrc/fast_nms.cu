// K1: FAST-9 corner score + 3x3 non-maximum suppression + border mask,
// for every pyramid level of a frame in one launch.
//
// Replaces the Pallas TPU kernel ydorbslam_tpu/ops/pallas_kernels.py
// fast_score_nms_pallas (kernel body _fast_nms_kernel), which computes
// nms_and_border(fast_score_map(img), border) of ydorbslam_tpu/ops/fast.py
// for one level per call.
//
// What it computes, per pixel p of each (H, W) float32 level:
//   d_k   = I(p + o_k) - I(p) for the 16 Bresenham circle offsets o_k;
//   score = max(max_k min_{j<9} d_{k+j}, max_k min_{j<9} -d_{k+j}, 0)
//           (the largest threshold that passes the FAST-9 segment test);
//   out   = score if score >= all 8 neighbours' scores (ties survive)
//           and p lies in [border, H - border) x [border, W - border),
//           else 0.  Neighbours outside the image count as -1.
// Pixels beyond the image are read edge-clamped, which is the
// replicate padding of the plain version.  Every step is a subtraction,
// negation, min or max, so any order of evaluation gives the plain
// PyTorch version's values (ydorbslam_tpu_torch/ops/fast.py) exactly; a
// zero may differ in sign.
//
// What bounds it on an H100: operations.  It reads and writes 4 B per
// pixel (950,532 px over the 8 levels of a 640x480 frame, 2.3 us at
// 3.35 TB/s) and does 16 subtractions and 116 min/max per scored pixel.
// fminf/fmaxf run at half the rate of an fp32 add on sm_90 (64 lanes
// per SM per clock; tools/alu_rates.py), so the min/max set the time.
//
// Design:
//  * One launch per frame.  The levels' pointers, sizes and first blocks
//    travel by value in a table (Levels, at most kMaxLevels); the 1-D grid
//    runs over the tiles of all levels and a block finds its level by
//    scanning the table.  The smallest levels no longer pay a launch and
//    a tail wave of their own.
//  * A block of 256 threads owns a 64x24 tile of outputs, 6 rows per
//    thread.  It stages the tile with a 4-pixel halo (3 px circle radius
//    + 1 px NMS ring) in shared memory (1.5x the tile's pixels), scores
//    the tile plus a 1-pixel ring (1.12x) into shared memory and applies
//    NMS as a separable 3x3 max from there, so only the final value is
//    written to device memory.  Of the tile shapes timed on an H100
//    (32x24 to 128x32), 64x24 was the fastest on a frame's 8 levels:
//    their 664 tiles are about one wave at 5 resident blocks per SM.
//  * Only scores that an output in the border window reads are computed
//    (the window grown by one pixel); a tile with no output in the
//    window writes its zeros and stops.
//  * The max over the 16 cyclic 9-arcs of the arc minimum takes 57
//    min/max (arc9: Van Herk / Gil-Werman, a suffix run and a prefix run
//    per block of 9) instead of the 79 of the plain version's span-2, -4,
//    -8, -9 tree; the dark branch is the same function with min and max
//    swapped, negated.
//  * Levels of any width are read in place, edge-clamped: the TPU
//    kernel's padding of the width to a multiple of 128 lanes is not
//    carried over.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kTileW = 64;
constexpr int kTileH = 24;
constexpr int kThreads = 256;
constexpr int kRows = kTileW * kTileH / kThreads;  // output rows per thread
constexpr int kHalo = 4;
constexpr int kImgW = kTileW + 2 * kHalo;
constexpr int kImgH = kTileH + 2 * kHalo;
constexpr int kScoreW = kTileW + 2;
constexpr int kScoreH = kTileH + 2;
static_assert(kThreads % kTileW == 0 && kRows * kThreads == kTileW * kTileH, "tile split");

// The levels of one launch; level l owns blocks [first[l], first[l + 1]).
struct Levels {
  const float* in[kMaxLevels];
  float* out[kMaxLevels];
  int H[kMaxLevels], W[kMaxLevels], tiles_x[kMaxLevels];
  int first[kMaxLevels + 1];
  int n, border;
};

template <bool kMin>
__device__ __forceinline__ float op(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

// kMin: max over k of min(d[k..k+8]); else min over k of max(d[k..k+8]),
// indices mod 16.  The arcs run over e[i] = d[i & 15], i < 24, cut in the
// blocks [0, 9), [9, 18), [18, 24): arc k <= 8 is op(e[k..8]) (a suffix of
// the first block) with op(e[9..k+8]) (a prefix of the second), arc 9 the
// second block, arc k >= 10 a suffix of the second block with a prefix of
// the third.  42 op + 15 of the other.
template <bool kMin>
__device__ __forceinline__ float arc9(const float (&d)[16]) {
  float sa[9];  // sa[k] = op(e[k..8])
  sa[8] = d[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) sa[k] = op<kMin>(d[k], sa[k + 1]);
  float best = sa[0];
  float pre = d[9];  // op(e[9..k+8])
#pragma unroll
  for (int k = 1; k <= 8; ++k) {
    if (k > 1) pre = op<kMin>(pre, d[(k + 8) & 15]);
    best = op<!kMin>(best, op<kMin>(sa[k], pre));
  }
  float sb[7];  // sb[k - 9] = op(e[k..17]), k = 9..15
  float run = op<kMin>(d[0], d[1]);  // op(e[16..17])
#pragma unroll
  for (int k = 15; k >= 9; --k) {
    run = op<kMin>(d[k], run);
    sb[k - 9] = run;
  }
  best = op<!kMin>(best, sb[0]);
  pre = d[2];  // op(e[18..k+8])
#pragma unroll
  for (int k = 10; k <= 15; ++k) {
    if (k > 10) pre = op<kMin>(pre, d[(k + 8) & 15]);
    best = op<!kMin>(best, op<kMin>(sb[k - 9], pre));
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
fast_nms_levels_kernel(const Levels lv) {
  __shared__ float s_img[kImgH][kImgW];
  __shared__ float s_score[kScoreH][kScoreW];

  int l = 0;
  while (l + 1 < lv.n && static_cast<int>(blockIdx.x) >= lv.first[l + 1]) ++l;
  const int H = lv.H[l], W = lv.W[l], border = lv.border;
  const int tile = blockIdx.x - lv.first[l];
  const int y0 = tile / lv.tiles_x[l] * kTileH;
  const int x0 = tile % lv.tiles_x[l] * kTileW;
  const float* __restrict__ img = lv.in[l];
  float* __restrict__ out = lv.out[l];
  const int tid = threadIdx.x;
  const int tx = tid % kTileW;
  const int ty = tid / kTileW * kRows;
  const int x = x0 + tx;
  // The border window [wy0, wy1) x [wx0, wx1) of outputs that may be
  // non-zero.
  const int wy0 = border, wy1 = H - border, wx0 = border, wx1 = W - border;

  if (max(y0, wy0) >= min(y0 + kTileH, wy1) || max(x0, wx0) >= min(x0 + kTileW, wx1)) {
    if (x < W) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int y = y0 + ty + r;
        if (y < H) out[y * W + x] = 0.0f;
      }
    }
    return;  // block-uniform
  }

  for (int i = tid; i < kImgH * kImgW; i += kThreads) {
    const int sy = i / kImgW, sx = i - sy * kImgW;
    const int gy = min(max(y0 - kHalo + sy, 0), H - 1);
    const int gx = min(max(x0 - kHalo + sx, 0), W - 1);
    s_img[sy][sx] = img[gy * W + gx];
  }
  __syncthreads();

  // Scores at rows [ny0, ny1] and columns [nx0, nx1] (the window grown
  // by the NMS ring, inside the image) are read by the window's outputs.
  // Positions outside the image hold -1, the plain version's padding;
  // other positions outside those ranges are read only by outputs that
  // the window zeroes, and hold -1 too.
  const int ny0 = max(wy0 - 1, 0), ny1 = min(wy1, H - 1);
  const int nx0 = max(wx0 - 1, 0), nx1 = min(wx1, W - 1);
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  for (int i = tid; i < kScoreH * kScoreW; i += kThreads) {
    // score position (sy, sx) = image position (y0 - 1 + sy, x0 - 1 + sx)
    // = staged position (sy + kHalo - 1, sx + kHalo - 1).
    const int sy = i / kScoreW, sx = i - sy * kScoreW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float s = -1.0f;
    if (gy >= ny0 && gy <= ny1 && gx >= nx0 && gx <= nx1) {
      const int cy = sy + kHalo - 1, cx = sx + kHalo - 1;
      const float c = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + dy[k]][cx + dx[k]] - c;
      // dark = max_k min_j (-d) = -(min_k max_j d)
      s = fmaxf(fmaxf(arc9<true>(d), -arc9<false>(d)), 0.0f);
    }
    s_score[sy][sx] = s;
  }
  __syncthreads();

  if (x >= W) return;
  // Separable 3x3 max (the centre included: s >= max ⇔ s >= every
  // neighbour): hm[j] = max over columns x-1..x+1 of score row ty + j.
  const int c = tx + 1;
  float hm[kRows + 2];
#pragma unroll
  for (int j = 0; j < kRows + 2; ++j) {
    const float* row = s_score[ty + j];
    hm[j] = fmaxf(fmaxf(row[c - 1], row[c]), row[c + 1]);
  }
  const bool col_in = x >= wx0 && x < wx1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + ty + r;
    if (y >= H) break;
    const float s = s_score[ty + r + 1][c];
    const float m = fmaxf(fmaxf(hm[r], hm[r + 1]), hm[r + 2]);
    const bool keep = col_in && y >= wy0 && y < wy1 && s >= m;
    out[y * W + x] = keep ? s : 0.0f;
  }
}

}  // namespace

// table: n rows of (input pointer, output pointer, H, W) as 64-bit
// integers, one per level, each (H, W) float32 contiguous on ``device``
// with 0 < H * W and the levels' total < 2^31.  The wrapper
// (ops/kernels.py) passes 1 <= n <= 16, border >= 0 and a stream on the
// device.
extern "C" int ydorb_fast_score_nms(const long long* table, int n, int border, int device,
                                    cudaStream_t stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  int blocks = 0;
  for (int l = 0; l < n; ++l) {
    const long long* row = table + 4 * l;
    lv.in[l] = reinterpret_cast<const float*>(row[0]);
    lv.out[l] = reinterpret_cast<float*>(row[1]);
    lv.H[l] = static_cast<int>(row[2]);
    lv.W[l] = static_cast<int>(row[3]);
    lv.tiles_x[l] = (lv.W[l] + kTileW - 1) / kTileW;
    lv.first[l] = blocks;
    blocks += lv.tiles_x[l] * ((lv.H[l] + kTileH - 1) / kTileH);
  }
  for (int l = n; l <= kMaxLevels; ++l) lv.first[l] = blocks;
  lv.n = n;
  lv.border = border;
  const ydorb::DeviceGuard guard(device);
  fast_nms_levels_kernel<<<blocks, kThreads, 0, stream>>>(lv);
  return static_cast<int>(cudaGetLastError());
}
