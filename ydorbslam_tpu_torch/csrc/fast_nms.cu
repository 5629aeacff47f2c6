// K1: FAST-9 corner score + 3x3 non-maximum suppression + border mask.
//
// Replaces the Pallas TPU kernel ydorbslam_tpu/ops/pallas_kernels.py
// fast_score_nms_pallas (kernel body _fast_nms_kernel), which computes
// nms_and_border(fast_score_map(img), border) of ydorbslam_tpu/ops/fast.py.
//
// What it computes, per pixel p of an (H, W) float32 pyramid level:
//   d_k   = I(p + o_k) - I(p) for the 16 Bresenham circle offsets o_k;
//   score = max(max_k min_{j<9} d_{k+j}, max_k min_{j<9} -d_{k+j}, 0)
//           (the largest threshold that passes the FAST-9 segment test);
//   out   = score if score >= all 8 neighbours' scores (ties survive)
//           and p lies in [border, H - border) x [border, W - border),
//           else 0.  Neighbours outside the image count as -1.
// Pixels beyond the image are read edge-clamped, which is the
// replicate padding of the plain version.  Every step is a subtraction,
// negation, min or max, so the result is bit-identical to the plain
// PyTorch version (ydorbslam_tpu_torch/ops/fast.py).
//
// What bounds it on an H100: bytes.  It reads 4 B and writes 4 B per
// pixel (about 1 Mpx over the 8 levels of a 640x480 frame) and does
// ~200 min/max per pixel, far below the card's arithmetic rate; at this
// size each launch is dominated by launch latency.
//
// Design: one launch per level.  Each 32x8 block stages its tile plus a
// 4-pixel halo (3 px circle radius + 1 px NMS ring) in shared memory,
// computes the score of the tile plus a 1-pixel ring into shared memory,
// then applies NMS and the border mask from there, so only the final
// suppressed score is written to device memory.  The TPU kernel's
// padding of the width to a multiple of 128 lanes is not carried over:
// the level is read in place, unpadded.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHalo = 4;
constexpr int kImgW = kTileW + 2 * kHalo;
constexpr int kImgH = kTileH + 2 * kHalo;
constexpr int kScoreW = kTileW + 2;
constexpr int kScoreH = kTileH + 2;

// max over the 16 cyclic 9-arcs of the min of d over the arc: the same
// span-2, -4, -8, -9 tree as the plain version.
__device__ __forceinline__ float arc9_max_min(const float (&d)[16]) {
  float m1[16], m2[16], m4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m1[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(m1[k], m1[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 4) & 15]);
  float best = fminf(m4[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = fmaxf(best, fminf(m4[k], d[(k + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(kTileW * kTileH)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, int border) {
  __shared__ float s_img[kImgH][kImgW + 1];
  __shared__ float s_score[kScoreH][kScoreW + 1];

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int kThreads = kTileW * kTileH;

  for (int i = tid; i < kImgH * kImgW; i += kThreads) {
    const int sy = i / kImgW, sx = i % kImgW;
    const int gy = min(max(y0 - kHalo + sy, 0), H - 1);
    const int gx = min(max(x0 - kHalo + sx, 0), W - 1);
    s_img[sy][sx] = img[gy * W + gx];
  }
  __syncthreads();

  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  for (int i = tid; i < kScoreH * kScoreW; i += kThreads) {
    // score position (sy, sx) = image position (y0 - 1 + sy, x0 - 1 + sx)
    // = shared position (sy + kHalo - 1, sx + kHalo - 1).
    const int sy = i / kScoreW, sx = i % kScoreW;
    const int cy = sy + kHalo - 1, cx = sx + kHalo - 1;
    const float c = s_img[cy][cx];
    float d[16], nd[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      d[k] = s_img[cy + dy[k]][cx + dx[k]] - c;
      nd[k] = -d[k];
    }
    s_score[sy][sx] = fmaxf(fmaxf(arc9_max_min(d), arc9_max_min(nd)), 0.0f);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float s = s_score[threadIdx.y + 1][threadIdx.x + 1];
  float m = s;
#pragma unroll
  for (int oy = -1; oy <= 1; ++oy) {
#pragma unroll
    for (int ox = -1; ox <= 1; ++ox) {
      if (oy == 0 && ox == 0) continue;
      const int ny = y + oy, nx = x + ox;
      const bool inside = ny >= 0 && ny < H && nx >= 0 && nx < W;
      const float n = inside ? s_score[threadIdx.y + 1 + oy][threadIdx.x + 1 + ox] : -1.0f;
      m = fmaxf(m, n);
    }
  }
  const bool keep = s >= m && y >= border && y < H - border &&
                    x >= border && x < W - border;
  out[y * W + x] = keep ? s : 0.0f;
}

}  // namespace

extern "C" int ydorb_fast_score_nms(const float* img, float* out, int H, int W,
                                    int border, cudaStream_t stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  fast_nms_kernel<<<grid, block, 0, stream>>>(img, out, H, W, border);
  return static_cast<int>(cudaGetLastError());
}
