// K5: the pose-only LM of one frame (optim/pose.py optimize_pose) in one
// launch.
//
// Replaces no Pallas kernel: the JAX package runs the same solve as one
// jitted, unrolled XLA program (ydorbslam_tpu/optim/pose.py optimize_pose).
// The port ran it as eager PyTorch, about 7,600 small launches a solve;
// this kernel is that whole solve.
//
// What it computes, in float32, for N observations (world point p_w,
// observation (uL, vL, uR), information weight inv_sigma2, stereo and
// valid flags) and an initial world-to-camera pose T0, exactly as
// optimize_pose_plain does:
//   episodes e = 0 .. E-1, each restarting from T0 with the current
//   inlier set (the valid flags at first); Huber on e < 3 only, with
//   delta^2 7.815 for a stereo and 5.991 for a mono observation;
//   an observation counts where it is an inlier and zr > 1e-3;
//   per episode the normal equations (H = sum w J^T J over the observation's
//   rows u, v and, for stereo, uR; b = sum w J^T r; the robust cost) at T0,
//   then I iterations of: solve (H + lam diag(H) + 1e-8 I) dx = -b by
//   Cholesky, T' = exp(dx) T (the twist exponential with the small-angle
//   branch of geometry/se3.py), the normal equations at T', and accept
//   if cost' < cost (lam = max(lam / 2, 1e-7), T, H, b and cost carried
//   over) or reject (lam = min(4 lam, 1e4)); lam starts at 1e-3.  A failed
//   factorisation is a rejected step.  After the episode every valid
//   observation is re-classified by its raw chi^2 (inlier where chi^2 <=
//   delta^2 and zr > 1e-3).  Finally T is orthonormalised (Gram-Schmidt on
//   the rotation's columns) and the inliers are counted.
// No early exit: E * (I + 1) normal-equation passes and E classification
// passes, 48 at the tracker's 4 x 10.  Sums are taken in another order
// than the plain version's, so results agree to float32 rounding.
//
// What bounds it on an H100: latency.  The 48 passes depend on each
// other through the 6x6 solve between them; each reads the N
// observations (31 B each, N = 2048 on the KITTI path) and does ~160
// lane operations per observation, then a block reduction of 28 sums and
// one thread's solve.  The bytes (N x 31 B read once, 64 KB) and the
// operations (~15 M lane operations a solve) would take the card under a
// microsecond at its peaks; the chain of dependent passes takes ~0.34 ms
// at N = 2048 (about 8 us an LM iteration: half the pass and its
// reduction, half the one-thread solve).
//
// Design:
//  * One block per solve.  The observations are copied once into dynamic
//    shared memory (31 B each, floats first); where N does not fit the
//    block's shared memory, the kernel reads them in place from device
//    memory and keeps the inlier mask in the output.  Each observation is
//    read and written only by the thread that owns it (i = thread,
//    thread + blockDim, ...), so the copy needs no barrier.  The copy is
//    worth its second path: on an H100 (80GB HBM3, 700 W) the in-place
//    reads alone, through L1, took 0.2523 / 0.3491 / 0.6049 ms at N = 1024
//    / 2048 / 4096 against the copy's 0.2487 / 0.3415 / 0.5264, with the
//    same output bits (repeats apart by 0.0001 ms).
//  * Each pass: every thread sums its observations' 21 upper-triangle H
//    terms, 6 b terms and cost in registers; a warp reduces its 32 slots
//    by halving exchanges (lane l ends with the warp's sum of slot l:
//    31 shuffles instead of 5 per slot), warp 0 adds the warps' sums in
//    warp order.  The order is fixed, with no atomics, so two launches on
//    the same inputs give the same bits.
//  * Thread 0 does the accept test, the damping, the Cholesky solve, the
//    exponential and the product, and leaves the pose to evaluate in
//    shared memory for the next pass.  The solver's state (H, b, cost,
//    lam, the pose) lives in shared memory, not in every thread's
//    registers.
//  * The camera's fields are read on the device through their pointers,
//    so the host reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

// Threads of the one block.  Timed on an H100 at N = 1024 / 2048 / 4096
// (4 x 10): 256 threads 0.249 / 0.340 / 0.526 ms, 512 0.300 / 0.359 /
// 0.486, 1024 (64 registers, spilling) 0.451 / 0.509 / 0.628.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;  // per-pass sums: 21 H (upper triangle), 6 b, cost, 4 unused
constexpr int kB = 21, kCost = 27;
constexpr int kMaxDevices = 64;

struct Args {
  const float* T0;      // (4, 4)
  const float* p_w;     // (N, 3)
  const float* uvr;     // (N, 3)
  const float* is2;     // (N,)
  const uint8_t* stereo;  // (N,) bool
  const uint8_t* valid;   // (N,) bool
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* bf;
  float* T_out;         // (4, 4)
  uint8_t* inlier;      // (N,) bool
  long long* n_in;      // ()
  int N, episodes, iters;
  int cached;           // observations copied to shared memory
};

// The observations where the pass reads them: shared or device memory.
struct Obs {
  const float* p_w;
  const float* uvr;
  const float* is2;
  const uint8_t* stereo;
  const uint8_t* valid;
  uint8_t* mask;  // the inlier set, read and rewritten per episode
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

// The solver's state, thread 0's alone between barriers.
struct State {
  float T0[16], T[16], T_eval[16];
  float H[21], b[6], cost, lam;
  int step_ok;
};

__device__ __forceinline__ constexpr int tri(int i, int j) {  // upper triangle, row-major, i <= j
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Camera-frame point and (u, v, uR) residual of observation i under T.
struct Proj {
  float x, y, z, zr, iz, r0, r1, r2;
};

__device__ __forceinline__ Proj project(const float (&T)[12], const Cam& c, const Obs& o, int i) {
  const float X = o.p_w[3 * i], Y = o.p_w[3 * i + 1], Z = o.p_w[3 * i + 2];
  Proj p;
  p.x = T[0] * X + T[1] * Y + T[2] * Z + T[3];
  p.y = T[4] * X + T[5] * Y + T[6] * Z + T[7];
  p.zr = T[8] * X + T[9] * Y + T[10] * Z + T[11];
  p.z = fmaxf(p.zr, 1e-6f);
  p.iz = 1.0f / p.z;
  const float u = c.fx * p.x * p.iz + c.cx;
  const float v = c.fy * p.y * p.iz + c.cy;
  const float ur = u - c.bf * p.iz;
  p.r0 = o.uvr[3 * i] - u;
  p.r1 = o.uvr[3 * i + 1] - v;
  p.r2 = o.uvr[3 * i + 2] - ur;
  return p;
}

__device__ __forceinline__ void load_pose(const float* s, float (&T)[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = s[k];
}

// Block sum of kSlots values per thread; slot l's total lands in
// s_tot[l], visible to warp 0 when this returns.  Fixed order.
__device__ __forceinline__ void block_sum(float (&v)[kSlots], float (*s_red)[kSlots],
                                          float* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool up = lane & s;
#pragma unroll
    for (int k = 0; k < s; ++k) {
      const float send = up ? v[k] : v[k + s];
      const float keep = up ? v[k + s] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  s_red[warp][lane] = v[0];
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_red[w][lane];
    s_tot[lane] = t;
    __syncwarp();
  }
}

// One pass of the normal equations at s_T: H, b and the cost into s_tot.
__device__ __forceinline__ void normal_pass(const float* s_T, const Cam& c, const Obs& o, int N,
                                            bool huber, float (*s_red)[kSlots], float* s_tot) {
  float T[12];
  load_pose(s_T, T);
  float acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    if (!o.mask[i]) continue;
    const Proj p = project(T, c, o, i);
    if (!(p.zr > 1e-3f)) continue;
    const bool st = o.stereo[i] != 0;
    float wu = o.is2[i];
    float wr = st ? wu : 0.f;
    const float chi2 = p.r0 * p.r0 * wu + p.r1 * p.r1 * wu + p.r2 * p.r2 * wr;
    float cost = chi2;
    if (huber) {
      const float d2 = st ? 7.815f : 5.991f;
      if (!(chi2 <= d2)) {
        const float safe = fmaxf(chi2, 1e-12f);
        cost = 2.0f * sqrtf(d2) * sqrtf(safe) - d2;
        const float h = sqrtf(d2 / safe);
        wu *= h;
        wr *= h;
      }
    }
    const float x = p.x, y = p.y, z = p.z, iz = p.iz;
    const float iz2 = iz * iz;
    const float a = c.fx * iz;
    const float c3 = -c.fx * x * iz2;
    const float d = c.fy * iz;
    const float e = -c.fy * y * iz2;
    const float cr = c3 + c.bf * iz2;
    const float su = sqrtf(wu), sr = sqrtf(wr);
    const float ju[6] = {-a * su, 0.f, -c3 * su, -c3 * y * su, -(a * z - c3 * x) * su,
                         a * y * su};
    const float jv[6] = {0.f, -d * su, -e * su, -(-d * z + e * y) * su, e * x * su,
                         -d * x * su};
    const float jr[6] = {-a * sr, 0.f, -cr * sr, -cr * y * sr, -(a * z - cr * x) * sr,
                         a * y * sr};
    const float ru = p.r0 * su, rv = p.r1 * su, rr = p.r2 * sr;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int q = r; q < 6; ++q) acc[tri(r, q)] += ju[r] * ju[q] + jv[r] * jv[q] + jr[r] * jr[q];
      acc[kB + r] += ju[r] * ru + jv[r] * rv + jr[r] * rr;
    }
    acc[kCost] += cost;
  }
  block_sum(acc, s_red, s_tot);
}

// Re-classify this thread's observations by raw chi^2 at s_T.
__device__ __forceinline__ void classify(const float* s_T, const Cam& c, const Obs& o, int N) {
  float T[12];
  load_pose(s_T, T);
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const Proj p = project(T, c, o, i);
    const float wu = o.is2[i];
    const float wr = o.stereo[i] ? wu : 0.f;
    const float chi2 = p.r0 * p.r0 * wu + p.r1 * p.r1 * wu + p.r2 * p.r2 * wr;
    const float d2 = o.stereo[i] ? 7.815f : 5.991f;
    o.mask[i] = o.valid[i] && chi2 <= d2 && p.zr > 1e-3f;
  }
}

// Thread 0: the damped Cholesky solve and the left update
// T_eval = exp(dx) T.  Returns false where the factorisation fails.  The
// loops unroll, so the 6x6 factor stays in registers.
__device__ bool lm_step(State& s) {
  float A[21], r[6], L[6][6];
#pragma unroll
  for (int k = 0; k < 21; ++k) A[k] = s.H[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = s.b[k];
  const float lam = s.lam;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float dj = A[tri(j, j)] + lam * A[tri(j, j)] + 1e-8f;
#pragma unroll
    for (int k = 0; k < j; ++k) dj -= L[j][k] * L[j][k];
    if (!(dj > 0.f)) return false;
    L[j][j] = sqrtf(dj);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = A[tri(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / L[j][j];
    }
  }
  float y[6], dx[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = r[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * dx[k];
    dx[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = -dx[i];

  // exp of the twist [rho, phi] (geometry/se3.py se3_exp).
  const float px = dx[3], py = dx[4], pz = dx[5];
  const float theta2 = px * px + py * py + pz * pz;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  float sn, cs;
  sincosf(theta, &sn, &cs);
  const float a = small ? 1.0f - theta2 / 6.0f : sn / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2;
  const float cc = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - sn) / (theta2 * theta);
  const float K[3][3] = {{0.f, -pz, py}, {pz, 0.f, -px}, {-py, px, 0.f}};
  float K2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
  }
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.0f : 0.0f;
      E[i][j] = id + a * K[i][j] + b * K2[i][j];
      t += (id + b * K[i][j] + cc * K2[i][j]) * dx[j];
    }
    E[i][3] = t;
  }
  // T_eval = [[E], [0 0 0 1]] @ T; the bottom row is T's.
  float T[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = s.T[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s.T_eval[i * 4 + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                            E[i][3] * T[12 + j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) s.T_eval[12 + j] = T[12 + j];
  return true;
}

// Thread 0: the rotation's columns made orthonormal (geometry/se3.py
// orthonormalize_T), translation kept, bottom row [0 0 0 1].
__device__ void orthonormalize(const float* T, float* out) {
  float c0[3] = {T[0], T[4], T[8]}, c1[3] = {T[1], T[5], T[9]};
  const float n0 = fmaxf(sqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) c0[k] /= n0;
  const float dot = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
  for (int k = 0; k < 3; ++k) c1[k] -= dot * c0[k];
  const float n1 = fmaxf(sqrtf(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) c1[k] /= n1;
  const float c2[3] = {c0[1] * c1[2] - c0[2] * c1[1], c0[2] * c1[0] - c0[0] * c1[2],
                       c0[0] * c1[1] - c0[1] * c1[0]};
  for (int k = 0; k < 3; ++k) {
    out[k * 4] = c0[k];
    out[k * 4 + 1] = c1[k];
    out[k * 4 + 2] = c2[k];
    out[k * 4 + 3] = T[k * 4 + 3];
  }
  out[12] = 0.f;
  out[13] = 0.f;
  out[14] = 0.f;
  out[15] = 1.f;
}

__global__ void __launch_bounds__(kThreads) pose_lm_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char s_obs[];
  __shared__ float s_red[kWarps][kSlots];
  __shared__ float s_tot[kSlots];
  __shared__ State s;
  __shared__ int s_cnt[kWarps];
  const int tid = threadIdx.x, N = a.N;

  Obs o;
  if (a.cached) {
    float* p_w = reinterpret_cast<float*>(s_obs);
    float* uvr = p_w + 3 * N;
    float* is2 = uvr + 3 * N;
    uint8_t* stereo = reinterpret_cast<uint8_t*>(is2 + N);
    uint8_t* valid = stereo + N;
    uint8_t* mask = valid + N;
    for (int i = tid; i < N; i += kThreads) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p_w[3 * i + k] = a.p_w[3 * i + k];
        uvr[3 * i + k] = a.uvr[3 * i + k];
      }
      is2[i] = a.is2[i];
      stereo[i] = a.stereo[i] != 0;
      valid[i] = a.valid[i] != 0;
      mask[i] = valid[i];
    }
    o = Obs{p_w, uvr, is2, stereo, valid, mask};
  } else {
    for (int i = tid; i < N; i += kThreads) a.inlier[i] = a.valid[i] != 0;
    o = Obs{a.p_w, a.uvr, a.is2, a.stereo, a.valid, a.inlier};
  }
  const Cam c{*a.fx, *a.fy, *a.cx, *a.cy, *a.bf};
  if (tid == 0) {
    for (int k = 0; k < 16; ++k) s.T0[k] = s.T[k] = a.T0[k];
  }

  for (int epi = 0; epi < a.episodes; ++epi) {
    const bool huber = epi < 3;
    if (tid == 0) {
      for (int k = 0; k < 16; ++k) s.T[k] = s.T_eval[k] = s.T0[k];
    }
    __syncthreads();
    normal_pass(s.T_eval, c, o, N, huber, s_red, s_tot);
    if (tid == 0) {
      for (int k = 0; k < 21; ++k) s.H[k] = s_tot[k];
      for (int k = 0; k < 6; ++k) s.b[k] = s_tot[kB + k];
      s.cost = s_tot[kCost];
      s.lam = 1e-3f;
    }
    for (int it = 0; it < a.iters; ++it) {
      if (tid == 0) s.step_ok = lm_step(s);
      __syncthreads();
      normal_pass(s.T_eval, c, o, N, huber, s_red, s_tot);
      if (tid == 0) {
        if (s.step_ok && s_tot[kCost] < s.cost) {
          for (int k = 0; k < 16; ++k) s.T[k] = s.T_eval[k];
          for (int k = 0; k < 21; ++k) s.H[k] = s_tot[k];
          for (int k = 0; k < 6; ++k) s.b[k] = s_tot[kB + k];
          s.cost = s_tot[kCost];
          s.lam = fmaxf(s.lam * 0.5f, 1e-7f);
        } else {
          s.lam = fminf(s.lam * 4.0f, 1e4f);
        }
      }
    }
    __syncthreads();
    classify(s.T, c, o, N);
    __syncthreads();  // every thread has read s.T before the next episode resets it
  }

  int n = 0;
  for (int i = tid; i < N; i += kThreads) {
    n += o.mask[i];
    if (a.cached) a.inlier[i] = o.mask[i];
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((tid & 31) == 0) s_cnt[tid >> 5] = n;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
    *a.n_in = total;
    orthonormalize(s.T, a.T_out);
  }
}

}  // namespace

// One pose solve.  The wrapper (ops/kernels.py) passes contiguous float32
// and bool tensors on one device, N >= 0, episodes and iters >= 0, the
// device and a stream on it.
extern "C" int ydorb_pose_lm(const float* T0, const float* p_w, const float* uvr,
                             const float* is2, const uint8_t* stereo, const uint8_t* valid,
                             const float* fx, const float* fy, const float* cx, const float* cy,
                             const float* bf, float* T_out, uint8_t* inlier, long long* n_in,
                             int N, int episodes, int iters, int device, cudaStream_t stream) {
  if (N < 0 || episodes < 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const ydorb::DeviceGuard guard(device);
  // The dynamic shared memory a block may take on each device, found (and
  // opted into, above 48 KB) at the first launch there.
  static int budget[kMaxDevices] = {};
  if (budget[device] <= 0) {
    int optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pose_lm_kernel);
    const int avail = optin - static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, avail);
    if (err != cudaSuccess) return static_cast<int>(err);
    budget[device] = avail;
  }
  const size_t need = static_cast<size_t>(N) * (7 * sizeof(float) + 3);
  const int cached = need <= static_cast<size_t>(budget[device]);
  const Args a{T0, p_w, uvr, is2, stereo, valid, fx, fy, cx, cy, bf,
               T_out, inlier, n_in, N, episodes, iters, cached};
  pose_lm_kernel<<<1, kThreads, cached ? need : 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
