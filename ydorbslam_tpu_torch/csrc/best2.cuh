// Device code shared by K2 (proj_best2.cu) and K3 (pair_best2.cu): the
// gated best/second state, its update and the exact merge of two partial
// states, the warp reduction, a warp's queue of gated pairs, the staging
// of a b-tile in shared memory and the choice of rows per block.
//
// The TPU kernels visit the b-columns of an a-row in ascending order and
// apply, for every gated distance d at column n,
//   if (d < best) { second = best; best = d; idx = n; }
//   else if (d < second) { second = d; }
// from (best, second, idx) = (10000, 10000, -1).  That leaves
//   best   = the smallest gated d,
//   idx    = the lowest column that attains it,
//   second = the second smallest element of the multiset of gated d (a
//            tied duplicate of the best counts).
// So the columns can be split into disjoint sets and the partial states
// merged: of (b1, s1, i1) and (b2, s2, i2), the one with the smaller best
// (the lower idx on a tie) keeps its best and idx, and the second becomes
// the smaller of its own second and the other's best.  The merge depends
// only on the union of the two sets, so it is associative and
// commutative; the sentinel state merges as the identity.  Adding one
// column is the merge with the singleton (d, 10000, n) (``update``), so
// any split of the columns, visited in any order and merged in any
// order, gives the sequential result exactly.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_guard.cuh"

namespace best2 {

constexpr int kInvalid = 10000;  // sentinel distance, above any of 256 bits
constexpr int kTile = 512;       // b-columns per shared-memory stage
// Word pitch of a staged attribute array; 4 (mod 32) spreads the staging
// writes of neighbouring columns' lanes over the banks, and the reads of
// 32 consecutive columns of one lane hit 32 distinct banks.
constexpr int kPitch = kTile + 4;

struct State {
  int best, second, idx;
};

__device__ __forceinline__ State empty() { return State{kInvalid, kInvalid, -1}; }

// Adds column n at distance d: the merge with the singleton (d, 10000, n).
// d = kInvalid leaves the state as it is.
__device__ __forceinline__ void update(State& s, int d, int n) {
  const bool first = d < s.best || (d == s.best && n < s.idx);
  s.second = first ? s.best : min(s.second, d);
  s.idx = first ? n : s.idx;
  s.best = first ? d : s.best;
}

// The state of the union of two disjoint column sets.
__device__ __forceinline__ State merge(const State& a, const State& b) {
  const bool a_first = a.best < b.best || (a.best == b.best && a.idx < b.idx);
  return a_first ? State{a.best, min(a.second, b.best), a.idx}
                 : State{b.best, min(b.second, a.best), b.idx};
}

// Butterfly over the 32 lanes of a warp; every lane ends with the state
// of the whole row.  All 32 lanes must call it.
__device__ __forceinline__ State warp_merge(State s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const State t{__shfl_xor_sync(0xffffffffu, s.best, o),
                  __shfl_xor_sync(0xffffffffu, s.second, o),
                  __shfl_xor_sync(0xffffffffu, s.idx, o)};
    s = merge(s, t);
  }
  return s;
}

// Hamming distance between an a-row (two 16-byte halves) and a staged
// descriptor row.
__device__ __forceinline__ int distance(const uint4& a0, const uint4& a1, const uint32_t* row) {
  const uint4 b0 = *reinterpret_cast<const uint4*>(row);
  const uint4 b1 = *reinterpret_cast<const uint4*>(row + 4);
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// A lane gates kGroup (a-row, 32-column chunk) pairs per group of its
// scan: kGroup chunks of one row, after a cheap pre-test of them all where
// the gate has one, or fewer chunks of several rows scanned together.
constexpr int kGroup = 8;

// A warp's queue of gated pairs, in shared memory.  The lanes append the
// pairs of a group that pass the gate, and while 32 or more are queued each
// lane takes one and computes its distance, so the popcounts run on full
// warps however sparse the gate is.  Every lane of the warp calls these
// with the same counts.
constexpr int kQueue = 32 + 32 * kGroup;  // < 32 left over + one group

// Appends this lane's entry(b) for each bit b set in ``hits`` (at most
// kGroup bits) after those of the lanes below it, found by a prefix sum
// of the lanes' counts; returns the new count.  Queue order does not
// matter: the merge is order-independent.
template <typename Entry>
__device__ __forceinline__ int queue_push(int* q, int n, unsigned hits, Entry entry) {
  const int lane = threadIdx.x & 31;
  const int count = __popc(hits);
  int end = count;  // this lane's count and those of the lanes below it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, end, o);
    if (lane >= o) end += t;
  }
  int at = n + end - count;
  for (unsigned h = hits; h != 0u; h &= h - 1u) q[at++] = entry(__ffs(h) - 1);
  return n + __shfl_sync(0xffffffffu, end, 31);
}

// The entry of this lane among the ``count`` queued from ``head``, or -1.
__device__ __forceinline__ int queue_take(const int* q, int head, int count) {
  __syncwarp();  // the appends are visible
  const int lane = threadIdx.x & 31;
  return lane < count ? q[head + lane] : -1;
}

// Moves the entries [head, n) (fewer than 32, all taken before) to the
// front once each lane has taken its entry; returns their count.
__device__ __forceinline__ int queue_compact(int* q, int head, int n) {
  const int lane = threadIdx.x & 31;
  const int rest = n - head;
  const int v = lane < rest ? q[head + lane] : 0;
  __syncwarp();
  if (lane < rest) q[lane] = v;
  return rest;
}

// A stage holds kTile b-columns: the descriptors as rows of 8 words (read
// only for the pairs that pass a gate), then the first A attribute lanes
// word-major, lane l of column t at attrs[l * kPitch + t], which the gate
// reads for 32 consecutive columns at once.
template <int A>
__host__ __device__ constexpr int stage_words() {
  return 8 * kTile + A * kPitch;
}

__device__ __forceinline__ const float* attrs(const uint32_t* stage) {
  return reinterpret_cast<const float*>(stage + 8 * kTile);
}

// Asynchronous copy of b-columns [j0, j0 + n) into a stage.  b keeps its
// (N, 8) layout in device memory; the descriptors go as 16-byte pieces,
// the attributes as words, consecutive threads on consecutive addresses.
// Commits one group.
template <int A>
__device__ __forceinline__ void stage(uint32_t* s, const uint32_t* __restrict__ desc_b,
                                      const float* __restrict__ attr_b, size_t j0, int n) {
  const uint32_t* db = desc_b + j0 * 8;
  const float* ab = attr_b + j0 * 8;
  float* s_attr = reinterpret_cast<float*>(s + 8 * kTile);
  for (int i = threadIdx.x; i < n * 2; i += blockDim.x) {
    __pipeline_memcpy_async(s + i * 4, db + i * 4, 16);
  }
  for (int i = threadIdx.x; i < n * A; i += blockDim.x) {
    const int t = i / A, l = i - t * A;
    __pipeline_memcpy_async(s_attr + l * kPitch + t, ab + t * 8 + l, 4);
  }
  __pipeline_commit();
}

static_assert(kTile % (32 * kGroup) == 0, "a group lies in one stage");

// Where window column c is staged: stage (c / kTile) & 1 at c % kTile
// (a window starts at a multiple of kTile).
struct Group {
  const uint32_t* stage;
  int base;
  __device__ __forceinline__ Group(const uint32_t* smem, int stage_words, int c)
      : stage(smem + ((c / kTile) & 1) * stage_words), base(c % kTile) {}
  // The descriptor row of column c + i.
  __device__ __forceinline__ const uint32_t* row(int i) const { return stage + (base + i) * 8; }
};

// A block's a-rows are staged too, kRowWords words each: the 8
// descriptor words, then the 8 attribute lanes.  Every lane of a warp
// reads the same row, a broadcast.
constexpr int kRowWords = 16;

// Asynchronous copy of rows [m0, m0 + n) of desc_a and attr_a to s_rows,
// as 16-byte pieces; it joins the next commit.
__device__ __forceinline__ void stage_rows(uint32_t* s_rows, const uint32_t* __restrict__ desc_a,
                                           const float* __restrict__ attr_a, size_t m0, int n) {
  for (int i = threadIdx.x; i < n * 4; i += blockDim.x) {
    const size_t row = m0 + (i >> 2);
    const int piece = i & 3;  // 0, 1: descriptor halves; 2, 3: attribute halves
    const void* src = piece < 2 ? static_cast<const void*>(desc_a + row * 8 + piece * 4)
                                : static_cast<const void*>(attr_a + row * 8 + (piece - 2) * 4);
    __pipeline_memcpy_async(s_rows + (i >> 2) * kRowWords + piece * 4, src, 16);
  }
}

// Warps per block, and the most a-rows a warp serves.
constexpr int kWarps = 8;
constexpr int kMaxRowsPerWarp = 16;

// Shared memory of one block, in this order: two stages, the a-rows, a
// queue per warp and S states per a-row.
template <int A>
__host__ __device__ constexpr int rows_offset() {
  return 2 * stage_words<A>();
}
template <int A>
__host__ __device__ constexpr int queue_offset() {
  return rows_offset<A>() + kWarps * kMaxRowsPerWarp * kRowWords;
}
template <int A>
__host__ __device__ constexpr int states_offset() {
  return queue_offset<A>() + kWarps * kQueue;
}
template <int A, int S>
constexpr int smem_bytes() {
  return (states_offset<A>() +
          kWarps * kMaxRowsPerWarp * S * static_cast<int>(sizeof(State) / 4)) * 4;
}

constexpr int kMaxDevices = 64;

// Blocks of ``kernel`` resident on the current device at once (SMs x
// blocks per SM), after raising its dynamic shared memory limit to
// ``smem``.  Both are done once per device and kept in ``cache``, one
// array per kernel instantiation: the wall time of a launch this small
// is the host's.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, std::atomic<int> (&cache)[kMaxDevices],
                            int& slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  slots = cache[dev].load(std::memory_order_relaxed);
  if (slots > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem);
  }
  if (err != cudaSuccess) return err;
  slots = sms * (per_sm > 0 ? per_sm : 1);
  cache[dev].store(slots, std::memory_order_relaxed);
  return cudaSuccess;
}

// Blocks of the grid's x axis for M rows at ``rows`` a-rows per warp.
inline int row_blocks(int M, int rows) { return (M + kWarps * rows - 1) / (kWarps * rows); }

// A-rows per warp: the fewest, from ``least``, that put the grid of B
// problems of M rows in one wave of ``slots`` resident blocks, so every
// SM gets work and each staged b-side serves as many rows as that
// allows.
inline int rows_per_warp(int slots, int M, int B, int least) {
  int rows = least;
  while (rows < kMaxRowsPerWarp && static_cast<long long>(row_blocks(M, rows)) * B > slots) ++rows;
  return rows;
}

}  // namespace best2
