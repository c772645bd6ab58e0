// The event-walk primitives every walk shares (pool_walk.cuh,
// conv_walk.cuh, fc_walk.cuh and the kernels built on them).
//
// A walk applies a list of events in list order, each site (or column)
// by its one owning thread, and reads no event past the list's last gated
// one:
//  - walk_end: the block reads a gate row once (16-byte loads, a scalar
//    head and tail) and max-reduces the last index with a gate set; any
//    gate pattern is walked right.  This is the plain version's
//    `last_active`, taken per slot.
//  - compact: up to kPerLane events a thread at a time, each lane tests
//    its events and keeps, in list order (__ballot_sync, __popc and a
//    prefix over the warps' counts), those its block needs.
//  - cp.async helpers: 4-byte copies from device to shared memory that
//    stay in flight while the block does other work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sne {

// An accumulator carried through an int field of a kept entry, and back.
template <typename Acc>
__device__ __forceinline__ Acc from_bits(int bits);
template <>
__device__ __forceinline__ float from_bits<float>(int bits) {
  return __int_as_float(bits);
}
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int bits) {
  return bits;
}
__device__ __forceinline__ int to_bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ int to_bits(int32_t v) { return v; }

// Block-wide sum of one int per thread, returned to every thread, and the
// exclusive prefix of the thread's warp (sum over warps below it) in
// `below`.  `red` holds 32 ints.  All threads must call it; on return
// `red` may be reused.
__device__ __forceinline__ int warp_offsets(int per_warp, int* red,
                                            int& below) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) red[warp] = per_warp;
  __syncthreads();
  int off = 0, total = 0;
  for (int k = 0; k < n_warps; ++k) {
    const int c = red[k];
    off += k < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  below = off;
  return total;
}

// One past the last index of g[0, E) whose gate is set (0 if none), for
// every thread of the block.  `kThreads` is the block size where the
// caller fixes it at compile time (the pool and fc kernels): the loops
// then stride by a constant, which lets the compiler keep several loads
// in flight; 0 (the conv kernels) reads blockDim.x.  `red` holds one int
// per warp.  All threads must call it; on return `red` may be reused, and
// everything the block wrote to shared memory before the call is visible
// to every thread.
template <int kThreads = 0, typename G>
__device__ int walk_end(const G* __restrict__ g, int E, int* red) {
  constexpr int V = 16 / sizeof(G);
  const int tid = threadIdx.x;
  const int nthr = kThreads > 0 ? kThreads : (int)blockDim.x;
  // elements before the first 16-byte boundary (g is G-aligned)
  const int head =
      min(E, (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) /
                   sizeof(G)));
  const int n_vec = (E - head) / V;
  int last = -1;            // each thread visits its indices in order
  for (int i = tid; i < head; i += nthr)
    if (g[i] != G(0)) last = i;
  const int4* gv = reinterpret_cast<const int4*>(g + head);
  for (int j = tid; j < n_vec; j += nthr) {
    union {
      int4 q;
      G e[V];
    } u;
    u.q = __ldg(gv + j);
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (u.e[k] != G(0)) last = head + j * V + k;
  }
  for (int i = head + n_vec * V + tid; i < E; i += nthr)
    if (g[i] != G(0)) last = i;
  last = __reduce_max_sync(0xffffffffu, last);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) red[warp] = last;
  __syncthreads();
  int m = -1;
  for (int k = 0; k < ((nthr + 31) >> 5); ++k) m = max(m, red[k]);
  __syncthreads();                      // red is reused
  return m + 1;
}

// Keep, in list order, the events i of [0, cnt) for which get(i, e) is
// true (it fills the entry e); returns the kept count to every thread.
// Warp w looks at events [w * 32 * kPerLane, (w + 1) * 32 * kPerLane), 32
// at a time, so cnt must not pass kPerLane * blockDim.x.  All threads must
// call it; the kept list is complete on return.
template <int kPerLane, typename Entry, typename Get>
__device__ int compact(int cnt, Get get, Entry* __restrict__ kept,
                       int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Entry e[kPerLane];
  unsigned bal[kPerLane];
  int n_warp = 0;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int i = (warp * kPerLane + r) * 32 + lane;
    const bool keep = i < cnt && get(i, e[r]);
    bal[r] = __ballot_sync(0xffffffffu, keep);
    n_warp += __popc(bal[r]);
  }
  int off;
  const int total = warp_offsets(n_warp, red, off);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (bal[r] >> lane & 1u) kept[off + __popc(bal[r] & below)] = e[r];
    off += __popc(bal[r]);
  }
  __syncthreads();                      // the kept list is complete
  return total;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace sne
