// The event walk both pool kernels share (event_pool.cu,
// event_pool_window.cu).
//
// A pool launch splits one slot's S sites over n_thr = P * kThreads
// threads (P blocks, n_thr a power of two): thread r owns the sites s with
// s mod n_thr == r, and is the only one that reads or writes them, so each
// site sees its events' adds in list order, without atomics.  Owned site
// s = r + j * n_thr lives in shared memory at mem[j * kThreads + tid]
// (every thread's column is its own bank).
//
// One walk over a slot's event list (or one timestep's; walk_end and the
// cp.async helpers are walk_common.cuh's):
//  1. walk_end: the block reads the gate row once (16-byte loads and a
//     scalar head and tail) and max-reduces the last index with a gate set;
//     nothing past it is read.  Any gate pattern is walked right: this is
//     the plain version's `last_active`, taken per slot.
//  2. stage: the raw (x, y, c) triples and gates of up to kStage events
//     are copied to shared memory with cp.async, the next stage's copy in
//     flight while the current one is filtered and walked.
//  3. compact: each event becomes (site, w[c] * gate); only the gated,
//     in-grid events whose site this block owns are kept, in list order
//     (__ballot_sync, __popc, and a prefix over the warps' counts), as
//     (shared-memory index, value).
//  4. owner walk: every thread scans the kept list and applies the entries
//     of its own column, in order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter_common.cuh"
#include "walk_common.cuh"

namespace sne {
namespace pool {

constexpr int kThreadsLog2 = 8;
constexpr int kThreads = 1 << kThreadsLog2;   // block size of both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 2048;                  // events per stage
constexpr int kPerLane = kStage / kThreads;   // events a lane filters
// dynamic shared memory before the owned membranes: two raw stages
// ((x, y, c) and a 4-byte gate word per event), the kept list ((index,
// value), both 4 bytes in every pairing) and the per-warp partials
constexpr size_t kStageBytes =
    ((size_t)2 * 4 * kStage + 2 * kStage + kWarps) * sizeof(int);

// owned sites per thread
__host__ __device__ inline int owned_per_thread(int S, int n_thr) {
  return (S + n_thr - 1) / n_thr;
}

// the whole dynamic shared memory of one pool block
inline size_t smem_bytes(int S, int n_thr) {
  return kStageBytes +
         (size_t)owned_per_thread(S, n_thr) * kThreads * sizeof(int);
}

// The pooled geometry of an event, and this block's share of its sites.
struct Geom {
  int Ho, Wo, C, stride;
  int shift;     // log2(n_thr)
  int blocks;    // P, a power of two
};

struct Scratch {
  int* raw;            // two raw stages, 4 * kStage words each
  int* kept_loc;       // shared-memory index of each kept event's site
  void* kept_val;      // its value w[c] * gate, accumulator dtype
  int* red;            // kWarps per-warp partials (walk end, kept counts)
  // raw stage b: (x, y, c) of kStage events in list order, then their
  // 4-byte gates
  __device__ int* xyc(int b) const { return raw + b * 4 * kStage; }
  __device__ int* gates(int b) const { return xyc(b) + 3 * kStage; }
};

// Start copying events [base, base + cnt) of a list into raw buffer b.
// Gates of 1 byte are not copied (cp.async moves 4 bytes at least): the
// filter reads them from device memory.
template <typename G>
__device__ __forceinline__ void stage_raw(Scratch& sc, int b,
                                          const int32_t* __restrict__ ev,
                                          const G* __restrict__ gate,
                                          int base, int cnt) {
  const int32_t* src = ev + (size_t)base * 3;
  for (int i = threadIdx.x; i < 3 * cnt; i += kThreads)
    cp_async4(sc.xyc(b) + i, src + i);
  if constexpr (sizeof(G) == 4)
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      cp_async4(sc.gates(b) + i, gate + base + i);
  cp_async_commit();
}

// Filter raw buffer b (cnt events from list index base) into the kept
// list, in list order; returns the kept count to every thread.  Warp w
// filters events [w * 32 * kPerLane, (w + 1) * 32 * kPerLane) of the
// stage, 32 at a time.  All threads must call it.
template <typename G, typename Wt, typename Acc>
__device__ int compact(Scratch& sc, int b, const G* __restrict__ gate,
                       int base, int cnt, const Wt* __restrict__ w,
                       const Geom& geo) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* xyc = sc.xyc(b);
  int loc[kPerLane];
  Acc val[kPerLane];
  unsigned bal[kPerLane];
  int n_warp = 0;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int i = (warp * kPerLane + r) * 32 + lane;
    int l = -1;
    Acc v = Acc(0);
    if (i < cnt) {
      Acc g;
      if constexpr (sizeof(G) == 4)
        g = static_cast<Acc>(reinterpret_cast<const G*>(sc.gates(b))[i]);
      else
        g = static_cast<Acc>(gate[base + i]);
      const int x = xyc[3 * i], y = xyc[3 * i + 1], c = xyc[3 * i + 2];
      if (g != Acc(0) && x >= 0 && y >= 0 && c >= 0 && c < geo.C) {
        const int xo = x / geo.stride, yo = y / geo.stride;
        if (xo < geo.Ho && yo < geo.Wo) {
          const int site = (xo * geo.Wo + yo) * geo.C + c;
          if (((site >> kThreadsLog2) & (geo.blocks - 1)) ==
              (int)blockIdx.y) {
            l = ((site >> geo.shift) << kThreadsLog2) |
                (site & (kThreads - 1));
            v = mul_rn(static_cast<Acc>(w[c]), g);
          }
        }
      }
    }
    loc[r] = l;
    val[r] = v;
    bal[r] = __ballot_sync(0xffffffffu, l >= 0);
    n_warp += __popc(bal[r]);
  }
  if (lane == 0) sc.red[warp] = n_warp;
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int t = sc.red[k];
    off += k < warp ? t : 0;
    total += t;
  }
  const unsigned below = (1u << lane) - 1u;
  Acc* kept_val = static_cast<Acc*>(sc.kept_val);
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (loc[r] >= 0) {
      const int p = off + __popc(bal[r] & below);
      sc.kept_loc[p] = loc[r];
      kept_val[p] = val[r];
    }
    off += __popc(bal[r]);
  }
  __syncthreads();                      // the kept list is complete
  return total;
}

// Apply one event list (E events and gates, in list order) to this
// block's owned membranes `mem`.  All threads must call it; on return the
// scratch may be reused.
template <typename G, typename Wt, typename Acc>
__device__ void walk(Scratch& sc, const int32_t* __restrict__ ev,
                     const G* __restrict__ gate, int E,
                     const Wt* __restrict__ w, const Geom& geo, Acc* mem) {
  const int tid = threadIdx.x;
  const int n_walk = walk_end<kThreads>(gate, E, sc.red);
  if (n_walk == 0) return;
  stage_raw(sc, 0, ev, gate, 0, min(kStage, n_walk));
  const Acc* kept_val = static_cast<const Acc*>(sc.kept_val);
  for (int base = 0, b = 0; base < n_walk; base += kStage, b ^= 1) {
    const int cnt = min(kStage, n_walk - base);
    // raw buffer b ^ 1 was last read by the previous stage's filter,
    // which every thread has finished (the barrier after it)
    if (base + kStage < n_walk) {
      stage_raw(sc, b ^ 1, ev, gate, base + kStage,
                min(kStage, n_walk - base - kStage));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();        // stage b has landed; the last walk is done
    const int n_kept = compact<G, Wt, Acc>(sc, b, gate, base, cnt, w, geo);
#pragma unroll 4
    for (int m = 0; m < n_kept; ++m) {
      const int l = sc.kept_loc[m];
      if ((l & (kThreads - 1)) == tid) mem[l] = add_rn(mem[l], kept_val[m]);
    }
  }
  __syncthreads();          // the kept list and raw buffers may be reused
}

// Carve the dynamic shared memory: the scratch, then the owned membranes.
template <typename Acc>
__device__ __forceinline__ Acc* carve(unsigned char* smem, Scratch& sc) {
  static_assert(sizeof(Acc) == sizeof(int), "smem_bytes sizes 4-byte sites");
  int* p = reinterpret_cast<int*>(smem);
  sc.raw = p;
  p += 2 * 4 * kStage;
  sc.kept_loc = p;
  sc.kept_val = p + kStage;
  sc.red = p + 2 * kStage;
  return reinterpret_cast<Acc*>(p + 2 * kStage + kWarps);
}

}  // namespace pool
}  // namespace sne
