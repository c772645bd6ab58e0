// The staged fc column walk (event_fc.cu, event_fc_window.cu).
//
// An fc event (x, y, c, g) adds W[(x * Win + y) * Cin + c, d] * g to every
// output column d of W (Din, Dout).  A column's adds must come in list
// order (float addition is not associative), so each column has one
// owning thread: a block owns columns [lo, lo + cols) of one slot, thread
// d < cols owns column lo + d, keeps its membrane in a register and is
// the only thread that adds to it.
//
// One walk over a timestep's event list (walk_end, compact and the
// cp.async helpers are walk_common.cuh's):
//  1. walk_end: the block reads the gate row once and stops at its last
//     gated event.
//  2. compact: up to kStage events at a time, each lane loads its events
//     (coordinates and gate straight into registers) and keeps, in list
//     order, the gated events whose row lies in [0, Din), as (row, gate
//     bits); a row named twice is kept twice.
//  3. stage: the whole block copies the kept rows' block columns into
//     shared memory with cp.async, a chunk of rows at a time, every copy
//     of a chunk in flight at once, into two buffers in turn, so that the
//     next chunk loads while the owners sum this one.
//  4. sum: each owner adds its column of the chunk, in list order, with
//     the plain version's mul_rn / add_rn.
// A stage costs two barriers (compact) plus one per chunk, whatever its
// number of events.
//
// Weights of 1 byte (int8 codes) are staged as the 4-byte words that hold
// a row's columns (cp.async moves 4 bytes at least), and read back from
// the row's byte offset in its first word.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter_common.cuh"
#include "walk_common.cuh"

namespace sne {
namespace fc {

constexpr int kThreads = 256;                // block size (event_fc/ops.py)
constexpr int kPerLane = 4;                  // events a lane filters
constexpr int kStage = kPerLane * kThreads;  // events per stage
constexpr int kBufWords = 4096;              // 4-byte words of one buffer

// A block's columns of W (Din, Dout): [lo, lo + cols), cols <= kThreads.
template <typename Wt>
struct Cols {
  const Wt* w;
  int Din, Dout, lo, cols;
  int wpr;      // words a staged row takes
  int chunk;    // rows a buffer holds

  __device__ static Cols make(const Wt* w, int Din, int Dout, int lo,
                              int cols) {
    const int wpr =
        sizeof(Wt) == 4 ? cols : (cols * (int)sizeof(Wt) + 3) / 4 + 1;
    return Cols{w, Din, Dout, lo, cols, wpr, kBufWords / wpr};
  }
  // the address of W[row, lo]
  __device__ __forceinline__ uintptr_t first(int row) const {
    return reinterpret_cast<uintptr_t>(w + (size_t)row * Dout + lo);
  }
};

// The shared memory of a walk.
struct Scratch {
  int2* kept;   // kStage kept events: (row, gate bits)
  int* buf;     // two staging buffers of kBufWords words
  int* red;     // 32 warp partials
};

// Start copying the block columns of kept rows [m0, m0 + cnt) into `buf`,
// row k of the chunk at buf + k * wpr.
template <typename Wt>
__device__ __forceinline__ void stage_rows(const Cols<Wt>& cl,
                                           const int2* kept, int m0,
                                           int cnt, int* buf) {
  for (int i = threadIdx.x; i < cnt * cl.wpr; i += blockDim.x) {
    const int k = i / cl.wpr, j = i - k * cl.wpr;
    const uintptr_t a = cl.first(kept[m0 + k].x);
    const uintptr_t word = (a & ~(uintptr_t)3) + 4 * (uintptr_t)j;
    // 1-byte weights: the words that hold the row's columns, no more
    if (sizeof(Wt) == 4 || word < a + cl.cols * sizeof(Wt))
      cp_async4(buf + i, reinterpret_cast<const void*>(word));
  }
  cp_async_commit();
}

// Column d of staged row k (W row `row`).
template <typename Wt>
__device__ __forceinline__ Wt staged(const Cols<Wt>& cl, const int* buf,
                                     int k, int row, int d) {
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(buf + k * cl.wpr);
  if constexpr (sizeof(Wt) != 4) p += cl.first(row) & 3;
  return reinterpret_cast<const Wt*>(p)[d];
}

// Add one event list (E events and gates, in list order) to this
// thread's column, `acc` (threads d >= cl.cols hold none).  Gates of type
// G are read raw by walk_end and cast to Acc before they are tested and
// kept (the per-step kernel's int8 pairing: int8 gates, int32 sums).  All
// threads must call it; on return the scratch may be reused.
template <typename Wt, typename G, typename Acc>
__device__ void walk(const Cols<Wt>& cl, const int32_t* __restrict__ ev,
                     const G* __restrict__ gate, int E, int Win, int Cin,
                     const Scratch& sc, Acc& acc) {
  const int d = threadIdx.x;
  const int n_walk = walk_end<kThreads>(gate, E, sc.red);
  for (int base = 0; base < n_walk; base += kStage) {
    if (base > 0) __syncthreads();           // the last stage is summed
    const int n_kept = compact<kPerLane>(
        min(kStage, n_walk - base),
        [&](int i, int2& e) {
          const int32_t* x = ev + (size_t)(base + i) * 3;
          const Acc g = static_cast<Acc>(gate[base + i]);
          const long long row =
              ((long long)__ldg(x) * Win + __ldg(x + 1)) * Cin + __ldg(x + 2);
          if (g == Acc(0) || row < 0 || row >= cl.Din) return false;
          e = make_int2((int)row, to_bits(g));
          return true;
        },
        sc.kept, sc.red);
    if (n_kept == 0) continue;                // uniform across the block
    stage_rows(cl, sc.kept, 0, min(cl.chunk, n_kept), sc.buf);
    for (int m0 = 0, b = 0; m0 < n_kept; m0 += cl.chunk, b ^= 1) {
      cp_async_wait<0>();
      // chunk b has landed, and every owner has summed the chunk before
      // it, whose buffer the next copy takes
      __syncthreads();
      const int next = m0 + cl.chunk;
      if (next < n_kept)
        stage_rows(cl, sc.kept, next, min(cl.chunk, n_kept - next),
                   sc.buf + (b ^ 1) * kBufWords);
      if (d < cl.cols) {
        const int* cb = sc.buf + b * kBufWords;
        const int cnt = min(cl.chunk, n_kept - m0);
#pragma unroll 4
        for (int k = 0; k < cnt; ++k) {
          const int2 e = sc.kept[m0 + k];
          acc = add_rn(acc, mul_rn(static_cast<Acc>(staged(cl, cb, k, e.x,
                                                           d)),
                                   from_bits<Acc>(e.y)));
        }
      }
    }
  }
}

}  // namespace fc
}  // namespace sne
