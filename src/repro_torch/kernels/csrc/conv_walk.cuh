// The ordered conv walk the three conv kernels share (event_conv.cu,
// event_conv_window.cu, network_window.cu).
//
// A conv event (x0, y0, c, g) adds W_flipped[ki, kj, c, :] * g to the K x K
// patch of slab sites (x0 + ki, y0 + kj, :).  Two events' patches overlap
// and float addition is not associative, so bitwise equality with the plain
// version needs every site's adds in list order.  The walk gets that order
// without a barrier per event: every slab site has exactly one owning
// thread, which applies, in list order, every event whose patch covers it.
// Whether its neighbours have got that far does not matter.
//
// A block owns a band of slab rows r0, r0 + step, r0 + 2 step, ... (the
// kernels deal a slab's rows to their blocks in turn, so that the rows
// where events gather spread over the blocks) and C channels.  A lane is
// one (row, channel) of the band, lane l = k * C + co for its k-th row;
// site (row, y, co) lives in shared memory at mem[y * lanes + l].  A run is
// kSeg sites of one lane, columns y0 .. y0 + kSeg - 1; run u is lane
// u mod lanes at segment u / lanes, so a warp's runs are neighbouring
// lanes and touch consecutive words at every column, with no bank
// conflicts.  Thread t owns the runs t, t + blockDim.x, ... and is the
// only thread that reads or writes their sites.  Whether a site is hot
// (interior and in a hot tile) is computed once per band row and column,
// as one bit (band_hot_bits), never per sweep (the window kernels only).
//
// One walk over a timestep's event list (walk_end and compact are
// walk_common.cuh's):
//  1. walk_end: the block reads the gate row once (16-byte loads) and
//     max-reduces the last index with a gate set; nothing past it is read,
//     so any gate pattern is walked right.
//  2. compact: up to kPerLane * blockDim.x events at a time, each lane
//     loads its events (coordinates and gate straight into registers: each
//     is read once), clamps them like the reference's dynamic_slice, and
//     keeps, in list order (__ballot_sync, __popc and one barrier for the
//     warps' offsets), only the gated events whose patch rows x0 .. x0+K-1
//     meet the band.
//  3. walk_runs: every thread loads its run's kSeg sites into registers
//     and walks the kept list serially; for each event whose patch covers
//     its row and columns it applies up to K adds (one per kj) with the
//     same mul_rn / add_rn as the plain version, then stores the run back.
//     The next entry is loaded while the current one is applied, and the
//     weight loads are unconditional (clamped indices), so they issue
//     together instead of one branch at a time.
// So a stage costs three block barriers (two in compact, one before the
// next stage refills the kept list), whatever its number of events.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lif_common.cuh"
#include "scatter_common.cuh"
#include "walk_common.cuh"

namespace sne {
namespace conv {

constexpr int kSeg = 8;          // sites of one lane in a run

// The block shape of the two standalone conv kernels (event_conv.cu,
// event_conv_window.cu; event_conv/ops.py mirrors it).
constexpr int kPerLane = 4;      // events a thread filters per stage
constexpr int kMinThreads = 256; // threads that filter, even for few lanes
constexpr int kMaxThreads = 512;

// threads of a block whose band has `runs` runs (a multiple of 32; a
// thread owns several runs past kMaxThreads)
inline int block_threads(int runs) {
  const int t = (runs + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : (t > kMaxThreads ? kMaxThreads : t);
}

// A block's band of a conv slab.
struct Band {
  int Hp, Wp, C;        // slab rows and columns (halo included), channels
  int K, Ci, halo;      // kernel, input channels, halo width
  int r0, step, rows;   // the band's slab rows r0 + k * step, k < rows
  int lanes;            // rows * C: one per (row, channel)
  int runs;             // lanes * ceil(Wp / kSeg)
  int words;            // hot-bit words per band row: ceil(Wp / 32)

  __host__ __device__ static Band make(int Hp, int Wp, int C, int K, int Ci,
                                       int halo, int r0, int step,
                                       int rows) {
    rows = rows > 0 ? rows : 0;
    return Band{Hp,        Wp,   C,    K,        Ci,
                halo,      r0,   step, rows,     rows * C,
                rows * C * ((Wp + kSeg - 1) / kSeg), (Wp + 31) / 32};
  }
  // slab row and channel of lane l
  __device__ __forceinline__ void lane(int l, int& row, int& co) const {
    const int k = l / C;
    row = r0 + k * step;
    co = l - k * C;
  }
  // lane and first column of run u
  __device__ __forceinline__ void run(int u, int& l, int& y0) const {
    const int seg = u / lanes;
    l = u - seg * lanes;
    y0 = seg * kSeg;
  }
  // whether slab row `row` is an interior row
  __device__ __forceinline__ bool row_inside(int row) const {
    return row >= halo && row < Hp - halo;
  }
  // whether column y is an interior column
  __device__ __forceinline__ bool col_inside(int y) const {
    return y >= halo && y < Wp - halo;
  }
  // whether any row of the band lies in [lo, hi]
  __device__ __forceinline__ bool has_row_in(int lo, int hi) const {
    const int k = lo > r0 ? (lo - r0 + step - 1) / step : 0;
    return k < rows && r0 + k * step <= hi;
  }
  // whether an event with clamped patch origin row x0 touches the band
  __device__ __forceinline__ bool meets(int x0) const {
    return has_row_in(x0, x0 + K - 1);
  }
};

// The band's hot bits: bit y of its k-th row's words is set when that
// row's site y is interior and in a hot tile.  `hot` is the slot's tile
// bitmap in shared memory, or null for a layer every tile of which is hot.
// All threads must call it; the bits are complete after the next block
// barrier.
__device__ __forceinline__ void band_hot_bits(const Band& b, const int* hot,
                                              int th, int tw, int nTy,
                                              uint32_t* bits) {
  for (int i = threadIdx.x; i < b.rows * b.words; i += blockDim.x) {
    const int r = i / b.words, w = i - r * b.words;
    const int row = b.r0 + r * b.step, xi = row - b.halo;
    uint32_t m = 0;
    if (b.row_inside(row)) {
      for (int j = 0; j < 32; ++j) {
        const int y = w * 32 + j;
        if (b.col_inside(y) &&
            (!hot || hot[tile_of(xi, y - b.halo, th, tw, nTy)]))
          m |= 1u << j;
      }
    }
    bits[i] = m;
  }
}

__device__ __forceinline__ bool hot_bit(const Band& b, const uint32_t* bits,
                                        int l, int y) {
  return bits[(l / b.C) * b.words + (y >> 5)] >> (y & 31) & 1u;
}

// A conv event of a list in halo coordinates, clamped like the
// reference's dynamic_slice, as a kept entry (x0, y0, c, gate bits), if
// its gate is set and its patch meets the band.
template <typename Acc>
__device__ __forceinline__ bool conv_event(const Band& b, int x, int y,
                                           int c, Acc g, int4& e) {
  if (g == Acc(0)) return false;
  const int x0 = min(max(x, 0), b.Hp - b.K);
  if (!b.meets(x0)) return false;
  e = make_int4(x0, min(max(y, 0), b.Wp - b.K), min(max(c, 0), b.Ci - 1),
                to_bits(g));
  return true;
}

// Apply the kept list to every run this thread owns.  `wsh` holds the
// block's flipped weights, wsh[((ki * K + kj) * Ci + c) * C + co].
template <typename Acc, typename W>
__device__ void walk_runs(const Band& b, Acc* __restrict__ mem,
                          const W* __restrict__ wsh,
                          const int4* __restrict__ kept, int n_kept) {
  if (n_kept == 0) return;
  const int K = b.K, L = b.lanes, kCiC = b.Ci * b.C;
  for (int u = threadIdx.x; u < b.runs; u += blockDim.x) {
    int l, y0, row, co;
    b.run(u, l, y0);
    b.lane(l, row, co);
    Acc a[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      a[j] = y0 + j < b.Wp ? mem[(y0 + j) * L + l] : Acc(0);
    int4 next = kept[0];
    for (int m = 0; m < n_kept; ++m) {
      const int4 e = next;
      next = kept[min(m + 1, n_kept - 1)];
      const int ki = row - e.x;
      const int dy = y0 - e.y;              // site j takes kj = dy + j
      if ((unsigned)ki >= (unsigned)K || dy >= K || dy + kSeg <= 0)
        continue;
      const Acc g = from_bits<Acc>(e.w);
      const int w0 = (ki * K * b.Ci + e.z) * b.C + co;
      Acc wv[kSeg];
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        wv[j] = static_cast<Acc>(wsh[w0 + min(max(dy + j, 0), K - 1) * kCiC]);
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const Acc s = add_rn(a[j], mul_rn(wv[j], g));
        a[j] = (unsigned)(dy + j) < (unsigned)K ? s : a[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      if (y0 + j < b.Wp) mem[(y0 + j) * L + l] = a[j];
  }
}

}  // namespace conv
}  // namespace sne
