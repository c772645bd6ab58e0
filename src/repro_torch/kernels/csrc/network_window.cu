// The fused-network window: every layer of the program over every timestep
// of a serving window in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `network_window_pallas`
// (src/repro/kernels/network_window/kernel.py, body
// `_network_window_kernel`).  For every slot n and timestep t, in order,
// and for every layer l, in order, on the layer's halo-padded membranes:
//
//     leak (interior sites of hot tiles)
//     -> scatter the layer's events of t, in event order (layer 0: the
//        collector's schedule; later layers: the events routed from layer
//        l-1's spikes of t)
//     -> clip -> fire -> reset (interior sites of hot tiles; cold sites
//        emit 0) -> (native) int8 clamp of the whole slab, halo included
//     -> route the spike frame: its first cap' = min(cap, sites) nonzero
//        sites in row-major (x, y, c) order become layer l+1's events;
//        n - cap' more are counted as dropped
//
// A timestep with alive[n, t] == 0 freezes the whole network: no layer
// changes and the last layer's frame of t is zero.  Layer 0's count sums
// every gate of the window, frozen timesteps included; a later layer's
// count is the events routed into it.  After the window, every interior
// site of a cold tile of a hard-reset layer settles with one analytic idle
// decay over the slot's alive timesteps.  Only the last layer's spike
// frames leave the kernel (N, T, Ho, Wo, C, accumulator dtype, every entry
// written once), with the final membranes and the (N, L) counts and drops.
//
// What bounds it on the card: the serial chains of events and the
// synchronisation between layers.  A conv event's patch may overlap the
// next one's and float addition is not associative, so every site needs
// its adds in event order; a routed frame must be complete, cluster-wide,
// before the next layer reads it.  The bytes (each slab in and out once,
// the schedule, the fc rows named, the last layer's frames) are far below
// what the chains and barriers cost.
//
// Design: one thread-block cluster of kCluster CTAs per slot (grid N x
// kCluster, `__cluster_dims__`).  Conv and pool slabs are dealt to the
// cluster's CTAs a row at a time, row r to rank r mod kCluster (a conv's
// halo rows included), so that a frame's activity, which gathers in a few
// places, spreads over every CTA; fc layers are cut into column blocks.
// A CTA's rows of every slab, the conv and pool weights, the bitmaps and
// its routed lists stay in its shared memory for the whole window.  The
// layout is per CTA and computed by the wrapper
// (`network_window/ops.py::smem_layout`), which is also what the
// executor's fallback rule prices.  Every site has one owning thread,
// which runs every step on it: leak, its events in list order, clip,
// fire, reset, clamp, the cold-tile settle.  Per layer kind:
//   conv: the ordered walk of conv_walk.cuh (runs of kSeg sites of one
//         row and channel, no barrier per event);
//   pool: each site's owner applies, in order, the kept events of its
//         rows (filtered in list order, as in pool_walk.cuh), summing in
//         a register;
//   fc:   each column's serial sum over the gated rows, the rows' weights
//         staged by the whole CTA a chunk at a time.
// Each layer's events are filtered once per stage into a kept list, in
// list order, keeping only what meets the CTA's rows.
// Routing is a cluster-wide ordered compaction.  A frame is a sequence of
// segments, one frame row each (fc: one CTA's column block), each owned
// by one CTA.  Each CTA marks its spikes as one bit per site, compacts
// them in frame order into its own list in shared memory (a block-wide
// prefix over the words) and publishes each of its segments' counts
// there; one cluster barrier (barrier.cluster arrive.release /
// wait.acquire, which orders the shared::cluster writes before it with
// the reads after it) closes the step.  Every CTA then reads the counts
// of every segment through distributed shared memory, takes their prefix
// as the segments' offsets in the routed list, and reads, segment by
// segment, the entries below cap' of the segments whose row can meet its
// own rows: the routed list in frame order.  The drop count is the total
// minus cap'.  The lists are double-buffered by routing step: a list is
// rewritten two steps later, after a cluster barrier that every CTA
// reaches only once it has walked that list.  A last cluster barrier
// keeps every CTA's shared memory alive until no other CTA can read it.
#include <cooperative_groups.h>

#include "conv_walk.cuh"
#include "lif_common.cuh"

namespace cg = cooperative_groups;

namespace {

using sne::conv::Band;
using sne::from_bits;
using sne::conv::kSeg;
using sne::to_bits;

constexpr int kCluster = 8;          // network_window/ops.py CLUSTER
constexpr int kThreads = 512;        // network_window/ops.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 2;          // network_window/ops.py PER_LANE
constexpr int kStage = kPerLane * kThreads;
constexpr int kFcBuf = 4096;         // network_window/ops.py FC_BUF
constexpr int kMaxLayers = 12;       // network_window/ops.py MAX_LAYERS
constexpr int kDescInts = 23;        // ints per layer in the descriptor
enum { kConv = 0, kPool = 1, kFc = 2 };

struct Layer {
  int kind, Hp, Wp, C, halo, K, Ci, pad, stride, Win, Cin, cap, nTx, nTy,
      th, tw, mem_off, mask_off, w_off, Din;
  sne::LifArgs p;
  const void* v;         // (N, Hp, Wp, C) membranes in, storage dtype
  const void* w;         // weights (conv unflipped, pool (C,), fc (Din, C))
  void* v_out;           // (N, Hp, Wp, C) membranes out
  const int32_t* tiles;  // (N, nTx, nTy) bitmap, or null: every tile hot
};

struct Net {
  Layer layer[kMaxLayers];
  int L, T, E0, list_cap, seg_cap, nseg_cap, hot_off, bits_off, list_off,
      kept_off, tally_off, fcbuf_off;
  const int32_t* ev;     // (N, T, E0, 3) layer-0 events
  const void* gate;      // (N, T, E0) layer-0 gates, accumulator dtype
  const float* alive;    // (N, T)
  void* s_last;          // (N, T, Ho, Wo, C) last layer's spikes
  int32_t* counts;       // (N, L)
  int32_t* drops;        // (N, L)
};

// A CTA's share of a layer.  Conv and pool layers are split by rows over
// the cluster, row r to rank r mod kCluster (conv: slab rows, halo rows
// counted; pool: output rows), so that a frame's activity, which gathers
// in a few places, spreads over every CTA; fc layers are split by
// columns, [lo, lo + sites).  The share's frame sites (its interior rows
// in order, each row-major (y, c)) form a local frame of `frame_sites`
// sites, in segments: one frame row (conv, pool) or the whole column
// share (fc).  The routed list is every segment of the frame, in frame
// order, from the shared memory of the rank that owns it.
struct Share {
  int rows;          // conv, pool: owned rows, rank + k * kCluster
  int k_int;         // conv, pool: owned rows before the first interior
  int segs;          // owned frame segments (interior rows; fc: 1)
  int seg_sites;     // sites of a segment: Wo * C (fc: the share's columns)
  int lo;            // fc: first column
  int frame_sites;   // segs * seg_sites
  int sites;         // owned positions: conv lanes, pool and fc sites
};

__device__ __forceinline__ int owned_rows(int total, int rank) {
  return rank < total ? (total - 1 - rank) / kCluster + 1 : 0;
}

__device__ Share share_of(const Layer& ly, int rank) {
  Share s{};
  if (ly.kind == kFc) {
    const int per = (ly.C + kCluster - 1) / kCluster;
    s.lo = min(rank * per, ly.C);
    s.segs = 1;
    s.frame_sites = s.sites = s.seg_sites = min(s.lo + per, ly.C) - s.lo;
    return s;
  }
  const int Ho = ly.Hp - 2 * ly.halo, Wo = ly.Wp - 2 * ly.halo;
  const int h = ly.kind == kConv ? ly.halo : 0;
  s.rows = owned_rows(ly.kind == kConv ? ly.Hp : Ho, rank);
  s.k_int = owned_rows(h, rank);
  s.segs = owned_rows(h + Ho, rank) - s.k_int;
  s.seg_sites = Wo * ly.C;
  s.frame_sites = s.segs * s.seg_sites;
  s.sites = s.rows * (ly.kind == kConv ? 1 : Wo) * ly.C;
  return s;
}

__device__ __forceinline__ Band band_of(const Layer& ly, const Share& s,
                                        int rank) {
  return Band::make(ly.Hp, ly.Wp, ly.C, ly.K, ly.Ci, ly.halo, rank, kCluster,
                    s.rows);
}

// The layer's frame index of the share's local frame site lf.
__device__ __forceinline__ int frame_site(const Layer& ly, const Share& s,
                                          int rank, int lf) {
  if (ly.kind == kFc) return s.lo + lf;
  const int seg = lf / s.seg_sites;
  const int h = ly.kind == kConv ? ly.halo : 0;
  return (rank + (s.k_int + seg) * kCluster - h) * s.seg_sites +
         (lf - seg * s.seg_sites);
}

// Segments of a producer's frame, and the rank and local index of one.
__device__ __forceinline__ int frame_segments(const Layer& ly) {
  return ly.kind == kFc ? kCluster : ly.Hp - 2 * ly.halo;
}
__device__ __forceinline__ void segment_owner(const Layer& ly, int x, int& q,
                                              int& j) {
  if (ly.kind == kFc) {
    q = x;
    j = 0;
    return;
  }
  const int h = ly.kind == kConv ? ly.halo : 0;
  q = (x + h) % kCluster;
  j = (x + h) / kCluster - owned_rows(h, q);
}

// Whether a consumer's share can take any event of a producer segment
// whose events all have input row `x` (exact: the filter would drop them
// all otherwise).
__device__ __forceinline__ bool segment_meets(const Layer& ly, const Band& b,
                                              int rank, int x) {
  if (ly.kind == kFc) return true;
  if (ly.kind == kConv)
    return b.meets(min(max(x + ly.pad, 0), ly.Hp - ly.K));
  const int xo = x / ly.stride;
  return xo < ly.Hp && xo % kCluster == rank;
}

// Block-wide exclusive prefix sum of one int per thread; every thread also
// gets the block's total.  All threads must call it.
__device__ int block_exclusive_sum(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  const int before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();                      // warp_sums may be reused
  return before + x - v;
}

// A raw event (x, y, c, gate) as a kept entry of this CTA's share, if it
// is gated and meets the share.  conv: (x0, y0, c, gate) clamped; pool:
// (band site, w[c] * gate); fc: (weight row, gate).
template <typename Wt, typename Acc>
__device__ __forceinline__ bool keep_event(const Layer& ly, const Band& b,
                                           int rank, const Wt* wsh, int x,
                                           int y, int c, Acc g, int4& e) {
  if (ly.kind == kConv) return sne::conv::conv_event(b, x, y, c, g, e);
  if (g == Acc(0)) return false;
  if (ly.kind == kPool) {
    // one site per event; past the pooled grid it is dropped (VALID)
    if (x < 0 || y < 0 || c < 0 || c >= ly.C) return false;
    const int xo = x / ly.stride, yo = y / ly.stride;
    const int Wo = ly.Wp;
    if (xo >= ly.Hp || xo % kCluster != rank || yo >= Wo) return false;
    e.x = ((xo / kCluster) * Wo + yo) * ly.C + c;
    e.y = to_bits(sne::mul_rn(static_cast<Acc>(wsh[c]), g));
    return true;
  }
  const long long row = ((long long)x * ly.Win + y) * ly.Cin + c;
  if (row < 0 || row >= ly.Din) return false;
  e.x = (int)row;
  e.y = to_bits(g);
  return true;
}

// Apply a kept list to this CTA's share of the layer, every site by its
// owner, in list order.  `wbuf` holds kFcBuf accumulators for fc rows.
template <typename Wt, typename Acc>
__device__ __forceinline__ void walk(const Layer& ly, const Share& s,
                                     const Band& b, Acc* mem, const Wt* wsh,
                                     const int4* kept, int n_kept,
                                     Acc* wbuf) {
  const int tid = threadIdx.x;
  if (ly.kind == kConv) {
    sne::conv::walk_runs(b, mem, wsh, kept, n_kept);
  } else if (ly.kind == kPool) {
    // site p's owner is thread p mod kThreads; it sums in a register, so
    // no shared-memory store orders the scan
    for (int p0 = 0; p0 < s.sites; p0 += kThreads) {
      const int p = p0 + tid;
      Acc a = p < s.sites ? mem[p] : Acc(0);
#pragma unroll 8
      for (int m = 0; m < n_kept; ++m) {
        const int2 e = *reinterpret_cast<const int2*>(kept + m);
        if (e.x == p) a = sne::add_rn(a, from_bits<Acc>(e.y));
      }
      if (p < s.sites) mem[p] = a;
    }
  } else {
    // the share's columns of the kept rows, a chunk of events at a time:
    // the whole CTA stages them (every load in flight at once), then each
    // column's owner sums them in list order
    const Wt* w = static_cast<const Wt*>(ly.w) + s.lo;
    const int cols = s.sites;
    if (cols == 0) return;                  // uniform across the CTA
    const int chunk = max(1, kFcBuf / cols);
    for (int m0 = 0; m0 < n_kept; m0 += chunk) {
      const int cnt = min(chunk, n_kept - m0);
      __syncthreads();                      // the last chunk is summed
#pragma unroll 8
      for (int i = tid; i < cnt * cols; i += kThreads) {
        const int k = i / cols;
        const int row = kept[m0 + k].x;
        wbuf[i] =
            static_cast<Acc>(__ldg(w + (size_t)row * ly.C + i - k * cols));
      }
      __syncthreads();                      // the chunk is staged
      for (int d = tid; d < cols; d += kThreads) {
        Acc a = mem[d];
        for (int k = 0; k < cnt; ++k)
          a = sne::add_rn(a, sne::mul_rn(wbuf[k * cols + d],
                                         from_bits<Acc>(kept[m0 + k].y)));
        mem[d] = a;
      }
    }
  }
}

__device__ __forceinline__ bool bit(const uint32_t* bits, int p) {
  return bits[p >> 5] >> (p & 31) & 1u;
}

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    network_window_kernel(const Net net) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x / kCluster, tid = threadIdx.x;
  const int L = net.L, T = net.T, E0 = net.E0;
  int* hot = reinterpret_cast<int*>(smem + net.hot_off);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + net.bits_off);
  // routed lists: the segments' spike counts of buffer 0 and 1 (seg_cap
  // each), padded to 16 bytes, then list 0 and list 1 (list_cap each)
  int* seg_count = reinterpret_cast<int*>(smem + net.list_off);
  int* lists = seg_count + ((2 * net.seg_cap + 3) & ~3);
  int4* kept = reinterpret_cast<int4*>(smem + net.kept_off);
  int* red = reinterpret_cast<int*>(smem + net.tally_off);
  // the producer frame's segments: counts, starts in their rank's list,
  // starts in the routed list below cap' (and its end)
  int* segc = red + 32;
  int* seg_start = segc + net.nseg_cap;
  int* vstart = seg_start + net.nseg_cap;
  int* tally = vstart + net.nseg_cap + 1;   // counts[L], then drops[L]
  Acc* wbuf = reinterpret_cast<Acc*>(smem + net.fcbuf_off);

  auto mem_of = [&](const Layer& ly) {
    return reinterpret_cast<Acc*>(smem + ly.mem_off);
  };
  auto mask_of = [&](const Layer& ly) {
    return reinterpret_cast<uint32_t*>(smem + ly.mask_off);
  };
  auto wsh_of = [&](const Layer& ly) {
    return ly.w_off < 0 ? nullptr
                        : reinterpret_cast<const Wt*>(smem + ly.w_off);
  };

  // stage the share's membranes, the weights and the bitmaps
  int max_frame = 0;
  for (int l = 0; l < L; ++l) {
    const Layer& ly = net.layer[l];
    const Share s = share_of(ly, rank);
    max_frame = max(max_frame, s.frame_sites);
    Acc* mem = mem_of(ly);
    const VS* v = static_cast<const VS*>(ly.v) +
                  (size_t)n * ly.Hp * ly.Wp * ly.C;
    const Wt* w = static_cast<const Wt*>(ly.w);
    if (ly.kind == kConv) {
      // site (lane l, column y) at mem[y * lanes + l]
      const Band b = band_of(ly, s, rank);
      for (int i = tid; i < ly.Wp * b.lanes; i += kThreads) {
        const int y = i / b.lanes;
        int row, co;
        b.lane(i - y * b.lanes, row, co);
        mem[i] = static_cast<Acc>(v[((size_t)row * ly.Wp + y) * ly.C + co]);
      }
      // wsh[((ki*K + kj)*Ci + c)*Co + co] = W[K-1-ki, K-1-kj, c, co]
      Wt* wsh = reinterpret_cast<Wt*>(smem + ly.w_off);
      const int K = ly.K, Ci = ly.Ci, Co = ly.C;
      for (int i = tid; i < K * K * Ci * Co; i += kThreads) {
        const int co = i % Co, r = i / Co;
        const int c = r % Ci, kk = r / Ci;
        const int ki = kk / K, kj = kk - ki * K;
        wsh[i] = w[((size_t)((K - 1 - ki) * K + (K - 1 - kj)) * Ci + c) *
                       Co + co];
      }
    } else if (ly.kind == kPool) {
      // local site p of owned row k is output row rank + k * kCluster
      const int row_sites = ly.Wp * ly.C;
      for (int p = tid; p < s.sites; p += kThreads) {
        const int k = p / row_sites;
        mem[p] = static_cast<Acc>(
            v[(size_t)(rank + k * kCluster) * row_sites + p - k * row_sites]);
      }
      Wt* wsh = reinterpret_cast<Wt*>(smem + ly.w_off);
      for (int i = tid; i < ly.C; i += kThreads) wsh[i] = w[i];
    } else {
      for (int p = tid; p < s.sites; p += kThreads)
        mem[p] = static_cast<Acc>(v[s.lo + p]);
    }
    const int n_tiles = ly.nTx * ly.nTy;
    for (int i = tid; i < n_tiles; i += kThreads)
      hot[l * sne::kMaxTiles + i] =
          ly.tiles ? ly.tiles[(size_t)n * n_tiles + i] : 1;
  }
  for (int i = tid; i < (max_frame + 31) / 32; i += kThreads) bits[i] = 0u;
  if (tid < 2 * L) tally[tid] = 0;
  __syncthreads();                          // the bitmaps are in
  // what depends only on a site, once: conv runs' masks; pool and fc
  // sites' hot bits
  for (int l = 0; l < L; ++l) {
    const Layer& ly = net.layer[l];
    const Share s = share_of(ly, rank);
    const int* hot_l = hot + l * sne::kMaxTiles;
    uint32_t* mask = mask_of(ly);
    if (ly.kind == kConv) {
      sne::conv::band_hot_bits(band_of(ly, s, rank), hot_l, ly.th, ly.tw,
                               ly.nTy, mask);
      continue;
    }
    for (int base = 0; base < s.sites; base += kThreads) {
      const int p = base + tid;
      bool h = false;
      if (p < s.sites) {
        int xo = 0, yo = 0;
        if (ly.kind == kPool) {
          const int q = p / ly.C, k = q / ly.Wp;
          xo = rank + k * kCluster;
          yo = q - k * ly.Wp;
        }
        h = hot_l[sne::tile_of(xo, yo, ly.th, ly.tw, ly.nTy)] != 0;
      }
      const unsigned word = __ballot_sync(0xffffffffu, h);
      if ((tid & 31) == 0 && p < s.sites) mask[p >> 5] = word;
    }
  }
  if (rank == 0) {
    // layer 0 consumes every gate of the window, frozen timesteps too
    const Acc* gate = static_cast<const Acc*>(net.gate) + (size_t)n * T * E0;
    int g = 0;
    for (int i = tid; i < T * E0; i += kThreads)
      g += static_cast<int>(gate[i]);
    int total;
    block_exclusive_sum(g, red, total);
    if (tid == 0) tally[0] = total;
  }
  __syncthreads();                          // the masks are in

  const Layer& last = net.layer[L - 1];
  const Share s_last_share = share_of(last, rank);
  const int S_last =
      (last.Hp - 2 * last.halo) * (last.Wp - 2 * last.halo) * last.C;
  int n_alive = 0, step = 0;                // step: routing steps so far
  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    Acc* s_t = static_cast<Acc*>(net.s_last) + nt * S_last;
    if (!(net.alive[nt] > 0.f)) {           // uniform: the network holds
      const int Wo = last.Wp - 2 * last.halo;
      if (last.kind == kConv) {
        const Band b = band_of(last, s_last_share, rank);
        for (int u = tid; u < b.runs; u += kThreads) {
          int ln, y0, row, co;
          b.run(u, ln, y0);
          b.lane(ln, row, co);
          if (!b.row_inside(row)) continue;
          for (int y = y0; y < min(y0 + kSeg, last.Wp); ++y)
            if (b.col_inside(y))
              s_t[((size_t)(row - last.halo) * Wo + y - last.halo) * last.C +
                  co] = Acc(0);
        }
      } else {
        for (int p = tid; p < s_last_share.sites; p += kThreads)
          s_t[frame_site(last, s_last_share, rank, p)] = Acc(0);
      }
      continue;
    }
    ++n_alive;
    for (int l = 0; l < L; ++l) {
      const Layer& ly = net.layer[l];
      const Share s = share_of(ly, rank);
      const Band b = band_of(ly, s, rank);
      Acc* mem = mem_of(ly);
      const uint32_t* mask = mask_of(ly);
      const Wt* wsh = wsh_of(ly);
      const bool routed = l < L - 1;
      const int Wo = ly.Wp - 2 * ly.halo;
      // leak: each owner its hot sites
      if (ly.kind == kConv) {
        for (int u = tid; u < b.runs; u += kThreads) {
          int ln, y0;
          b.run(u, ln, y0);
          for (int y = y0; y < min(y0 + kSeg, ly.Wp); ++y)
            if (sne::conv::hot_bit(b, mask, ln, y))
              mem[y * b.lanes + ln] =
                  sne::leak_step(mem[y * b.lanes + ln], ly.p);
        }
      } else {
        for (int p = tid; p < s.sites; p += kThreads)
          if (bit(mask, p)) mem[p] = sne::leak_step(mem[p], ly.p);
      }
      // scatter: filter the events a stage at a time, walk what was kept
      if (l == 0) {
        const int32_t* evt = net.ev + nt * E0 * 3;
        const Acc* gt = static_cast<const Acc*>(net.gate) + nt * E0;
        const int n_walk = sne::walk_end(gt, E0, red);
        for (int base = 0; base < n_walk; base += kStage) {
          if (base > 0) __syncthreads();   // the last stage is walked
          const int n_kept = sne::compact<kPerLane>(
              min(kStage, n_walk - base),
              [&](int i, int4& e) {
                const int32_t* x = evt + (size_t)(base + i) * 3;
                return keep_event<Wt, Acc>(ly, b, rank, wsh, __ldg(x),
                                           __ldg(x + 1), __ldg(x + 2),
                                           gt[base + i], e);
              },
              kept, red);
          walk<Wt, Acc>(ly, s, b, mem, wsh, kept, n_kept, wbuf);
        }
      } else {
        // the routed list of boundary l-1: every segment of layer l-1's
        // frame in order, below cap', from the rank that owns it
        const Layer& prod = net.layer[l - 1];
        const int buf = (step - 1) & 1;
        const int nseg = frame_segments(prod);
        for (int x = tid; x < nseg; x += kThreads) {
          int q, j;
          segment_owner(prod, x, q, j);
          segc[x] = *cluster.map_shared_rank(
              seg_count + buf * net.seg_cap + j, q);
        }
        __syncthreads();                    // the counts are in
        if (tid < 32) {
          // offsets in the routed list, starts in the owner's list, and
          // the starts of what this share keeps below cap'
          int off = 0, kept_len = 0;
          for (int x0 = 0; x0 < nseg; x0 += 32) {
            const int x = x0 + tid;
            const int c = x < nseg ? segc[x] : 0;
            int incl = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(0xffffffffu, incl, o);
              if (tid >= o) incl += y;
            }
            int len = max(0, min(c, ly.cap - (off + incl - c)));
            if (x < nseg &&
                !segment_meets(ly, b, rank, prod.kind == kFc ? 0 : x))
              len = 0;
            int vs = len;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(0xffffffffu, vs, o);
              if (tid >= o) vs += y;
            }
            if (x < nseg) {
              int start = 0;                // the owner's earlier segments
              if (prod.kind != kFc)
                for (int xp = x - kCluster; xp >= 0; xp -= kCluster)
                  start += segc[xp];
              seg_start[x] = start;
              vstart[x] = kept_len + vs - len;
            }
            off += __shfl_sync(0xffffffffu, incl, 31);
            kept_len += __shfl_sync(0xffffffffu, vs, 31);
          }
          if (tid == 0) {
            vstart[nseg] = kept_len;
            tally[l] += min(off, ly.cap);
            tally[L + l] += max(off - ly.cap, 0);
          }
        }
        __syncthreads();                    // the segment table is in
        const int nv = vstart[nseg];
        const int* list0 = lists + buf * net.list_cap;
        const int Cin = ly.Cin, Win = ly.Win, pad = ly.pad;
        for (int base = 0; base < nv; base += kStage) {
          if (base > 0) __syncthreads();   // the last stage is walked
          const int n_kept = sne::compact<kPerLane>(
              min(kStage, nv - base),
              [&](int i, int4& e) {
                const int v = base + i;
                // the last segment that starts at or before v
                int lo = 0, hi = nseg - 1;
                while (lo < hi) {
                  const int mid = (lo + hi + 1) >> 1;
                  if (vstart[mid] <= v) lo = mid; else hi = mid - 1;
                }
                int q, j;
                segment_owner(prod, lo, q, j);
                const int f = *cluster.map_shared_rank(
                    list0 + seg_start[lo] + (v - vstart[lo]), q);
                // a site of layer l-1's frame, which is this layer's input
                const int qq = f / Cin;
                int x = qq / Win;
                int y = qq - x * Win;
                const int c = f - qq * Cin;
                if (ly.kind == kConv) {
                  x += pad;
                  y += pad;
                }
                return keep_event<Wt, Acc>(ly, b, rank, wsh, x, y, c,
                                           Acc(1), e);
              },
              kept, red);
          walk<Wt, Acc>(ly, s, b, mem, wsh, kept, n_kept, wbuf);
        }
      }
      // clip, fire, reset (hot sites) and clamp, by each owner; spikes go
      // to the band's bit frame, or the last layer's frames
      if (ly.kind == kConv) {
        for (int u = tid; u < b.runs; u += kThreads) {
          int ln, y0, row, co;
          b.run(u, ln, y0);
          b.lane(ln, row, co);
          const bool inside = b.row_inside(row);
          // frame index and local frame index of (row, column halo), co
          const int f0 = ((row - ly.halo) * Wo - ly.halo) * ly.C + co;
          const int lf0 =
              ((ln / ly.C - s.k_int) * Wo - ly.halo) * ly.C + co;
          for (int y = y0; y < min(y0 + kSeg, ly.Wp); ++y) {
            Acc a = mem[y * b.lanes + ln];
            if (inside && b.col_inside(y)) {
              Acc spike = Acc(0);
              if (sne::conv::hot_bit(b, mask, ln, y))
                spike = sne::clip_fire_reset(a, ly.p);
              const int lf = lf0 + y * ly.C;
              if (!routed)
                s_t[f0 + y * ly.C] = spike;
              else if (spike != Acc(0))
                atomicOr(bits + (lf >> 5), 1u << (lf & 31));
            }
            if (kNative) a = sne::saturate_int8(a);
            mem[y * b.lanes + ln] = a;
          }
        }
      } else {
        for (int p = tid; p < s.sites; p += kThreads) {
          Acc a = mem[p];
          Acc spike = Acc(0);
          if (bit(mask, p)) spike = sne::clip_fire_reset(a, ly.p);
          if (!routed)
            s_t[frame_site(ly, s, rank, p)] = spike;
          else if (spike != Acc(0))
            atomicOr(bits + (p >> 5), 1u << (p & 31));
          if (kNative) a = sne::saturate_int8(a);
          mem[p] = a;
        }
      }
      if (!routed) break;
      // route: the share's spikes, in frame order, into this CTA's list,
      // with each segment's count
      __syncthreads();                      // the bit frame is complete
      const int buf = step & 1;
      const int lane = tid & 31;
      for (int j = tid >> 5; j < s.segs; j += kWarps) {
        const int a = j * s.seg_sites, e = a + s.seg_sites;   // [a, e)
        int c = 0;
        for (int w = (a >> 5) + lane; w <= (e - 1) >> 5; w += 32) {
          uint32_t m = bits[w];
          if (w == a >> 5) m &= ~0u << (a & 31);
          if (w == (e - 1) >> 5) m &= ~0u >> (31 - ((e - 1) & 31));
          c += __popc(m);
        }
        c = __reduce_add_sync(0xffffffffu, c);
        if (lane == 0) seg_count[buf * net.seg_cap + j] = c;
      }
      const int n_words = (s.frame_sites + 31) >> 5;
      const int per = (n_words + kThreads - 1) / kThreads;
      const int w0 = min(tid * per, n_words), w1 = min(w0 + per, n_words);
      int mine = 0;
      for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
      int total;
      int pos = block_exclusive_sum(mine, red, total);
      const int limit = min(net.list_cap, net.layer[l + 1].cap);
      int* list = lists + buf * net.list_cap;
      for (int w = w0; w < w1; ++w) {
        for (uint32_t x = bits[w]; x != 0u && pos < limit; x &= x - 1u)
          list[pos++] = frame_site(ly, s, rank, (w << 5) + __ffs(x) - 1);
        bits[w] = 0u;                       // ready for the next frame
      }
      ++step;
      cluster.sync();                       // every rank's list is out
    }
  }

  // settle cold tiles, write every owned membrane back
  for (int l = 0; l < L; ++l) {
    const Layer& ly = net.layer[l];
    const Share s = share_of(ly, rank);
    const Acc* mem = mem_of(ly);
    const uint32_t* mask = mask_of(ly);
    VS* vo = static_cast<VS*>(ly.v_out) + (size_t)n * ly.Hp * ly.Wp * ly.C;
    const bool settle = ly.p.reset_mode == 0;
    if (ly.kind == kConv) {
      const Band b = band_of(ly, s, rank);
      for (int u = tid; u < b.runs; u += kThreads) {
        int ln, y0, row, co;
        b.run(u, ln, y0);
        b.lane(ln, row, co);
        const bool inside = b.row_inside(row);
        for (int y = y0; y < min(y0 + kSeg, ly.Wp); ++y) {
          Acc a = mem[y * b.lanes + ln];
          if (settle && inside && b.col_inside(y) &&
              !sne::conv::hot_bit(b, mask, ln, y))
            a = sne::idle_decay(a, ly.p, n_alive);
          vo[((size_t)row * ly.Wp + y) * ly.C + co] = static_cast<VS>(a);
        }
      }
    } else {
      // a pool or fc slab is its frame
      for (int p = tid; p < s.sites; p += kThreads) {
        Acc a = mem[p];
        if (settle && !bit(mask, p)) a = sne::idle_decay(a, ly.p, n_alive);
        vo[frame_site(ly, s, rank, p)] = static_cast<VS>(a);
      }
    }
  }
  __syncthreads();                          // thread 0's tallies
  if (rank == 0 && tid < L) {
    net.counts[(size_t)n * L + tid] = tally[tid];
    net.drops[(size_t)n * L + tid] = tally[L + tid];
  }
  cluster.sync();                           // no list is read any more
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const Net& net, int N, int smem, cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  auto kern = network_window_kernel<VS, Wt, Acc, kNative>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<N * kCluster, kThreads, smem, stream>>>(net);
  return cudaGetLastError();
}

}  // namespace

// Host arrays, per layer: `desc` kDescInts ints (kind, Hp, Wp, C, halo, K,
// Ci, pad, stride, Win, Cin, cap, nTx, nTy, th, tw, mem_off, mask_off,
// w_off, Din, leak_mode, reset_mode, has_clip), `lif` 3 floats
// (threshold, leak, clip), `ptrs` 4 device pointers (v, w, v_out, tiles).
// Offsets are of one CTA's dynamic shared memory (`smem` bytes); a CTA
// owns at most `seg_cap` segments of a frame, and a frame has at most
// `nseg_cap` (at least kCluster).  Returns
// 0, a CUDA error code, or minus the card's opt-in shared memory per block
// when that is below `smem_budget`.
extern "C" int sne_network_window(
    const int32_t* desc, const float* lif, void* const* ptrs, int L,
    const void* ev, const void* gate, const void* alive, void* s_last,
    void* counts, void* drops, int N, int T, int E0, int list_cap,
    int seg_cap, int nseg_cap, int hot_off, int bits_off, int list_off,
    int kept_off, int tally_off, int fcbuf_off, int smem, int smem_budget,
    int pairing, void* stream) {
  // launches on the caller's current device, which owns `stream`
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (optin < smem_budget) return -optin;
  if (L < 1 || L > kMaxLayers || N <= 0 || T <= 0 || E0 <= 0 ||
      list_cap <= 0 || seg_cap <= 0 || nseg_cap < kCluster || smem <= 0 ||
      smem > smem_budget)
    return (int)cudaErrorInvalidValue;
  Net net{};
  for (int l = 0; l < L; ++l) {
    const int32_t* d = desc + l * kDescInts;
    Layer& ly = net.layer[l];
    ly = Layer{d[0],  d[1],  d[2],  d[3],  d[4],  d[5],  d[6],
               d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13],
               d[14], d[15], d[16], d[17], d[18], d[19],
               sne::LifArgs{lif[3 * l], lif[3 * l + 1], lif[3 * l + 2],
                            d[20], d[21], d[22]},
               ptrs[4 * l], ptrs[4 * l + 1], ptrs[4 * l + 2],
               static_cast<const int32_t*>(ptrs[4 * l + 3])};
    const int Ho = ly.Hp - 2 * ly.halo, Wo = ly.Wp - 2 * ly.halo;
    if (ly.kind < kConv || ly.kind > kFc || Ho <= 0 || Wo <= 0 ||
        ly.C <= 0 || ly.nTx <= 0 || ly.nTy <= 0 ||
        ly.nTx * ly.nTy > sne::kMaxTiles || ly.th <= 0 || ly.tw <= 0 ||
        ly.mem_off < 0 || ly.mem_off >= smem || ly.mask_off < 0 ||
        ly.mask_off >= smem || ly.Cin <= 0 || ly.Win <= 0 ||
        (l > 0 && ly.cap <= 0) ||
        (ly.kind == kConv && (ly.K <= 0 || ly.Hp < ly.K || ly.Wp < ly.K ||
                              ly.Ci <= 0 || ly.w_off < 0)) ||
        (ly.kind == kPool && (ly.stride <= 0 || ly.halo != 0 ||
                              ly.w_off < 0)) ||
        (ly.kind == kFc && (ly.Din <= 0 || ly.halo != 0 || Ho != 1 ||
                            Wo != 1)))
      return (int)cudaErrorInvalidValue;
  }
  net.L = L;
  net.T = T;
  net.E0 = E0;
  net.list_cap = list_cap;
  net.seg_cap = seg_cap;
  net.nseg_cap = nseg_cap;
  net.hot_off = hot_off;
  net.bits_off = bits_off;
  net.list_off = list_off;
  net.kept_off = kept_off;
  net.tally_off = tally_off;
  net.fcbuf_off = fcbuf_off;
  net.ev = static_cast<const int32_t*>(ev);
  net.gate = gate;
  net.alive = static_cast<const float*>(alive);
  net.s_last = s_last;
  net.counts = static_cast<int32_t*>(counts);
  net.drops = static_cast<int32_t*>(drops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_NETWORK_LAUNCH(VS, Wt, Acc) launch<VS, Wt, Acc>(net, N, smem, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_NETWORK_LAUNCH)
#undef SNE_NETWORK_LAUNCH
  return (int)err;
}
