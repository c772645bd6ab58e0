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
// What bounds it on the card: the serial chains of events.  A conv event's
// patch may overlap the next one's, float addition is not associative,
// and bitwise equality with the plain version needs every site's adds in
// event order, so the conv walk synchronises the block once per event;
// pool and fc walks see every event of their layer in order.  The bytes
// (each slab in and out once, the schedule, the fc rows named, the last
// layer's frames) are far below what the chains cost, and one block per
// slot leaves most SMs idle at serving batch sizes.
//
// Design: one block of 512 threads per slot (channel blocking cannot cross
// a layer boundary: layer l+1 may read any channel of layer l).  Shared
// memory holds every layer's accumulator slab, the conv weights (flipped
// while staged) and pool weights, the tile bitmaps, one routed frame as one
// bit per site, a stage of kChunk events and the scan scratch; the layout
// is computed by the wrapper (`network_window/ops.py::smem_layout`), which
// is also what the executor's fallback rule prices.  The fc matrices and a
// per-slot ring of routed events (one int32 site per event, reused by
// every boundary) stay in device memory.  Per layer kind, the walks are
// the window kernels': conv gives each thread (ki, kj, co) patch offsets
// and synchronises per event; pool gives each site one owning thread; fc
// gives each output column one thread.  The sweeps run over interior sites
// in frame order, so a warp's 32 spikes form one word of the routed frame
// (`__ballot_sync`, no atomics); routing is an ordered compaction: each
// thread counts the spikes of a contiguous run of words, a block-wide
// exclusive prefix sum gives its first ring slot, and it writes its sites
// in order while the slot is below cap'.  The next layer walks only the
// min(n, cap') routed events: the padding past them is gated off in the
// reference and adds nothing.
#include "lif_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 12;       // network_window/ops.py MAX_LAYERS
constexpr int kDescInts = 22;        // ints per layer in the descriptor
enum { kConv = 0, kPool = 1, kFc = 2 };

struct Layer {
  int kind, Hp, Wp, C, halo, K, Ci, pad, stride, Win, Cin, cap, nTx, nTy,
      th, tw, slab_off, w_off, Din;
  sne::LifArgs p;
  const void* v;         // (N, Hp, Wp, C) membranes in, storage dtype
  const void* w;         // weights (conv unflipped, pool (C,), fc (Din, C))
  void* v_out;           // (N, Hp, Wp, C) membranes out
  const int32_t* tiles;  // (N, nTx, nTy) bitmap, or null: every tile hot
};

struct Net {
  Layer layer[kMaxLayers];
  int L, T, E0, ring_cap, hot_off, bits_off, stage_off, tally_off;
  const int32_t* ev;     // (N, T, E0, 3) layer-0 events
  const void* gate;      // (N, T, E0) layer-0 gates, accumulator dtype
  const float* alive;    // (N, T)
  void* s_last;          // (N, T, Ho, Wo, C) last layer's spikes
  int32_t* counts;       // (N, L)
  int32_t* drops;        // (N, L)
  int32_t* ring;         // (N, ring_cap) routed events, written in-kernel
};

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

// slab index of interior frame site f = (x * Wo + y) * C + c
__device__ __forceinline__ int slab_index(const Layer& ly, int f, int Wo,
                                          int& x, int& y) {
  const int q = f / ly.C;
  x = q / Wo;
  y = q - x * Wo;
  return ((x + ly.halo) * ly.Wp + y + ly.halo) * ly.C + (f - q * ly.C);
}

template <typename Wt, typename Acc>
__device__ __forceinline__ void stage_event(const Layer& ly,
                                            const Wt* wsh, int i, int x,
                                            int y, int c, Acc g, int* st_x,
                                            int* st_y, int* st_c,
                                            Acc* st_g) {
  if (ly.kind == kConv) {
    // clamp like the reference's dynamic_slice, so no address escapes
    st_x[i] = min(max(x, 0), ly.Hp - ly.K);
    st_y[i] = min(max(y, 0), ly.Wp - ly.K);
    st_c[i] = min(max(c, 0), ly.Ci - 1);
    st_g[i] = g;
  } else if (ly.kind == kPool) {
    // one site per event; past the pooled grid it is dropped (VALID)
    int site = -1;
    Acc val = Acc(0);
    if (g != Acc(0) && x >= 0 && y >= 0 && c >= 0 && c < ly.C) {
      const int xo = x / ly.stride, yo = y / ly.stride;
      if (xo < ly.Hp && yo < ly.Wp) {
        site = (xo * ly.Wp + yo) * ly.C + c;
        val = sne::mul_rn(static_cast<Acc>(wsh[c]), g);
      }
    }
    st_x[i] = site;
    st_g[i] = val;
  } else {
    const long long row = ((long long)x * ly.Win + y) * ly.Cin + c;
    st_x[i] = (g != Acc(0) && row >= 0 && row < ly.Din) ? (int)row : -1;
    st_g[i] = g;
  }
}

// one staged chunk of `cnt` events into the layer's slab, in event order
template <typename Wt, typename Acc>
__device__ __forceinline__ void walk_events(const Layer& ly, Acc* slab,
                                            const Wt* wsh, int cnt,
                                            const int* st_x, const int* st_y,
                                            const int* st_c,
                                            const Acc* st_g) {
  const int tid = threadIdx.x;
  if (ly.kind == kConv) {
    const int K = ly.K, Co = ly.C, KKC = K * K * Co;
    for (int i = 0; i < cnt; ++i) {
      const Acc g = st_g[i];
      if (g == Acc(0)) continue;            // uniform across the block
      const int x0 = st_x[i], y0 = st_y[i], c = st_c[i];
      for (int o = tid; o < KKC; o += kThreads) {
        const int co = o % Co, kk = o / Co;
        const int ki = kk / K, kj = kk - ki * K;
        const int idx = ((x0 + ki) * ly.Wp + y0 + kj) * Co + co;
        const Acc wv =
            static_cast<Acc>(wsh[((ki * K + kj) * ly.Ci + c) * Co + co]);
        slab[idx] = sne::add_rn(slab[idx], sne::mul_rn(wv, g));
      }
      __syncthreads();                      // the next patch may overlap
    }
  } else if (ly.kind == kPool) {
    for (int i = 0; i < cnt; ++i) {
      const int site = st_x[i];
      if (site >= 0 && (site & (kThreads - 1)) == tid)
        slab[site] = sne::add_rn(slab[site], st_g[i]);
    }
  } else {
    const Wt* w = static_cast<const Wt*>(ly.w);
    for (int d = tid; d < ly.C; d += kThreads) {
      Acc a = slab[d];
      for (int i = 0; i < cnt; ++i) {
        const int row = st_x[i];
        if (row < 0) continue;
        a = sne::add_rn(a, sne::mul_rn(
                               static_cast<Acc>(w[(size_t)row * ly.C + d]),
                               st_g[i]));
      }
      slab[d] = a;
    }
  }
}

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __launch_bounds__(kThreads)
    network_window_kernel(const Net net) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int L = net.L, T = net.T, E0 = net.E0;
  int* hot = reinterpret_cast<int*>(smem + net.hot_off);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + net.bits_off);
  int* st_x = reinterpret_cast<int*>(smem + net.stage_off);
  int* st_y = st_x + sne::kChunk;
  int* st_c = st_y + sne::kChunk;
  Acc* st_g = reinterpret_cast<Acc*>(st_c + sne::kChunk);
  int* warp_sums = reinterpret_cast<int*>(smem + net.tally_off);
  int* tally = warp_sums + 32;              // counts[L], then drops[L]
  int32_t* ring = net.ring + (size_t)n * net.ring_cap;

  // stage every layer's membranes, weights and bitmap
  for (int l = 0; l < L; ++l) {
    const Layer& ly = net.layer[l];
    Acc* slab = reinterpret_cast<Acc*>(smem + ly.slab_off);
    const int elems = ly.Hp * ly.Wp * ly.C;
    const VS* v = static_cast<const VS*>(ly.v) + (size_t)n * elems;
    for (int i = tid; i < elems; i += kThreads)
      slab[i] = static_cast<Acc>(v[i]);
    const Wt* w = static_cast<const Wt*>(ly.w);
    if (ly.kind == kConv) {
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
      Wt* wsh = reinterpret_cast<Wt*>(smem + ly.w_off);
      for (int i = tid; i < ly.C; i += kThreads) wsh[i] = w[i];
    }
    const int n_tiles = ly.nTx * ly.nTy;
    if (tid < n_tiles)
      hot[l * sne::kMaxTiles + tid] =
          ly.tiles ? ly.tiles[(size_t)n * n_tiles + tid] : 1;
  }
  if (tid < 2 * L) tally[tid] = 0;
  {
    // layer 0 consumes every gate of the window, frozen timesteps too
    const Acc* gate = static_cast<const Acc*>(net.gate) + (size_t)n * T * E0;
    int g = 0;
    for (int i = tid; i < T * E0; i += kThreads)
      g += static_cast<int>(gate[i]);
    int total;
    block_exclusive_sum(g, warp_sums, total);   // also: staging is done
    if (tid == 0) tally[0] = total;
  }

  const Layer& last = net.layer[L - 1];
  const int S_last =
      (last.Hp - 2 * last.halo) * (last.Wp - 2 * last.halo) * last.C;
  int n_alive = 0;
  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    Acc* s_t = static_cast<Acc*>(net.s_last) + nt * S_last;
    if (!(net.alive[nt] > 0.f)) {           // uniform: the network holds
      for (int i = tid; i < S_last; i += kThreads) s_t[i] = Acc(0);
      continue;
    }
    ++n_alive;
    int n_ev = E0;                          // events into layer l
    for (int l = 0; l < L; ++l) {
      const Layer& ly = net.layer[l];
      Acc* slab = reinterpret_cast<Acc*>(smem + ly.slab_off);
      const Wt* wsh = ly.w_off < 0
                          ? nullptr
                          : reinterpret_cast<const Wt*>(smem + ly.w_off);
      const int* hot_l = hot + l * sne::kMaxTiles;
      const int Ho = ly.Hp - 2 * ly.halo, Wo = ly.Wp - 2 * ly.halo;
      const int S = Ho * Wo * ly.C;
      // leak: interior sites of hot tiles, each by the thread that fires it
      for (int f = tid; f < S; f += kThreads) {
        int x, y;
        const int i = slab_index(ly, f, Wo, x, y);
        if (hot_l[sne::tile_of(x, y, ly.th, ly.tw, ly.nTy)])
          slab[i] = sne::leak_step(slab[i], ly.p);
      }
      // scatter, kChunk events at a time
      for (int base = 0; base < n_ev; base += sne::kChunk) {
        const int cnt = min(sne::kChunk, n_ev - base);
        for (int i = tid; i < cnt; i += kThreads) {
          int x, y, c;
          Acc g;
          if (l == 0) {
            const int32_t* e = net.ev + (nt * E0 + base + i) * 3;
            x = e[0];
            y = e[1];
            c = e[2];
            g = static_cast<const Acc*>(net.gate)[nt * E0 + base + i];
          } else {
            // a site of layer l-1's frame, which is this layer's input
            const int f = ring[base + i];
            const int q = f / ly.Cin;
            x = q / ly.Win;
            y = q - x * ly.Win;
            c = f - q * ly.Cin;
            if (ly.kind == kConv) {
              x += ly.pad;
              y += ly.pad;
            }
            g = Acc(1);
          }
          stage_event<Wt, Acc>(ly, wsh, i, x, y, c, g, st_x, st_y, st_c,
                               st_g);
        }
        __syncthreads();                    // leak and stage are done
        walk_events<Wt, Acc>(ly, slab, wsh, cnt, st_x, st_y, st_c, st_g);
        __syncthreads();                    // the stage may be refilled
      }
      // clip, fire, reset (hot tiles) and clamp, in frame order: a warp's
      // 32 spikes are one word of the routed frame
      const bool routed = l < L - 1;
      for (int base = 0; base < S; base += kThreads) {
        const int f = base + tid;
        Acc spike = Acc(0);
        if (f < S) {
          int x, y;
          const int i = slab_index(ly, f, Wo, x, y);
          Acc a = slab[i];
          if (hot_l[sne::tile_of(x, y, ly.th, ly.tw, ly.nTy)])
            spike = sne::clip_fire_reset(a, ly.p);
          if (kNative) a = sne::saturate_int8(a);
          slab[i] = a;
          if (!routed) s_t[f] = spike;
        }
        if (routed) {
          const unsigned word = __ballot_sync(0xffffffffu, spike != Acc(0));
          if ((tid & 31) == 0 && f < S) bits[f >> 5] = word;
        }
      }
      if (kNative && ly.halo > 0) {         // the halo takes the clamp too
        const int elems = ly.Hp * ly.Wp * ly.C;
        for (int i = tid; i < elems; i += kThreads) {
          const int q = i / ly.C;
          const int xi = q / ly.Wp - ly.halo, yi = q % ly.Wp - ly.halo;
          if (xi < 0 || xi >= Ho || yi < 0 || yi >= Wo)
            slab[i] = sne::saturate_int8(slab[i]);
        }
      }
      if (!routed) break;
      // route: the first cap' spiking sites, in order, into the ring
      __syncthreads();                      // the frame's words are done
      const int n_words = (S + 31) >> 5;
      const int per = (n_words + kThreads - 1) / kThreads;
      const int w0 = min(tid * per, n_words), w1 = min(w0 + per, n_words);
      int mine = 0;
      for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
      int total;
      int pos = block_exclusive_sum(mine, warp_sums, total);
      const int cap = net.layer[l + 1].cap;
      for (int w = w0; w < w1 && pos < cap; ++w) {
        for (uint32_t b = bits[w]; b != 0u && pos < cap; b &= b - 1u)
          ring[pos++] = (w << 5) + __ffs(b) - 1;
      }
      n_ev = min(total, cap);
      if (tid == 0) {
        tally[l + 1] += n_ev;
        tally[L + l + 1] += max(total - cap, 0);
      }
      __syncthreads();                      // the ring is complete
    }
  }

  // settle cold tiles, write every membrane back
  __syncthreads();                          // the last sweeps are done
  for (int l = 0; l < L; ++l) {
    const Layer& ly = net.layer[l];
    const Acc* slab = reinterpret_cast<const Acc*>(smem + ly.slab_off);
    const int* hot_l = hot + l * sne::kMaxTiles;
    const int Ho = ly.Hp - 2 * ly.halo, Wo = ly.Wp - 2 * ly.halo;
    const int elems = ly.Hp * ly.Wp * ly.C;
    VS* vo = static_cast<VS*>(ly.v_out) + (size_t)n * elems;
    for (int i = tid; i < elems; i += kThreads) {
      Acc a = slab[i];
      const int q = i / ly.C;
      const int xi = q / ly.Wp - ly.halo, yi = q % ly.Wp - ly.halo;
      if (ly.p.reset_mode == 0 && xi >= 0 && xi < Ho && yi >= 0 &&
          yi < Wo && !hot_l[sne::tile_of(xi, yi, ly.th, ly.tw, ly.nTy)])
        a = sne::idle_decay(a, ly.p, n_alive);
      vo[i] = static_cast<VS>(a);
    }
  }
  __syncthreads();                          // thread 0's tallies
  if (tid < L) {
    net.counts[(size_t)n * L + tid] = tally[tid];
    net.drops[(size_t)n * L + tid] = tally[L + tid];
  }
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const Net& net, int N, int smem, cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  auto kern = network_window_kernel<VS, Wt, Acc, kNative>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<N, kThreads, smem, stream>>>(net);
  return cudaGetLastError();
}

}  // namespace

// Host arrays, per layer: `desc` kDescInts ints (kind, Hp, Wp, C, halo, K,
// Ci, pad, stride, Win, Cin, cap, nTx, nTy, th, tw, slab_off, w_off, Din,
// leak_mode, reset_mode, has_clip), `lif` 3 floats (threshold, leak,
// clip), `ptrs` 4 device pointers (v, w, v_out, tiles).  Returns 0, a CUDA
// error code, or minus the card's opt-in shared memory per block when that
// is below `smem_budget`.
extern "C" int sne_network_window(
    const int32_t* desc, const float* lif, void* const* ptrs, int L,
    const void* ev, const void* gate, const void* alive, void* s_last,
    void* counts, void* drops, void* ring, int N, int T, int E0,
    int ring_cap, int hot_off, int bits_off, int stage_off, int tally_off,
    int smem, int smem_budget, int pairing, void* stream) {
  // launches on the caller's current device, which owns `stream`
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (optin < smem_budget) return -optin;
  if (L < 1 || L > kMaxLayers || N <= 0 || T <= 0 || E0 <= 0 ||
      ring_cap <= 0 || smem <= 0 || smem > smem_budget)
    return (int)cudaErrorInvalidValue;
  Net net{};
  for (int l = 0; l < L; ++l) {
    const int32_t* d = desc + l * kDescInts;
    Layer& ly = net.layer[l];
    ly = Layer{d[0],  d[1],  d[2],  d[3],  d[4],  d[5],  d[6],
               d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13],
               d[14], d[15], d[16], d[17], d[18],
               sne::LifArgs{lif[3 * l], lif[3 * l + 1], lif[3 * l + 2],
                            d[19], d[20], d[21]},
               ptrs[4 * l], ptrs[4 * l + 1], ptrs[4 * l + 2],
               static_cast<const int32_t*>(ptrs[4 * l + 3])};
    const int Ho = ly.Hp - 2 * ly.halo, Wo = ly.Wp - 2 * ly.halo;
    if (ly.kind < kConv || ly.kind > kFc || Ho <= 0 || Wo <= 0 ||
        ly.C <= 0 || ly.nTx <= 0 || ly.nTy <= 0 ||
        ly.nTx * ly.nTy > sne::kMaxTiles || ly.th <= 0 || ly.tw <= 0 ||
        ly.slab_off < 0 || ly.slab_off >= smem || ly.Cin <= 0 ||
        ly.Win <= 0 || (l > 0 && (ly.cap <= 0 || ly.cap > ring_cap)) ||
        (ly.kind == kConv && (ly.K <= 0 || ly.Hp < ly.K || ly.Wp < ly.K ||
                              ly.Ci <= 0 || ly.w_off < 0)) ||
        (ly.kind == kPool && (ly.stride <= 0 || ly.halo != 0 ||
                              ly.w_off < 0)) ||
        (ly.kind == kFc && (ly.Din <= 0 || ly.halo != 0)))
      return (int)cudaErrorInvalidValue;
  }
  net.L = L;
  net.T = T;
  net.E0 = E0;
  net.ring_cap = ring_cap;
  net.hot_off = hot_off;
  net.bits_off = bits_off;
  net.stage_off = stage_off;
  net.tally_off = tally_off;
  net.ev = static_cast<const int32_t*>(ev);
  net.gate = gate;
  net.alive = static_cast<const float*>(alive);
  net.s_last = s_last;
  net.counts = static_cast<int32_t*>(counts);
  net.drops = static_cast<int32_t*>(drops);
  net.ring = static_cast<int32_t*>(ring);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_NETWORK_LAUNCH(VS, Wt, Acc) launch<VS, Wt, Acc>(net, N, smem, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_NETWORK_LAUNCH)
#undef SNE_NETWORK_LAUNCH
  return (int)err;
}
