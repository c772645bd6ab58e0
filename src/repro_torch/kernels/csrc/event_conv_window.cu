// Fused T-timestep window of an event convolution layer, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `event_conv_window_pallas`
// (src/repro/kernels/event_conv/kernel.py, body `_event_conv_window_kernel`).
// For every slot n and every timestep t of the window, in order, on the
// halo-padded (N, Hp, Wp, Co) membranes:
//
//     leak (interior sites of hot tiles)
//     -> v[x+i, y+j, :] += W_flipped[i, j, c, :] * gate  (events of t, in
//        event order, halo coordinates)
//     -> clip -> fire -> reset (interior sites of hot tiles)
//     -> (native) int8 clamp of the whole slab, halo included
//
// A timestep with alive[n, t] == 0 leaves the slab as it was and emits zero
// spikes.  After the window, every interior site of a cold tile is settled
// with one analytic idle decay over the slot's alive timesteps; a null
// bitmap means all tiles are hot.  Spikes (N, T, Ho, Wo, Co) are written in
// the accumulator dtype, every entry once (zeros for cold tiles and frozen
// timesteps).
//
// What bounds it on the card: the serial chain of events per site (two
// events' patches overlap and float addition is not associative), the
// block barriers between the stages of a timestep's walk, and how many SMs
// the launch keeps busy.  The bytes (slab in and out once, T spike frames,
// the gated events) are far below what those cost.
//
// Design: the ordered walk of conv_walk.cuh.  One block per (slot, band,
// channel block): `event_conv/ops.py::conv_plan` gives each slot
// enough bands of at most band_rows slab rows that the slots fill the
// card, and keeps all Co channels in a block unless shared memory forces
// a channel block.  A slot's rows are dealt to its bands in turn (band y
// owns rows y, y + bands, ...), so the rows where a frame's events gather
// spread over every band.  The band's sites stay in shared memory for the
// whole window (read from device memory once, written once).  Each
// timestep the block reads the gate row once, stops at the last gated
// event and keeps, in list order, only the events whose patch meets one
// of its rows; each (row, channel) lane of the band, in runs of kSeg
// sites a thread, walks that list and applies, in order, the adds of the
// events that cover its sites, with no barrier between events.  The
// sweeps (leak; clip, fire, reset, clamp; the cold-tile settle) run over
// each run's sites by the run's owner, so they need no barrier either.
// `alive` is one value per block and timestep, so a frozen timestep is
// skipped by the whole block.
#include "conv_walk.cuh"
#include "lif_common.cuh"

namespace {

using sne::conv::Band;
using sne::conv::block_threads;
using sne::conv::kMaxThreads;
using sne::conv::kPerLane;
using sne::conv::kSeg;

// The block's dynamic shared memory: the kept list (kPerLane events a
// thread, 16 bytes each), the band's sites, the weights, the hot bits, the
// warp partials and the bitmap.
template <typename Acc>
size_t smem_bytes(const Band& b, int threads) {
  return (size_t)16 * kPerLane * threads +
         sizeof(Acc) * ((size_t)b.Wp * b.lanes +
                        (size_t)b.K * b.K * b.Ci * b.C) +
         sizeof(uint32_t) * b.rows * b.words +
         sizeof(int) * (32 + sne::kMaxTiles);
}

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __launch_bounds__(kMaxThreads) event_conv_window_kernel(
    const VS* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const Acc* __restrict__ gate,
    const float* __restrict__ alive, const int32_t* __restrict__ tiles,
    VS* __restrict__ v_out, Acc* __restrict__ s_out, int Hp, int Wp, int Co,
    int K, int Ci, int halo, int T, int E, int co_blk, int band_rows,
    int nTx, int nTy, int th, int tw, sne::LifArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x;
  // the slab's rows are dealt to the slot's blocks in turn: block y
  // owns rows y, y + gridDim.y, ... (at most band_rows of them)
  const int r0 = blockIdx.y, step = gridDim.y;
  const int co0 = blockIdx.z * co_blk;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const Band b = Band::make(Hp, Wp, co_blk, K, Ci, halo, r0, step,
                            (Hp - 1 - r0) / step + 1);
  const Band widest = Band::make(Hp, Wp, co_blk, K, Ci, halo, 0, 1,
                                 band_rows);
  const int L = b.lanes;
  int4* kept = reinterpret_cast<int4*>(smem_raw);
  Acc* mem = reinterpret_cast<Acc*>(kept + kPerLane * nthr);
  Acc* wsh = mem + (size_t)Wp * widest.lanes;
  uint32_t* hot_bits = reinterpret_cast<uint32_t*>(wsh + K * K * Ci * co_blk);
  int* red = reinterpret_cast<int*>(hot_bits + band_rows * b.words);
  int* hot = red + 32;

  const int Ho = Hp - 2 * halo, Wo = Wp - 2 * halo;
  const size_t v_base = (size_t)n * Hp * Wp * Co;
  const int n_tiles = nTx * nTy;
  for (int i = tid; i < n_tiles; i += nthr)
    hot[i] = tiles ? tiles[(size_t)n * n_tiles + i] : 1;
  for (int i = tid; i < K * K * Ci * co_blk; i += nthr) {
    // wsh[((ki*K + kj)*Ci + c)*co_blk + co] = W[K-1-ki, K-1-kj, c, co0+co]
    const int r = i / co_blk, co = i - r * co_blk;
    const int c = r % Ci, kk = r / Ci;
    const int ki = kk / K, kj = kk - ki * K;
    const int src = ((K - 1 - ki) * K + (K - 1 - kj)) * Ci + c;
    wsh[i] = static_cast<Acc>(w[(size_t)src * Co + co0 + co]);
  }
  // the band's sites, from device memory once (coalesced over channels)
  auto gidx = [&](int l, int y) {
    const int q = l / co_blk;
    return v_base + ((size_t)(r0 + q * step) * Wp + y) * Co + co0 +
           (l - q * co_blk);
  };
  for (int i = tid; i < Wp * L; i += nthr) {
    const int y = i / L, l = i - y * L;
    mem[i] = static_cast<Acc>(v[gidx(l, y)]);
  }
  __syncthreads();                            // the bitmap is in
  sne::conv::band_hot_bits(b, hot, th, tw, nTy, hot_bits);
  __syncthreads();                            // the hot bits are in

  // the spike frame entry of interior site (lane l, column y)
  auto sidx = [&](int l, int y) {
    const int q = l / co_blk;
    return ((size_t)(r0 + q * step - halo) * Wo + (y - halo)) * Co + co0 +
           (l - q * co_blk);
  };
  int n_alive = 0;
  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    Acc* s_t = s_out + nt * Ho * Wo * Co;
    if (!(alive[nt] > 0.f)) {                 // uniform across the block
      for (int u = tid; u < b.runs; u += nthr) {
        int l, y0;
        b.run(u, l, y0);
        if (!b.row_inside(r0 + l / co_blk * step)) continue;
        for (int y = y0; y < min(y0 + kSeg, Wp); ++y)
          if (b.col_inside(y)) s_t[sidx(l, y)] = Acc(0);
      }
      continue;
    }
    ++n_alive;
    // leak: each run's owner its hot sites
    for (int u = tid; u < b.runs; u += nthr) {
      int l, y0;
      b.run(u, l, y0);
      for (int y = y0; y < min(y0 + kSeg, Wp); ++y)
        if (sne::conv::hot_bit(b, hot_bits, l, y))
          mem[y * L + l] = sne::leak_step(mem[y * L + l], p);
    }
    const int32_t* evt = ev + nt * E * 3;
    const Acc* gt = gate + nt * E;
    const int n_walk = sne::walk_end(gt, E, red);   // also: leak done
    for (int base = 0; base < n_walk; base += kPerLane * nthr) {
      if (base > 0) __syncthreads();         // the last stage is walked
      const int cnt = min(kPerLane * nthr, n_walk - base);
      const int n_kept = sne::compact<kPerLane>(
          cnt,
          [&](int i, int4& e) {
            const int32_t* x = evt + (size_t)(base + i) * 3;
            return sne::conv::conv_event(b, __ldg(x), __ldg(x + 1),
                                         __ldg(x + 2), gt[base + i], e);
          },
          kept, red);
      sne::conv::walk_runs(b, mem, wsh, kept, n_kept);
    }
    // clip, fire, reset (hot sites), spikes of the interior, clamp: each
    // run's owner, right after its walk
    for (int u = tid; u < b.runs; u += nthr) {
      int l, y0;
      b.run(u, l, y0);
      const bool inside = b.row_inside(r0 + l / co_blk * step);
      for (int y = y0; y < min(y0 + kSeg, Wp); ++y) {
        Acc a = mem[y * L + l];
        if (inside && b.col_inside(y)) {
          Acc spike = Acc(0);
          if (sne::conv::hot_bit(b, hot_bits, l, y))
            spike = sne::clip_fire_reset(a, p);
          s_t[sidx(l, y)] = spike;
        }
        if (kNative) a = sne::saturate_int8(a);
        mem[y * L + l] = a;
      }
    }
  }
  // settle cold interior sites, write every site back: each run's owner
  for (int u = tid; u < b.runs; u += nthr) {
    int l, y0;
    b.run(u, l, y0);
    const bool inside = b.row_inside(r0 + l / co_blk * step);
    for (int y = y0; y < min(y0 + kSeg, Wp); ++y) {
      Acc a = mem[y * L + l];
      if (p.reset_mode == 0 && inside && b.col_inside(y) &&
          !sne::conv::hot_bit(b, hot_bits, l, y))
        a = sne::idle_decay(a, p, n_alive);
      v_out[gidx(l, y)] = static_cast<VS>(a);
    }
  }
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, const void* alive, const void* tiles,
                   void* v_out, void* s_out, int N, int Hp, int Wp, int Co,
                   int K, int Ci, int halo, int T, int E, int co_blk,
                   int band_rows, int nTx, int nTy, int th, int tw,
                   sne::LifArgs p, cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  const Band b = Band::make(Hp, Wp, co_blk, K, Ci, halo, 0, 1, band_rows);
  const int threads = block_threads(b.runs);
  const size_t smem = smem_bytes<Acc>(b, threads);
  auto kern = event_conv_window_kernel<VS, Wt, Acc, kNative>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, (Hp + band_rows - 1) / band_rows, Co / co_blk);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const VS*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const Acc*>(gate),
      static_cast<const float*>(alive), static_cast<const int32_t*>(tiles),
      static_cast<VS*>(v_out), static_cast<Acc*>(s_out), Hp, Wp, Co, K, Ci,
      halo, T, E, co_blk, band_rows, nTx, nTy, th, tw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_conv_window(
    const void* v, const void* w, const void* ev, const void* gate,
    const void* alive, const void* tiles, void* v_out, void* s_out, int N,
    int Hp, int Wp, int Co, int K, int Ci, int halo, int T, int E,
    int co_blk, int band_rows, int nTx, int nTy, int th, int tw,
    int pairing, float threshold, float leak, float clip, int leak_mode,
    int reset_mode, int has_clip, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || T <= 0 || E <= 0 || co_blk <= 0 || Co % co_blk != 0 ||
      band_rows <= 0 || band_rows > Hp || Hp < K || Wp < K || K <= 0 ||
      Ci <= 0 || halo < 0 || Hp - 2 * halo <= 0 || Wp - 2 * halo <= 0 ||
      nTx <= 0 || nTy <= 0 || nTx * nTy > sne::kMaxTiles || th <= 0 ||
      tw <= 0)
    return (int)cudaErrorInvalidValue;
  const sne::LifArgs p{threshold, leak, clip, leak_mode, reset_mode,
                       has_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_CONV_WINDOW_LAUNCH(VS, Wt, Acc)                                  \
  launch<VS, Wt, Acc>(v, w, ev, gate, alive, tiles, v_out, s_out, N, Hp, Wp, \
                      Co, K, Ci, halo, T, E, co_blk, band_rows, nTx, nTy,    \
                      th, tw, p, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_CONV_WINDOW_LAUNCH)
#undef SNE_CONV_WINDOW_LAUNCH
  return (int)err;
}
