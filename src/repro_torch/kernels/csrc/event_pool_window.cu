// Fused T-timestep window of an event sum-pool layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `event_pool_window_pallas`
// (src/repro/kernels/event_pool/kernel.py, body `_event_pool_window_kernel`).
// For every slot n and every timestep t of the window, in order, on the
// (N, Ho, Wo, C) membranes:
//
//     leak (hot tiles) -> v[x/s, y/s, c] += w[c] * gate  (events of t, in
//     event order; past-the-grid events dropped) -> clip -> fire -> reset
//     (hot tiles) -> (native) int8 clamp of every site
//
// A timestep with alive[n, t] == 0 leaves the membranes as they were and
// emits zero spikes.  After the window, every site of a cold tile (bitmap
// entry 0: no event can reach it this window) is settled with one analytic
// idle decay over the slot's alive timesteps; a null bitmap means all tiles
// are hot.  Spikes (N, T, Ho, Wo, C) are written in the accumulator dtype,
// every entry once (zeros for cold tiles and frozen timesteps).
//
// What bounds it on the card: as the per-step pool kernel, the serial order
// of each slot's events: every owner looks at every event of its slot.
// The window adds T sweeps over the slab, a few bytes per site.
//
// Design: the per-step pool kernel's ownership of sites.  The sites of
// one slot are split over T_thr = blocks_per_slot * 256 threads (a power
// of two); thread r owns the sites s with s mod T_thr == r and is the only
// one that reads or writes them, through the whole window: leak, its
// matching events in order, clip/fire/reset, clamp, the cold-tile settle.
// So no float atomics and no synchronisation between blocks; a block
// synchronises only around its shared-memory event stage.  The running
// membrane lives in `acc` (device memory in the accumulator dtype, touched
// only by the owner, so it stays in the owner's L1 line); the bitmap
// (<= 16 entries) is copied to shared memory.
#include "lif_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __launch_bounds__(kThreads) event_pool_window_kernel(
    const VS* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const Acc* __restrict__ gate,
    const float* __restrict__ alive, const int32_t* __restrict__ tiles,
    Acc* acc, VS* v_out, Acc* __restrict__ s_out, int Ho, int Wo, int C,
    int stride, int T, int E, int nTx, int nTy, int th, int tw,
    sne::LifArgs p) {
  __shared__ int ev_site[sne::kChunk];
  __shared__ Acc ev_val[sne::kChunk];
  __shared__ int hot[sne::kMaxTiles];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_thr = gridDim.y * blockDim.x;        // a power of two
  const int mine = blockIdx.y * blockDim.x + tid;  // owned residue
  const int S = Ho * Wo * C;
  const size_t base_n = (size_t)n * S;
  const int n_tiles = nTx * nTy;
  if (tid < n_tiles) hot[tid] = tiles ? tiles[(size_t)n * n_tiles + tid] : 1;

  for (int s = mine; s < S; s += n_thr)
    acc[base_n + s] = static_cast<Acc>(v[base_n + s]);
  __syncthreads();

  int n_alive = 0;
  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    Acc* s_t = s_out + nt * S;
    if (!(alive[nt] > 0.f)) {                 // uniform across the block
      for (int s = mine; s < S; s += n_thr) s_t[s] = Acc(0);
      continue;
    }
    ++n_alive;
    for (int s = mine; s < S; s += n_thr) {
      const int pix = s / C;
      if (hot[sne::tile_of(pix / Wo, pix % Wo, th, tw, nTy)])
        acc[base_n + s] = sne::leak_step(acc[base_n + s], p);
    }
    const int32_t* evt = ev + nt * E * 3;
    const Acc* gt = gate + nt * E;
    for (int base = 0; base < E; base += sne::kChunk) {
      const int cnt = min(sne::kChunk, E - base);
      for (int i = tid; i < cnt; i += blockDim.x) {
        const int32_t* e = evt + (size_t)(base + i) * 3;
        const Acc g = gt[base + i];
        int site = -1;
        Acc val = Acc(0);
        if (g != Acc(0) && e[0] >= 0 && e[1] >= 0 && e[2] >= 0 && e[2] < C) {
          const int xo = e[0] / stride, yo = e[1] / stride;
          if (xo < Ho && yo < Wo) {
            site = (xo * Wo + yo) * C + e[2];
            val = sne::mul_rn(static_cast<Acc>(w[e[2]]), g);
          }
        }
        ev_site[i] = site;
        ev_val[i] = val;
      }
      __syncthreads();
      for (int i = 0; i < cnt; ++i) {
        const int site = ev_site[i];
        if (site >= 0 && (site & (n_thr - 1)) == mine)
          acc[base_n + site] = sne::add_rn(acc[base_n + site], ev_val[i]);
      }
      __syncthreads();
    }
    for (int s = mine; s < S; s += n_thr) {
      const int pix = s / C;
      Acc a = acc[base_n + s];
      Acc spike = Acc(0);
      if (hot[sne::tile_of(pix / Wo, pix % Wo, th, tw, nTy)])
        spike = sne::clip_fire_reset(a, p);
      if (kNative) a = sne::saturate_int8(a);
      acc[base_n + s] = a;
      s_t[s] = spike;
    }
  }
  for (int s = mine; s < S; s += n_thr) {
    const int pix = s / C;
    Acc a = acc[base_n + s];
    if (p.reset_mode == 0 &&
        !hot[sne::tile_of(pix / Wo, pix % Wo, th, tw, nTy)])
      a = sne::idle_decay(a, p, n_alive);
    v_out[base_n + s] = static_cast<VS>(a);
  }
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, const void* alive, const void* tiles,
                   void* acc, void* v_out, void* s_out, int N, int Ho, int Wo,
                   int C, int stride, int T, int E, int nTx, int nTy, int th,
                   int tw, int blocks_per_slot, sne::LifArgs p,
                   cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  dim3 grid(N, blocks_per_slot);
  event_pool_window_kernel<VS, Wt, Acc, kNative>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const VS*>(v), static_cast<const Wt*>(w),
          static_cast<const int32_t*>(ev), static_cast<const Acc*>(gate),
          static_cast<const float*>(alive),
          static_cast<const int32_t*>(tiles), static_cast<Acc*>(acc),
          static_cast<VS*>(v_out), static_cast<Acc*>(s_out), Ho, Wo, C,
          stride, T, E, nTx, nTy, th, tw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_pool_window(
    const void* v, const void* w, const void* ev, const void* gate,
    const void* alive, const void* tiles, void* acc, void* v_out,
    void* s_out, int N, int Ho, int Wo, int C, int stride, int T, int E,
    int nTx, int nTy, int th, int tw, int blocks_per_slot, int pairing,
    float threshold, float leak, float clip, int leak_mode, int reset_mode,
    int has_clip, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || T <= 0 || E <= 0 || stride <= 0 || Ho <= 0 || Wo <= 0 ||
      C <= 0 || nTx <= 0 || nTy <= 0 || nTx * nTy > sne::kMaxTiles ||
      th <= 0 || tw <= 0 || blocks_per_slot <= 0 ||
      (blocks_per_slot & (blocks_per_slot - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const sne::LifArgs p{threshold, leak, clip, leak_mode, reset_mode,
                       has_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_POOL_WINDOW_LAUNCH(VS, Wt, Acc)                                \
  launch<VS, Wt, Acc>(v, w, ev, gate, alive, tiles, acc, v_out, s_out, N, \
                      Ho, Wo, C, stride, T, E, nTx, nTy, th, tw,           \
                      blocks_per_slot, p, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_POOL_WINDOW_LAUNCH)
#undef SNE_POOL_WINDOW_LAUNCH
  return (int)err;
}
