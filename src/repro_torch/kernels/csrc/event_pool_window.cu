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
// What bounds it on the card: as the per-step pool kernel, the serial
// order of each site's events and the latency of the dependent steps of
// each timestep, not bytes (the slab in and out, T gate rows, 12 bytes
// per walked event, T spike frames) nor operations.  The schedule is
// padded to a capacity far above its gated events (Fig. 6's pool1: 16384
// events per timestep, about 1236 gated per slot), and every block would
// otherwise look at every padded event of its slot, every timestep.
//
// Design: the per-step pool kernel's walk (`pool_walk.cuh`).  The sites
// of one slot are split over n_thr = blocks_per_slot * 256 threads (a
// power of two); thread r owns the sites s with s mod n_thr == r and is
// the only one that reads or writes them, through the whole window: leak,
// its matching events in order, clip/fire/reset, clamp, the cold-tile
// settle.  Its membranes live in its column of shared memory for the whole
// window, read from `v` once and written to `v_out` once; each timestep's
// walk ends at the slot's last gated event and applies only the events the
// block owns, filtered in list order.  So no float atomics and no
// synchronisation between blocks; the bitmap (<= 16 entries) is copied to
// shared memory.
#include "lif_common.cuh"
#include "pool_walk.cuh"

namespace {

using sne::pool::kThreads;

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __launch_bounds__(kThreads) event_pool_window_kernel(
    const VS* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const Acc* __restrict__ gate,
    const float* __restrict__ alive, const int32_t* __restrict__ tiles,
    VS* __restrict__ v_out, Acc* __restrict__ s_out, int Ho, int Wo, int C,
    int stride, int T, int E, int nTx, int nTy, int th, int tw,
    sne::LifArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int hot[sne::kMaxTiles];
  sne::pool::Scratch sc;
  Acc* mem = sne::pool::carve<Acc>(smem, sc);
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_thr = gridDim.y * kThreads;          // a power of two
  const int mine = blockIdx.y * kThreads + tid;    // owned residue
  const int S = Ho * Wo * C;
  const int J = sne::pool::owned_per_thread(S, n_thr);
  const size_t base_n = (size_t)n * S;
  const int n_tiles = nTx * nTy;
  const sne::pool::Geom geo{Ho, Wo, C, stride, __ffs(n_thr) - 1,
                            (int)gridDim.y};
  if (tid < n_tiles) hot[tid] = tiles ? tiles[(size_t)n * n_tiles + tid] : 1;
  for (int j = 0; j < J; ++j) {
    const int s = mine + j * n_thr;
    if (s < S) mem[j * kThreads + tid] = static_cast<Acc>(v[base_n + s]);
  }
  __syncthreads();                            // hot is filled

  // whether site s lies in a hot tile
  auto is_hot = [&](int s) {
    const int pix = s / C;
    return hot[sne::tile_of(pix / Wo, pix % Wo, th, tw, nTy)] != 0;
  };

  int n_alive = 0;
  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    Acc* s_t = s_out + nt * S;
    if (!(alive[nt] > 0.f)) {                 // uniform across the block
      for (int j = 0; j < J; ++j) {
        const int s = mine + j * n_thr;
        if (s < S) s_t[s] = Acc(0);
      }
      continue;
    }
    ++n_alive;
    for (int j = 0; j < J; ++j) {
      const int s = mine + j * n_thr;
      if (s < S && is_hot(s))
        mem[j * kThreads + tid] = sne::leak_step(mem[j * kThreads + tid], p);
    }
    sne::pool::walk(sc, ev + nt * E * 3, gate + nt * E, E, w, geo, mem);
    for (int j = 0; j < J; ++j) {
      const int s = mine + j * n_thr;
      if (s >= S) continue;
      Acc a = mem[j * kThreads + tid];
      Acc spike = Acc(0);
      if (is_hot(s)) spike = sne::clip_fire_reset(a, p);
      if (kNative) a = sne::saturate_int8(a);
      mem[j * kThreads + tid] = a;
      s_t[s] = spike;
    }
  }
  for (int j = 0; j < J; ++j) {
    const int s = mine + j * n_thr;
    if (s >= S) continue;
    Acc a = mem[j * kThreads + tid];
    if (p.reset_mode == 0 && !is_hot(s)) a = sne::idle_decay(a, p, n_alive);
    v_out[base_n + s] = static_cast<VS>(a);
  }
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, const void* alive, const void* tiles,
                   void* v_out, void* s_out, int N, int Ho, int Wo, int C,
                   int stride, int T, int E, int nTx, int nTy, int th, int tw,
                   int blocks_per_slot, sne::LifArgs p, cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  const size_t smem =
      sne::pool::smem_bytes(Ho * Wo * C, blocks_per_slot * kThreads);
  auto kern = event_pool_window_kernel<VS, Wt, Acc, kNative>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, blocks_per_slot);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const VS*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const Acc*>(gate),
      static_cast<const float*>(alive), static_cast<const int32_t*>(tiles),
      static_cast<VS*>(v_out), static_cast<Acc*>(s_out), Ho, Wo, C, stride,
      T, E, nTx, nTy, th, tw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_pool_window(
    const void* v, const void* w, const void* ev, const void* gate,
    const void* alive, const void* tiles, void* v_out, void* s_out, int N,
    int Ho, int Wo, int C, int stride, int T, int E, int nTx, int nTy,
    int th, int tw, int blocks_per_slot, int pairing,
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
  launch<VS, Wt, Acc>(v, w, ev, gate, alive, tiles, v_out, s_out, N, Ho, \
                      Wo, C, stride, T, E, nTx, nTy, th, tw,               \
                      blocks_per_slot, p, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_POOL_WINDOW_LAUNCH)
#undef SNE_POOL_WINDOW_LAUNCH
  return (int)err;
}
