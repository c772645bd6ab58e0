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
// What bounds it on the card: as the per-step conv kernel, the serial chain
// of events per block (two events' patches overlap and float addition is
// not associative), plus one synchronisation per sweep.  The bytes (slab in
// and out once, T spike frames, the events) are far below what the chain
// costs.
//
// Design: one block per (slot, output-channel block), K*K*co_blk threads.
// The block's slab slice stays in shared memory for the whole window, read
// from and written to device memory once, and so do its weights (flipped
// while they are staged).  Each thread owns one (i, j, co) patch offset for
// the event walk: per event every thread does one shared-memory
// read-modify-write and the block synchronises, which keeps every site's
// updates in event order without float atomics.  The sweeps (leak; clip,
// fire, reset and clamp) give each slab element to one thread by a fixed
// stride, the same in every sweep, so a sweep needs no barrier before the
// next one by the same owner.  `alive` is one value per block and timestep,
// so a frozen timestep is skipped by the whole block.
#include "lif_common.cuh"

namespace {

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void event_conv_window_kernel(
    const VS* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const Acc* __restrict__ gate,
    const float* __restrict__ alive, const int32_t* __restrict__ tiles,
    VS* __restrict__ v_out, Acc* __restrict__ s_out, int Hp, int Wp, int Co,
    int K, int Ci, int halo, int T, int E, int co_blk, int nTx, int nTy,
    int th, int tw, sne::LifArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slab_elems = Hp * Wp * co_blk;
  const int w_elems = K * K * Ci * co_blk;
  Acc* slab = reinterpret_cast<Acc*>(smem_raw);
  Acc* wsh = slab + slab_elems;
  Acc* ev_g = wsh + w_elems;
  int* ev_x = reinterpret_cast<int*>(ev_g + sne::kChunk);
  int* ev_y = ev_x + sne::kChunk;
  int* ev_c = ev_y + sne::kChunk;
  int* hot = ev_c + sne::kChunk;

  const int n = blockIdx.x;
  const int co0 = blockIdx.y * co_blk;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int Ho = Hp - 2 * halo, Wo = Wp - 2 * halo;
  const size_t v_base = (size_t)n * Hp * Wp * Co;
  const int n_tiles = nTx * nTy;

  if (tid < n_tiles) hot[tid] = tiles ? tiles[(size_t)n * n_tiles + tid] : 1;
  for (int i = tid; i < slab_elems; i += nthr) {
    const int q = i / co_blk, co = i - q * co_blk;
    slab[i] = static_cast<Acc>(v[v_base + (size_t)q * Co + co0 + co]);
  }
  for (int i = tid; i < w_elems; i += nthr) {
    // wsh[((ki*K + kj)*Ci + c)*co_blk + co] = W[K-1-ki, K-1-kj, c, co0+co]
    const int r = i / co_blk, co = i - r * co_blk;
    const int c = r % Ci, kk = r / Ci;
    const int ki = kk / K, kj = kk - ki * K;
    const int src = ((K - 1 - ki) * K + (K - 1 - kj)) * Ci + c;
    wsh[i] = static_cast<Acc>(w[(size_t)src * Co + co0 + co]);
  }
  const int ki = tid / (K * co_blk);
  const int kj = (tid / co_blk) % K;
  const int co = tid % co_blk;
  const bool owns = tid < K * K * co_blk;
  __syncthreads();

  // interior coordinates and tile of slab element i, or -1 for the halo
  auto interior_tile = [&](int i, int& xi, int& yi) {
    const int q = i / co_blk;
    xi = q / Wp - halo;
    yi = q % Wp - halo;
    if (xi < 0 || xi >= Ho || yi < 0 || yi >= Wo) return -1;
    return sne::tile_of(xi, yi, th, tw, nTy);
  };

  int n_alive = 0;
  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    Acc* s_t = s_out + nt * Ho * Wo * Co;
    if (!(alive[nt] > 0.f)) {                 // uniform across the block
      for (int i = tid; i < Ho * Wo * co_blk; i += nthr) {
        const int q = i / co_blk;
        s_t[(size_t)q * Co + co0 + (i - q * co_blk)] = Acc(0);
      }
      continue;
    }
    ++n_alive;
    for (int i = tid; i < slab_elems; i += nthr) {
      int xi, yi;
      const int tile = interior_tile(i, xi, yi);
      if (tile >= 0 && hot[tile]) slab[i] = sne::leak_step(slab[i], p);
    }
    const int32_t* evt = ev + nt * E * 3;
    const Acc* gt = gate + nt * E;
    for (int base = 0; base < E; base += sne::kChunk) {
      const int cnt = min(sne::kChunk, E - base);
      for (int i = tid; i < cnt; i += nthr) {
        const int32_t* e = evt + (size_t)(base + i) * 3;
        // clamp like the reference's dynamic_slice, so no address escapes
        ev_x[i] = min(max(e[0], 0), Hp - K);
        ev_y[i] = min(max(e[1], 0), Wp - K);
        ev_c[i] = min(max(e[2], 0), Ci - 1);
        ev_g[i] = gt[base + i];
      }
      __syncthreads();                        // leak and stage are done
      for (int i = 0; i < cnt; ++i) {
        const Acc g = ev_g[i];
        if (g == Acc(0)) continue;            // uniform across the block
        if (owns) {
          const int idx = ((ev_x[i] + ki) * Wp + (ev_y[i] + kj)) * co_blk + co;
          const Acc wv = wsh[((ki * K + kj) * Ci + ev_c[i]) * co_blk + co];
          slab[idx] = sne::add_rn(slab[idx], sne::mul_rn(wv, g));
        }
        __syncthreads();
      }
      __syncthreads();                        // the stage may be refilled
    }
    for (int i = tid; i < slab_elems; i += nthr) {
      int xi, yi;
      const int tile = interior_tile(i, xi, yi);
      Acc a = slab[i];
      if (tile >= 0) {
        Acc spike = Acc(0);
        if (hot[tile]) spike = sne::clip_fire_reset(a, p);
        s_t[((size_t)xi * Wo + yi) * Co + co0 + (i % co_blk)] = spike;
      }
      if (kNative) a = sne::saturate_int8(a);
      slab[i] = a;
    }
  }
  for (int i = tid; i < slab_elems; i += nthr) {
    int xi, yi;
    const int tile = interior_tile(i, xi, yi);
    Acc a = slab[i];
    if (tile >= 0 && p.reset_mode == 0 && !hot[tile])
      a = sne::idle_decay(a, p, n_alive);
    const int q = i / co_blk;
    v_out[v_base + (size_t)q * Co + co0 + (i - q * co_blk)] =
        static_cast<VS>(a);
  }
}

template <typename Acc>
size_t smem_bytes(int Hp, int Wp, int K, int Ci, int co_blk) {
  return sizeof(Acc) * ((size_t)Hp * Wp * co_blk +
                        (size_t)K * K * Ci * co_blk + sne::kChunk) +
         sizeof(int) * (3 * sne::kChunk + sne::kMaxTiles);
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, const void* alive, const void* tiles,
                   void* v_out, void* s_out, int N, int Hp, int Wp, int Co,
                   int K, int Ci, int halo, int T, int E, int co_blk, int nTx,
                   int nTy, int th, int tw, sne::LifArgs p,
                   cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  const size_t smem = smem_bytes<Acc>(Hp, Wp, K, Ci, co_blk);
  auto kern = event_conv_window_kernel<VS, Wt, Acc, kNative>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, Co / co_blk);
  kern<<<grid, K * K * co_blk, smem, stream>>>(
      static_cast<const VS*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const Acc*>(gate),
      static_cast<const float*>(alive), static_cast<const int32_t*>(tiles),
      static_cast<VS*>(v_out), static_cast<Acc*>(s_out), Hp, Wp, Co, K, Ci,
      halo, T, E, co_blk, nTx, nTy, th, tw, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_conv_window(
    const void* v, const void* w, const void* ev, const void* gate,
    const void* alive, const void* tiles, void* v_out, void* s_out, int N,
    int Hp, int Wp, int Co, int K, int Ci, int halo, int T, int E,
    int co_blk, int nTx, int nTy, int th, int tw, int pairing,
    float threshold, float leak, float clip, int leak_mode, int reset_mode,
    int has_clip, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || T <= 0 || E <= 0 || co_blk <= 0 || Co % co_blk != 0 ||
      K * K * co_blk > 1024 || Hp < K || Wp < K || halo < 0 ||
      Hp - 2 * halo <= 0 || Wp - 2 * halo <= 0 || nTx <= 0 || nTy <= 0 ||
      nTx * nTy > sne::kMaxTiles || nTx * nTy > K * K * co_blk || th <= 0 ||
      tw <= 0)
    return (int)cudaErrorInvalidValue;
  const sne::LifArgs p{threshold, leak, clip, leak_mode, reset_mode,
                       has_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_CONV_WINDOW_LAUNCH(VS, Wt, Acc)                                  \
  launch<VS, Wt, Acc>(v, w, ev, gate, alive, tiles, v_out, s_out, N, Hp, Wp, \
                      Co, K, Ci, halo, T, E, co_blk, nTx, nTy, th, tw, p, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_CONV_WINDOW_LAUNCH)
#undef SNE_CONV_WINDOW_LAUNCH
  return (int)err;
}
