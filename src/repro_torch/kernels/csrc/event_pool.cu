// Slot-batched event sum-pool scatter-accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel `event_pool_batched_pallas`
// (src/repro/kernels/event_pool/kernel.py, body `_event_pool_batched_kernel`).
// For every slot n and every event e of that slot, in event order:
//
//     out[n, x/s, y/s, c] += w[c] * gate[n, e]
//
// with events whose pooled site falls past the (Ho, Wo, C) grid dropped
// (the VALID rule).  Only the event's own site is written: the Pallas body
// adds a zero to every other lane of the row, the reference does not.
//
// What bounds it on the card: the serial order of each site's events and
// the latency of the few dependent steps per launch, not bytes (the slab
// once each way, the gate row, 12 bytes per walked event) nor operations
// (one multiply and one add per gated event).  The event lists are padded
// to a capacity far above their gated events (at Fig. 6's pool1, 16384
// events with a few hundred gated), and every block would otherwise look
// at every padded event of its slot.
//
// Design (`pool_walk.cuh`): the sites of one slot are split over
// P * 256 threads, each site owned by one thread, its membrane held in
// that thread's column of shared memory for the whole launch, read from
// `v` once and written to `out` once.  A block reads the slot's gate row
// once to find where the walk ends, stages only the events up to there
// (cp.async, double-buffered), keeps in list order just the gated,
// in-grid events whose sites it owns, and each thread applies the kept
// entries of its own column in order.  Each site sees the float adds of
// the plain version in its order: the result is bitwise the same.
#include "pool_walk.cuh"

namespace {

using sne::pool::kThreads;

template <typename VIn, typename Wt, typename G, typename Acc>
__global__ void __launch_bounds__(kThreads) event_pool_batched_kernel(
    const VIn* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const G* __restrict__ gate,
    Acc* __restrict__ out, int Ho, int Wo, int C, int stride, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  sne::pool::Scratch sc;
  Acc* mem = sne::pool::carve<Acc>(smem, sc);
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_thr = gridDim.y * kThreads;           // a power of two
  const int mine = blockIdx.y * kThreads + tid;     // owned residue
  const int S = Ho * Wo * C;
  const int J = sne::pool::owned_per_thread(S, n_thr);
  const size_t base_n = (size_t)n * S;
  const sne::pool::Geom geo{Ho, Wo, C, stride, __ffs(n_thr) - 1,
                            (int)gridDim.y};

  for (int j = 0; j < J; ++j) {
    const int s = mine + j * n_thr;
    if (s < S) mem[j * kThreads + tid] = static_cast<Acc>(v[base_n + s]);
  }
  sne::pool::walk(sc, ev + (size_t)n * E * 3, gate + (size_t)n * E, E, w,
                  geo, mem);
  for (int j = 0; j < J; ++j) {
    const int s = mine + j * n_thr;
    if (s < S) out[base_n + s] = mem[j * kThreads + tid];
  }
}

template <typename VIn, typename Wt, typename G, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, void* out, int N, int Ho, int Wo, int C,
                   int stride, int E, int blocks_per_slot,
                   cudaStream_t stream) {
  const size_t smem =
      sne::pool::smem_bytes(Ho * Wo * C, blocks_per_slot * kThreads);
  auto kern = event_pool_batched_kernel<VIn, Wt, G, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, blocks_per_slot);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const VIn*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const G*>(gate),
      static_cast<Acc*>(out), Ho, Wo, C, stride, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_pool_batched(const void* v, const void* w,
                                      const void* ev, const void* gate,
                                      void* out, int N, int Ho, int Wo,
                                      int C, int stride, int E,
                                      int blocks_per_slot, int pairing,
                                      void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || E <= 0 || stride <= 0 || Ho <= 0 || Wo <= 0 || C <= 0 ||
      blocks_per_slot <= 0 || (blocks_per_slot & (blocks_per_slot - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_POOL_LAUNCH(VIn, Wt, G, Acc) \
  launch<VIn, Wt, G, Acc>(v, w, ev, gate, out, N, Ho, Wo, C, stride, E, blocks_per_slot, s)
  SNE_DISPATCH_PAIRING(pairing, SNE_POOL_LAUNCH)
#undef SNE_POOL_LAUNCH
  return (int)err;
}
