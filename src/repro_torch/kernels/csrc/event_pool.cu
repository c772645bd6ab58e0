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
// What bounds it on the card: the serial order of each slot's event list.
// One event is one add, so a launch moves little (the slab once each way,
// 16 bytes per event) and computes less; what costs time is that every
// owner must look at every event of its slot to keep per-site order.
//
// Design: the sites of one slot are split over T threads (P blocks of 256,
// T a power of two); thread t owns the sites s with s mod T == t and is the
// only one that reads or writes them, so the updates of a site happen in
// event order without atomics, in float or int.  Each block stages the
// events kChunk at a time in shared memory, already turned into (site,
// value) pairs, and every thread walks the staged list.
#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename VIn, typename Wt, typename G, typename Acc>
__global__ void __launch_bounds__(kThreads) event_pool_batched_kernel(
    const VIn* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const G* __restrict__ gate,
    Acc* __restrict__ out, int Ho, int Wo, int C, int stride, int E) {
  __shared__ int ev_site[sne::kChunk];
  __shared__ Acc ev_val[sne::kChunk];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = gridDim.y * blockDim.x;            // a power of two
  const int mine = blockIdx.y * blockDim.x + tid;  // owned residue mod T
  const int S = Ho * Wo * C;
  const size_t base_n = (size_t)n * S;

  for (int s = mine; s < S; s += T)
    out[base_n + s] = static_cast<Acc>(v[base_n + s]);

  const int32_t* evn = ev + (size_t)n * E * 3;
  const G* gn = gate + (size_t)n * E;
  for (int base = 0; base < E; base += sne::kChunk) {
    const int cnt = min(sne::kChunk, E - base);
    for (int i = tid; i < cnt; i += blockDim.x) {
      const int32_t* e = evn + (size_t)(base + i) * 3;
      const Acc g = static_cast<Acc>(gn[base + i]);
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
      if (site >= 0 && (site & (T - 1)) == mine)
        out[base_n + site] = sne::add_rn(out[base_n + site], ev_val[i]);
    }
    __syncthreads();
  }
}

template <typename VIn, typename Wt, typename G, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, void* out, int N, int Ho, int Wo, int C,
                   int stride, int E, int blocks_per_slot,
                   cudaStream_t stream) {
  dim3 grid(N, blocks_per_slot);
  event_pool_batched_kernel<VIn, Wt, G, Acc><<<grid, kThreads, 0, stream>>>(
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
  if (N <= 0 || E <= 0 || stride <= 0 || blocks_per_slot <= 0 ||
      (blocks_per_slot & (blocks_per_slot - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_POOL_LAUNCH(VIn, Wt, G, Acc) \
  launch<VIn, Wt, G, Acc>(v, w, ev, gate, out, N, Ho, Wo, C, stride, E, blocks_per_slot, s)
  SNE_DISPATCH_PAIRING(pairing, SNE_POOL_LAUNCH)
#undef SNE_POOL_LAUNCH
  return (int)err;
}
