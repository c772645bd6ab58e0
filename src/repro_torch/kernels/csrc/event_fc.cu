// Slot-batched event fully-connected row-gather accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel `event_fc_batched_pallas`
// (src/repro/kernels/event_fc/kernel.py, body `_event_fc_batched_kernel`).
// For every slot n and every event e of that slot, in event order:
//
//     out[n, d] += W[(x * Win + y) * Cin + c, d] * gate[n, e]
//
// What bounds it on the card: bytes.  Each gated event reads one weight
// row (Dout values) and does Dout adds, so a launch reads at least the
// distinct rows its events name, at one add per weight element read.
//
// Design: one block per (slot, block of 128 output columns); each thread
// owns one column and keeps its membrane in a register across the whole
// event list, so the adds of a column are in event order by construction.
// The threads of a warp read neighbouring elements of a row, so each row
// read is coalesced.  Events are staged kChunk at a time in shared memory
// as (row, gate) pairs; gated-off and out-of-range events are skipped.
#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename VIn, typename Wt, typename G, typename Acc>
__global__ void __launch_bounds__(kThreads) event_fc_batched_kernel(
    const VIn* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const G* __restrict__ gate,
    Acc* __restrict__ out, int Win, int Cin, int Din, int Dout, int E) {
  __shared__ int ev_row[sne::kChunk];
  __shared__ Acc ev_g[sne::kChunk];
  const int n = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = d < Dout;
  Acc acc = live ? static_cast<Acc>(v[(size_t)n * Dout + d]) : Acc(0);

  const int32_t* evn = ev + (size_t)n * E * 3;
  const G* gn = gate + (size_t)n * E;
  for (int base = 0; base < E; base += sne::kChunk) {
    const int cnt = min(sne::kChunk, E - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const int32_t* e = evn + (size_t)(base + i) * 3;
      const Acc g = static_cast<Acc>(gn[base + i]);
      const long long row = ((long long)e[0] * Win + e[1]) * Cin + e[2];
      ev_row[i] = (g != Acc(0) && row >= 0 && row < Din) ? (int)row : -1;
      ev_g[i] = g;
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < cnt; ++i) {
        const int row = ev_row[i];
        if (row < 0) continue;
        const Acc wv = static_cast<Acc>(w[(size_t)row * Dout + d]);
        acc = sne::add_rn(acc, sne::mul_rn(wv, ev_g[i]));
      }
    }
    __syncthreads();
  }
  if (live) out[(size_t)n * Dout + d] = acc;
}

template <typename VIn, typename Wt, typename G, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, void* out, int N, int Win, int Cin,
                   int Din, int Dout, int E, cudaStream_t stream) {
  dim3 grid(N, (Dout + kThreads - 1) / kThreads);
  event_fc_batched_kernel<VIn, Wt, G, Acc><<<grid, kThreads, 0, stream>>>(
      static_cast<const VIn*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const G*>(gate),
      static_cast<Acc*>(out), Win, Cin, Din, Dout, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_fc_batched(const void* v, const void* w,
                                    const void* ev, const void* gate,
                                    void* out, int N, int Win, int Cin,
                                    int Din, int Dout, int E, int pairing,
                                    void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || E <= 0 || Dout <= 0 || Din <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_FC_LAUNCH(VIn, Wt, G, Acc) \
  launch<VIn, Wt, G, Acc>(v, w, ev, gate, out, N, Win, Cin, Din, Dout, E, s)
  SNE_DISPATCH_PAIRING(pairing, SNE_FC_LAUNCH)
#undef SNE_FC_LAUNCH
  return (int)err;
}
