// Slot-batched event fully-connected row-gather accumulate for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `event_fc_batched_pallas`
// (src/repro/kernels/event_fc/kernel.py:95, its pallas_call at :133, body
// `_event_fc_batched_kernel`).  For every slot n and every event e of that
// slot, in event order:
//
//     out[n, d] += W[(x * Win + y) * Cin + c, d] * gate[n, e]
//
// Gated-off events and rows outside [0, Din) add nothing; a row named
// twice is added twice.
//
// What bounds it on the card: the serial chain of adds per column (float
// addition is not associative, so a column takes its events one after
// another) and the latency of fetching the named weight rows.  The bytes
// (each gated event's row of Dout weights) are far below what those cost.
//
// Design: one timestep of the fc window kernel's staged column walk
// (fc_walk.cuh), with no LIF.  One block per (slot, column block of
// `cols` columns): `event_fc/ops.py::fc_column_block` picks cols (whole
// 128-byte row segments where Dout allows) so that the slots' blocks fill
// the card; a ragged last block takes what is left.  Each column's owning
// thread loads its membrane into a register, the block reads the gate
// row once, stops at the last gated event, keeps the gated in-range rows
// in list order, stages their block columns into shared memory (cp.async,
// double buffered, every load of a chunk in flight), each owner sums its
// column from there in list order, and writes it out once.  Gates are
// read at their own type (int8 in pairing 1) and cast to the accumulator.
#include "fc_walk.cuh"

namespace {

using sne::fc::kBufWords;
using sne::fc::kStage;
using sne::fc::kThreads;

template <typename VIn, typename Wt, typename G, typename Acc>
__global__ void __launch_bounds__(kThreads) event_fc_batched_kernel(
    const VIn* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const G* __restrict__ gate,
    Acc* __restrict__ out, int E, int Win, int Cin, int Din, int Dout,
    int cols) {
  __shared__ int2 kept[kStage];
  __shared__ __align__(16) int buf[2 * kBufWords];
  __shared__ int red[32];
  const sne::fc::Scratch sc{kept, buf, red};
  const int n = blockIdx.x;
  const int lo = blockIdx.y * cols;
  const auto cl = sne::fc::Cols<Wt>::make(w, Din, Dout, lo,
                                          min(cols, Dout - lo));
  const int d = lo + threadIdx.x;
  const bool live = threadIdx.x < cl.cols;
  Acc acc = live ? static_cast<Acc>(v[(size_t)n * Dout + d]) : Acc(0);
  sne::fc::walk(cl, ev + (size_t)n * E * 3, gate + (size_t)n * E, E, Win,
                Cin, sc, acc);
  if (live) out[(size_t)n * Dout + d] = acc;
}

template <typename VIn, typename Wt, typename G, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, void* out, int N, int Win, int Cin,
                   int Din, int Dout, int E, int cols, cudaStream_t stream) {
  dim3 grid(N, (Dout + cols - 1) / cols);
  event_fc_batched_kernel<VIn, Wt, G, Acc><<<grid, kThreads, 0, stream>>>(
      static_cast<const VIn*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const G*>(gate),
      static_cast<Acc*>(out), E, Win, Cin, Din, Dout, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_fc_batched(const void* v, const void* w,
                                    const void* ev, const void* gate,
                                    void* out, int N, int Win, int Cin,
                                    int Din, int Dout, int E, int cols,
                                    int pairing, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || E <= 0 || Dout <= 0 || Din <= 0 || cols <= 0 ||
      cols > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_FC_LAUNCH(VIn, Wt, G, Acc)                                      \
  launch<VIn, Wt, G, Acc>(v, w, ev, gate, out, N, Win, Cin, Din, Dout, E, \
                          cols, s)
  SNE_DISPATCH_PAIRING(pairing, SNE_FC_LAUNCH)
#undef SNE_FC_LAUNCH
  return (int)err;
}
