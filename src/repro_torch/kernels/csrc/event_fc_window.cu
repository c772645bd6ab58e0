// Fused T-timestep window of an event fully-connected layer, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `event_fc_window_pallas`
// (src/repro/kernels/event_fc/kernel.py, body `_event_fc_window_kernel`).
// For every slot n and every timestep t of the window, in order, on the
// (N, 1, 1, Dout) membranes:
//
//     leak -> v[d] += W[(x * Win + y) * Cin + c, d] * gate  (events of t,
//             in event order) -> clip -> fire -> reset -> (native) int8
//             clamp
//
// A timestep with alive[n, t] == 0 leaves the membrane as it was (no
// leak, no events) and emits a zero spike row.  The membrane is read once
// and written once per window; spikes (N, T, 1, 1, Dout) are written in
// the accumulator dtype, every entry once (zeros included), so the output
// needs no clearing.
//
// What bounds it on the card: the serial chain of adds per column (float
// addition is not associative, so a column takes its events one after
// another) and the latency of fetching the named weight rows.  The bytes
// (each gated event's row of Dout weights, read from the L2 cache after
// the first) are far below what those cost.
//
// Design: the staged column walk of fc_walk.cuh.  One block per (slot,
// column block of `cols` columns): `event_fc/ops.py::fc_column_block`
// picks cols (whole 128-byte row segments where Dout allows) so that the
// slots' blocks fill the card; a ragged last block takes what is left.
// Each column's owning thread keeps its membrane in a register for the
// whole window.  Each live timestep the block reads the gate row once,
// stops at the last gated event, keeps the gated in-range rows in list
// order, stages their block columns into shared memory (cp.async, double
// buffered, every load of a chunk in flight) and each owner sums its
// column from there in list order.  `alive` is one value per block and
// timestep, so a frozen timestep is skipped by the whole block.
#include "fc_walk.cuh"
#include "lif_common.cuh"

namespace {

using sne::fc::kBufWords;
using sne::fc::kStage;
using sne::fc::kThreads;

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __launch_bounds__(kThreads) event_fc_window_kernel(
    const VS* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const Acc* __restrict__ gate,
    const float* __restrict__ alive, VS* __restrict__ v_out,
    Acc* __restrict__ s_out, int T, int E, int Win, int Cin, int Din,
    int Dout, int cols, sne::LifArgs p) {
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

  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    if (!(alive[nt] > 0.f)) {                 // uniform across the block
      if (live) s_out[nt * Dout + d] = Acc(0);
      continue;
    }
    acc = sne::leak_step(acc, p);
    sne::fc::walk(cl, ev + nt * E * 3, gate + nt * E, E, Win, Cin, sc, acc);
    const Acc s = sne::clip_fire_reset(acc, p);
    if (kNative) acc = sne::saturate_int8(acc);
    if (live) s_out[nt * Dout + d] = s;
  }
  if (live) v_out[(size_t)n * Dout + d] = static_cast<VS>(acc);
}

template <typename VS, typename Wt, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, const void* alive, void* v_out,
                   void* s_out, int N, int T, int E, int Win, int Cin,
                   int Din, int Dout, int cols, sne::LifArgs p,
                   cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  dim3 grid(N, (Dout + cols - 1) / cols);
  event_fc_window_kernel<VS, Wt, Acc, kNative>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const VS*>(v), static_cast<const Wt*>(w),
          static_cast<const int32_t*>(ev), static_cast<const Acc*>(gate),
          static_cast<const float*>(alive), static_cast<VS*>(v_out),
          static_cast<Acc*>(s_out), T, E, Win, Cin, Din, Dout, cols, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_fc_window(const void* v, const void* w,
                                   const void* ev, const void* gate,
                                   const void* alive, void* v_out,
                                   void* s_out, int N, int T, int E, int Win,
                                   int Cin, int Din, int Dout, int cols,
                                   int pairing, float threshold, float leak,
                                   float clip, int leak_mode, int reset_mode,
                                   int has_clip, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || T <= 0 || E <= 0 || Dout <= 0 || Din <= 0 || cols <= 0 ||
      cols > kThreads)
    return (int)cudaErrorInvalidValue;
  const sne::LifArgs p{threshold, leak, clip, leak_mode, reset_mode,
                       has_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_FC_WINDOW_LAUNCH(VS, Wt, Acc)                                \
  launch<VS, Wt, Acc>(v, w, ev, gate, alive, v_out, s_out, N, T, E, Win, \
                      Cin, Din, Dout, cols, p, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_FC_WINDOW_LAUNCH)
#undef SNE_FC_WINDOW_LAUNCH
  return (int)err;
}
