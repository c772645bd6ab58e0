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
// A timestep with alive[n, t] == 0 leaves the membrane as it was and emits
// a zero spike row.  The membrane is read once and written once per window;
// spikes (N, T, 1, 1, Dout) are written in the accumulator dtype, every
// entry once (zeros included), so the output needs no clearing.
//
// What bounds it on the card: bytes, as the per-step kernel — each gated
// event reads one weight row (Dout values) and does Dout adds.
//
// Design: one block per (slot, block of 128 output columns); each thread
// owns one column and keeps its membrane in a register for the whole
// window, so every add to a column happens in event order without any
// synchronisation between threads.  `alive` is one value per block and
// timestep, so a frozen timestep is skipped by the whole block.  Events are
// staged kChunk at a time in shared memory as (row, gate) pairs; gated-off
// and out-of-range events are skipped.
#include "lif_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename VS, typename Wt, typename Acc, bool kNative>
__global__ void __launch_bounds__(kThreads) event_fc_window_kernel(
    const VS* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const Acc* __restrict__ gate,
    const float* __restrict__ alive, VS* __restrict__ v_out,
    Acc* __restrict__ s_out, int T, int E, int Win, int Cin, int Din,
    int Dout, sne::LifArgs p) {
  __shared__ int ev_row[sne::kChunk];
  __shared__ Acc ev_g[sne::kChunk];
  const int n = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = d < Dout;
  Acc acc = live ? static_cast<Acc>(v[(size_t)n * Dout + d]) : Acc(0);

  for (int t = 0; t < T; ++t) {
    const size_t nt = (size_t)n * T + t;
    if (!(alive[nt] > 0.f)) {                 // uniform across the block
      if (live) s_out[nt * Dout + d] = Acc(0);
      continue;
    }
    acc = sne::leak_step(acc, p);
    const int32_t* evt = ev + nt * E * 3;
    const Acc* gt = gate + nt * E;
    for (int base = 0; base < E; base += sne::kChunk) {
      const int cnt = min(sne::kChunk, E - base);
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        const int32_t* e = evt + (size_t)(base + i) * 3;
        const Acc g = gt[base + i];
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
                   int Din, int Dout, sne::LifArgs p, cudaStream_t stream) {
  constexpr bool kNative = sizeof(VS) == 1;
  dim3 grid(N, (Dout + kThreads - 1) / kThreads);
  event_fc_window_kernel<VS, Wt, Acc, kNative>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const VS*>(v), static_cast<const Wt*>(w),
          static_cast<const int32_t*>(ev), static_cast<const Acc*>(gate),
          static_cast<const float*>(alive), static_cast<VS*>(v_out),
          static_cast<Acc*>(s_out), T, E, Win, Cin, Din, Dout, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_fc_window(const void* v, const void* w,
                                   const void* ev, const void* gate,
                                   const void* alive, void* v_out,
                                   void* s_out, int N, int T, int E, int Win,
                                   int Cin, int Din, int Dout, int pairing,
                                   float threshold, float leak, float clip,
                                   int leak_mode, int reset_mode,
                                   int has_clip, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || T <= 0 || E <= 0 || Dout <= 0 || Din <= 0)
    return (int)cudaErrorInvalidValue;
  const sne::LifArgs p{threshold, leak, clip, leak_mode, reset_mode,
                       has_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_FC_WINDOW_LAUNCH(VS, Wt, Acc)                                \
  launch<VS, Wt, Acc>(v, w, ev, gate, alive, v_out, s_out, N, T, E, Win, \
                      Cin, Din, Dout, p, s)
  SNE_DISPATCH_WINDOW_PAIRING(pairing, SNE_FC_WINDOW_LAUNCH)
#undef SNE_FC_WINDOW_LAUNCH
  return (int)err;
}
