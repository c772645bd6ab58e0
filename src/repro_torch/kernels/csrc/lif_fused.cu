// Fused elementwise LIF boundary, for Hopper (sm_90a).
//
// Replaces the TPU kernel `lif_fused_pallas`
// (src/repro/kernels/lif/kernel.py, body `_lif_kernel`).  For every element
// of a float32 membrane `v` and its synaptic input `syn`, with `dt` leak
// steps at once:
//
//     v = sign(v) * max(|v| - leak * dt, 0)     (toward-zero leak)
//     v = v + syn
//     v = clip(v, -state_clip, state_clip)      (when a clip is given)
//     s = v >= threshold
//     v = v * (1 - s)                           (hard reset)
//
// and returns (v, s).  Every float operation is a separate, correctly
// rounded `__f*_rn` intrinsic (no fused multiply-add), so the results are
// bitwise those of the plain version.
//
// What bounds it on the card: bytes, two float32 streams in and two out
// (16 bytes an element for about ten operations).
//
// Design: a grid-stride loop, one element per thread per step, neighbouring
// threads on neighbouring addresses; `dt` is read from device memory (a
// 0-d tensor), so the launch needs no host synchronisation.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lif_fused_kernel(const float* __restrict__ v,
                     const float* __restrict__ syn,
                     const float* __restrict__ dt, float* __restrict__ v_out,
                     float* __restrict__ s_out, int n, float leak,
                     float threshold, float clip, int has_clip) {
  const float step = __fmul_rn(leak, *dt);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float a = v[i];
    const float r = fmaxf(__fsub_rn(fabsf(a), step), 0.f);
    // sign(v) * r; a zero (or NaN) keeps its own value, as sign(v) * r does
    a = a > 0.f ? r : (a < 0.f ? -r : __fmul_rn(a, r));
    a = __fadd_rn(a, syn[i]);
    if (has_clip) a = fminf(fmaxf(a, -clip), clip);
    const float s = a >= threshold ? 1.f : 0.f;
    v_out[i] = __fmul_rn(a, __fsub_rn(1.f, s));
    s_out[i] = s;
  }
}

}  // namespace

extern "C" int sne_lif_fused(const void* v, const void* syn, const void* dt,
                             void* v_out, void* s_out, int n, float leak,
                             float threshold, float clip, int has_clip,
                             void* stream) {
  // launches on the caller's current device, which owns `stream`
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int need = (n + kThreads - 1) / kThreads;
  const int blocks = need < 132 * 16 ? need : 132 * 16;   // 16 per H100 SM
  lif_fused_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(syn),
      static_cast<const float*>(dt), static_cast<float*>(v_out),
      static_cast<float*>(s_out), n, leak, threshold, clip, has_clip);
  return (int)cudaGetLastError();
}
