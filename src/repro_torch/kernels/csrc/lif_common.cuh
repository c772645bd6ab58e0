// LIF boundary arithmetic shared by the three fused window kernels.
//
// The per-site sequence of one timestep boundary, templated on the
// accumulator (float on the carrier pairing, int32 on the native one), in
// the operations `core.lif` performs: the leak `sign(v)*max(|v| - leak, 0)`
// ("toward_zero") or `v - leak` ("subtract"); the clip to +-state_clip; the
// threshold test `v >= th`; the zero reset (`v * (1 - s)`, i.e. 0 where it
// fired) or the soft reset `v - s*th`; the int8 storage clamp; and the
// analytic idle decay of a cold tile over `dt` alive timesteps.  Float
// operations are separate, correctly rounded adds and multiplies (no fused
// multiply-add), so every membrane rounds as the plain version does; the
// results can differ from it only in the sign of a zero, which no
// comparison, spike or count can see.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter_common.cuh"

namespace sne {

// leak_mode: 0 "toward_zero", 1 "subtract"; reset_mode: 0 "zero" (hard),
// 1 "subtract" (soft).  Constants arrive as float32; the native pairing
// holds integral values (`core.quant` lowers them so) and converts them.
struct LifArgs {
  float threshold, leak, clip;
  int leak_mode, reset_mode, has_clip;
};

template <typename Acc>
__device__ __forceinline__ Acc leak_by(Acc v, Acc step, int leak_mode) {
  if (leak_mode == 1) return sub_rn(v, step);
  const Acc a = v < Acc(0) ? Acc(0) - v : v;
  const Acc m = sub_rn(a, step);
  const Acc r = m > Acc(0) ? m : Acc(0);
  return v > Acc(0) ? r : (v < Acc(0) ? Acc(0) - r : v);
}

// one boundary's leak (dt == 1)
template <typename Acc>
__device__ __forceinline__ Acc leak_step(Acc v, const LifArgs& p) {
  return leak_by(v, static_cast<Acc>(p.leak), p.leak_mode);
}

template <typename Acc>
__device__ __forceinline__ Acc clip_state(Acc v, const LifArgs& p) {
  if (!p.has_clip) return v;
  const Acc c = static_cast<Acc>(p.clip);
  return v < -c ? -c : (v > c ? c : v);
}

// clip, threshold, reset; returns the spike (0 or 1) and updates v
template <typename Acc>
__device__ __forceinline__ Acc clip_fire_reset(Acc& v, const LifArgs& p) {
  const Acc th = static_cast<Acc>(p.threshold);
  v = clip_state(v, p);
  const bool fire = v >= th;
  if (fire) v = p.reset_mode == 0 ? Acc(0) : sub_rn(v, th);
  return fire ? Acc(1) : Acc(0);
}

template <typename Acc>
__device__ __forceinline__ Acc saturate_int8(Acc v) {
  return v < Acc(-128) ? Acc(-128) : (v > Acc(127) ? Acc(127) : v);
}

// `dt` input-free timesteps at once: leak by leak*dt, then clip (dt > 0)
template <typename Acc>
__device__ __forceinline__ Acc idle_decay(Acc v, const LifArgs& p, int dt) {
  if (dt <= 0) return v;
  const Acc step = mul_rn(static_cast<Acc>(p.leak), static_cast<Acc>(dt));
  return clip_state(leak_by(v, step, p.leak_mode), p);
}

// the tile of interior site (x, y) in a grid of (th, tw) tiles, nTy wide
__device__ __forceinline__ int tile_of(int x, int y, int th, int tw,
                                       int nTy) {
  return (x / th) * nTy + y / tw;
}

// tile bitmaps hold at most TILE_GRID_MAX^2 entries (window_common.py)
constexpr int kMaxTiles = 16;

// Window pairing codes, as `kernels/_common.py::WINDOW_PAIRINGS` numbers
// them: (slab, weights, gate, accumulator)
//   0: f32,  f32,  f32,   f32    (the float32 carrier)
//   1: int8, int8, int32, int32  (int8-native)
#define SNE_DISPATCH_WINDOW_PAIRING(pairing, LAUNCH)          \
  switch (pairing) {                                          \
    case 0: err = LAUNCH(float, float, float); break;         \
    case 1: err = LAUNCH(int8_t, int8_t, int32_t); break;     \
    default: err = cudaErrorInvalidValue;                     \
  }

}  // namespace sne
