// Shared pieces of the event scatter kernels (per-step and window).
//
// Arithmetic helpers keep float adds and multiplies as separate, correctly
// rounded operations (no fused multiply-add), so every membrane sees the
// same float32 operations, in the same order, as the plain PyTorch version
// and the JAX reference.  Integer pairings accumulate in int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sne {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ int32_t mul_rn(int32_t a, int32_t b) { return a * b; }
__device__ __forceinline__ int32_t add_rn(int32_t a, int32_t b) { return a + b; }
__device__ __forceinline__ int32_t sub_rn(int32_t a, int32_t b) { return a - b; }

// Pairing codes, as `kernels/_common.py::PAIRINGS` numbers them:
//   0: f32 slab, f32 weights, f32 gate   -> f32
//   1: int8 slab, int8 codes, int8 gate  -> int32
//   2: int32 slab, int8 codes, int32 gate -> int32
#define SNE_DISPATCH_PAIRING(pairing, LAUNCH)                      \
  switch (pairing) {                                               \
    case 0: err = LAUNCH(float, float, float, float); break;       \
    case 1: err = LAUNCH(int8_t, int8_t, int8_t, int32_t); break;  \
    case 2: err = LAUNCH(int32_t, int8_t, int32_t, int32_t); break; \
    default: err = cudaErrorInvalidValue;                          \
  }

}  // namespace sne
