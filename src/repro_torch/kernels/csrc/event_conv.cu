// Slot-batched event convolution scatter-accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel `event_conv_batched_pallas`
// (src/repro/kernels/event_conv/kernel.py, body `_event_conv_batched_kernel`).
// For every slot n and every event e of that slot, in event order:
//
//     out[n, x+i, y+j, co] += W_flipped[i, j, c, co] * gate[n, e]
//
// over the halo-padded (N, Hp, Wp, Co) slab; events arrive in halo
// coordinates and the weights are flipped by the wrapper.
//
// What bounds it on the card: neither bytes nor arithmetic.  A launch moves
// the slab in and out once (tens of kB per slot) and does K*K*Co adds per
// event, but the events of one slot must be applied one after another,
// because two events' patches overlap and float addition is not
// associative.  The bound is the serial chain of events per block.
//
// Design: one block per (slot, output-channel block).  The block's slab
// slice lives in shared memory for the whole event list (it is read from
// and written to device memory once), as do the block's flipped weights.
// Each thread owns one (i, j, co) patch offset; per event every thread does
// one shared-memory read-modify-write, then the block synchronises, which
// keeps every site's updates in event order without float atomics.
// Events are staged into shared memory kChunk at a time.  An event whose
// gate is 0 is skipped by the whole block (the reference adds w*0, which
// changes at most the sign of a zero).
#include "scatter_common.cuh"

namespace {

template <typename VIn, typename Wt, typename G, typename Acc>
__global__ void event_conv_batched_kernel(
    const VIn* __restrict__ v, const Wt* __restrict__ w_f,
    const int32_t* __restrict__ ev, const G* __restrict__ gate,
    Acc* __restrict__ out, int Hp, int Wp, int Co, int K, int Ci, int E,
    int co_blk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slab_elems = Hp * Wp * co_blk;
  const int w_elems = K * K * Ci * co_blk;
  Acc* slab = reinterpret_cast<Acc*>(smem_raw);
  Acc* wsh = slab + slab_elems;
  int* ev_x = reinterpret_cast<int*>(wsh + w_elems);
  int* ev_y = ev_x + sne::kChunk;
  int* ev_c = ev_y + sne::kChunk;
  Acc* ev_g = reinterpret_cast<Acc*>(ev_c + sne::kChunk);

  const int n = blockIdx.x;
  const int co0 = blockIdx.y * co_blk;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t v_base = (size_t)n * Hp * Wp * Co;

  for (int i = tid; i < slab_elems; i += nthr) {
    const int p = i / co_blk, co = i - p * co_blk;
    slab[i] = static_cast<Acc>(v[v_base + (size_t)p * Co + co0 + co]);
  }
  for (int i = tid; i < w_elems; i += nthr) {
    const int r = i / co_blk, co = i - r * co_blk;   // r = (ki*K + kj)*Ci + c
    wsh[i] = static_cast<Acc>(w_f[(size_t)r * Co + co0 + co]);
  }
  const int ki = tid / (K * co_blk);
  const int kj = (tid / co_blk) % K;
  const int co = tid % co_blk;
  const bool owns = tid < K * K * co_blk;

  const int32_t* evn = ev + (size_t)n * E * 3;
  const G* gn = gate + (size_t)n * E;
  __syncthreads();
  for (int base = 0; base < E; base += sne::kChunk) {
    const int cnt = min(sne::kChunk, E - base);
    for (int i = tid; i < cnt; i += nthr) {
      const int32_t* e = evn + (size_t)(base + i) * 3;
      // clamp like the reference's dynamic_slice, so no address escapes
      ev_x[i] = min(max(e[0], 0), Hp - K);
      ev_y[i] = min(max(e[1], 0), Wp - K);
      ev_c[i] = min(max(e[2], 0), Ci - 1);
      ev_g[i] = static_cast<Acc>(gn[base + i]);
    }
    __syncthreads();
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
    __syncthreads();
  }
  for (int i = tid; i < slab_elems; i += nthr) {
    const int p = i / co_blk, c2 = i - p * co_blk;
    out[v_base + (size_t)p * Co + co0 + c2] = slab[i];
  }
}

template <typename VIn, typename Wt, typename G, typename Acc>
cudaError_t launch(const void* v, const void* w_f, const void* ev,
                   const void* gate, void* out, int N, int Hp, int Wp, int Co,
                   int K, int Ci, int E, int co_blk, cudaStream_t stream) {
  const size_t smem = sizeof(Acc) * ((size_t)Hp * Wp * co_blk +
                                     (size_t)K * K * Ci * co_blk) +
                      (size_t)sne::kChunk * (3 * sizeof(int) + sizeof(Acc));
  auto kern = event_conv_batched_kernel<VIn, Wt, G, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, Co / co_blk);
  kern<<<grid, K * K * co_blk, smem, stream>>>(
      static_cast<const VIn*>(v), static_cast<const Wt*>(w_f),
      static_cast<const int32_t*>(ev), static_cast<const G*>(gate),
      static_cast<Acc*>(out), Hp, Wp, Co, K, Ci, E, co_blk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_conv_batched(const void* v, const void* w_f,
                                      const void* ev, const void* gate,
                                      void* out, int N, int Hp, int Wp,
                                      int Co, int K, int Ci, int E,
                                      int co_blk, int pairing, void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || E <= 0 || co_blk <= 0 || Co % co_blk != 0 ||
      K * K * co_blk > 1024 || Hp < K || Wp < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_CONV_LAUNCH(VIn, Wt, G, Acc) \
  launch<VIn, Wt, G, Acc>(v, w_f, ev, gate, out, N, Hp, Wp, Co, K, Ci, E, co_blk, s)
  SNE_DISPATCH_PAIRING(pairing, SNE_CONV_LAUNCH)
#undef SNE_CONV_LAUNCH
  return (int)err;
}
