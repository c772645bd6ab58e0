// Slot-batched event convolution scatter-accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel `event_conv_batched_pallas`
// (src/repro/kernels/event_conv/kernel.py, body `_event_conv_batched_kernel`).
// For every slot n and every event e of that slot, in event order:
//
//     out[n, x+i, y+j, co] += W_flipped[i, j, c, co] * gate[n, e]
//
// over the halo-padded (N, Hp, Wp, Co) slab; events arrive in halo
// coordinates and are clamped like the reference's dynamic_slice.  The
// kernel takes the weights unflipped and flips them while it stages them.
//
// What bounds it on the card: the serial chain of events per site (two
// events' patches overlap and float addition is not associative) and how
// many SMs the launch keeps busy.  The bytes (the slab in and out once,
// the weights, the gated events) are far below what those cost.
//
// Design: the ordered walk of conv_walk.cuh, as in event_conv_window.cu
// without the LIF.  One block per (slot, band, channel block):
// `event_conv/ops.py::conv_plan` gives each slot enough bands of at most
// band_rows slab rows that the slots fill the card, and narrower channel
// blocks, or thinner bands, until shared memory fits (one row at one
// channel fits a slab of any width the card serves).  A slot's rows are
// dealt to its bands in turn (band y owns rows y, y + bands, ...), so the
// rows where a frame's events gather spread over every band.  A block
// stages its band's sites, cast to the accumulator, and its channels of
// the flipped weights in shared memory.  It reads the slot's gate row
// once, stops at the last gated event and keeps, in list order, only the
// events whose patch meets one of its rows; each (row, channel) lane, in
// runs of kSeg sites a thread, walks that list and applies, in order, the
// adds of the events that cover its sites, with no barrier between
// events.  Each run's owner then writes its sites back once.  An event
// whose gate is 0 is skipped (the reference adds w*0, which changes at
// most the sign of a zero).
#include "conv_walk.cuh"

namespace {

using sne::conv::Band;
using sne::conv::kMaxThreads;
using sne::conv::kPerLane;
using sne::conv::kSeg;

// The block's dynamic shared memory: the kept list (kPerLane events a
// thread, 16 bytes each), the band's sites, the weights and the warp
// partials.
template <typename Acc>
size_t smem_bytes(const Band& b, int threads) {
  return (size_t)16 * kPerLane * threads +
         sizeof(Acc) * ((size_t)b.Wp * b.lanes +
                        (size_t)b.K * b.K * b.Ci * b.C) +
         sizeof(int) * 32;
}

template <typename VIn, typename Wt, typename G, typename Acc>
__global__ void __launch_bounds__(kMaxThreads) event_conv_batched_kernel(
    const VIn* __restrict__ v, const Wt* __restrict__ w,
    const int32_t* __restrict__ ev, const G* __restrict__ gate,
    Acc* __restrict__ out, int Hp, int Wp, int Co, int K, int Ci, int E,
    int co_blk, int band_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = blockIdx.x;
  // the slab's rows are dealt to the slot's blocks in turn: block y
  // owns rows y, y + gridDim.y, ... (at most band_rows of them)
  const int r0 = blockIdx.y, step = gridDim.y;
  const int co0 = blockIdx.z * co_blk;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const Band b = Band::make(Hp, Wp, co_blk, K, Ci, 0, r0, step,
                            (Hp - 1 - r0) / step + 1);
  const int L = b.lanes;
  int4* kept = reinterpret_cast<int4*>(smem_raw);
  Acc* mem = reinterpret_cast<Acc*>(kept + kPerLane * nthr);
  Acc* wsh = mem + (size_t)Wp * band_rows * co_blk;
  int* red = reinterpret_cast<int*>(wsh + K * K * Ci * co_blk);

  const size_t v_base = (size_t)n * Hp * Wp * Co;
  for (int i = tid; i < K * K * Ci * co_blk; i += nthr) {
    // wsh[((ki*K + kj)*Ci + c)*co_blk + co] = W[K-1-ki, K-1-kj, c, co0+co]
    const int r = i / co_blk, co = i - r * co_blk;
    const int c = r % Ci, kk = r / Ci;
    const int ki = kk / K, kj = kk - ki * K;
    const int src = ((K - 1 - ki) * K + (K - 1 - kj)) * Ci + c;
    wsh[i] = static_cast<Acc>(w[(size_t)src * Co + co0 + co]);
  }
  // the band's sites, from device memory once (coalesced over channels)
  auto gidx = [&](int l, int y) {
    const int q = l / co_blk;
    return v_base + ((size_t)(r0 + q * step) * Wp + y) * Co + co0 +
           (l - q * co_blk);
  };
  for (int i = tid; i < Wp * L; i += nthr) {
    const int y = i / L, l = i - y * L;
    mem[i] = static_cast<Acc>(v[gidx(l, y)]);
  }

  const int32_t* evn = ev + (size_t)n * E * 3;
  const G* gn = gate + (size_t)n * E;
  const int n_walk = sne::walk_end(gn, E, red);   // also: the band is in
  for (int base = 0; base < n_walk; base += kPerLane * nthr) {
    if (base > 0) __syncthreads();           // the last stage is walked
    const int cnt = min(kPerLane * nthr, n_walk - base);
    const int n_kept = sne::compact<kPerLane>(
        cnt,
        [&](int i, int4& e) {
          const int32_t* x = evn + (size_t)(base + i) * 3;
          return sne::conv::conv_event(b, __ldg(x), __ldg(x + 1),
                                       __ldg(x + 2),
                                       static_cast<Acc>(gn[base + i]), e);
        },
        kept, red);
    sne::conv::walk_runs(b, mem, wsh, kept, n_kept);
  }
  // every site back once: each run's owner, right after its walk
  for (int u = tid; u < b.runs; u += nthr) {
    int l, y0;
    b.run(u, l, y0);
    for (int y = y0; y < min(y0 + kSeg, Wp); ++y)
      out[gidx(l, y)] = mem[y * L + l];
  }
}

template <typename VIn, typename Wt, typename G, typename Acc>
cudaError_t launch(const void* v, const void* w, const void* ev,
                   const void* gate, void* out, int N, int Hp, int Wp, int Co,
                   int K, int Ci, int E, int co_blk, int band_rows,
                   cudaStream_t stream) {
  const Band b = Band::make(Hp, Wp, co_blk, K, Ci, 0, 0, 1, band_rows);
  const int threads = sne::conv::block_threads(b.runs);
  const size_t smem = smem_bytes<Acc>(b, threads);
  auto kern = event_conv_batched_kernel<VIn, Wt, G, Acc>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, (Hp + band_rows - 1) / band_rows, Co / co_blk);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const VIn*>(v), static_cast<const Wt*>(w),
      static_cast<const int32_t*>(ev), static_cast<const G*>(gate),
      static_cast<Acc*>(out), Hp, Wp, Co, K, Ci, E, co_blk, band_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sne_event_conv_batched(const void* v, const void* w,
                                      const void* ev, const void* gate,
                                      void* out, int N, int Hp, int Wp,
                                      int Co, int K, int Ci, int E,
                                      int co_blk, int band_rows, int pairing,
                                      void* stream) {
  // launches on the caller's current device, which owns `stream`
  cudaError_t err;
  if (N <= 0 || E <= 0 || co_blk <= 0 || Co % co_blk != 0 ||
      band_rows <= 0 || band_rows > Hp || Hp < K || Wp < K || K <= 0 ||
      Ci <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNE_CONV_LAUNCH(VIn, Wt, G, Acc)                                   \
  launch<VIn, Wt, G, Acc>(v, w, ev, gate, out, N, Hp, Wp, Co, K, Ci, E,    \
                          co_blk, band_rows, s)
  SNE_DISPATCH_PAIRING(pairing, SNE_CONV_LAUNCH)
#undef SNE_CONV_LAUNCH
  return (int)err;
}
