// How many clusters of 2-16 CTAs fit on the card, and what a cluster barrier,
// a block barrier and a distributed shared-memory load cost (clock64 cycles).
// Built and run by tools/megakernel_phases.py --cluster-probe; by hand:
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o cp cluster_probe.cu
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;

__global__ void k_sync(int iters, long long* out) {
  extern __shared__ int sm[];
  cg::cluster_group cl = cg::this_cluster();
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) cl.sync();
  long long t1 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  long long t2 = clock64();
  // a DSMEM read of the next rank
  sm[threadIdx.x] = blockIdx.x;
  cl.sync();
  int* rem = cl.map_shared_rank(sm, (cl.block_rank() + 1) % cl.num_blocks());
  int acc = 0;
  long long t3 = clock64();
  for (int i = 0; i < iters; ++i) acc += rem[(threadIdx.x + i) % blockDim.x];
  long long t4 = clock64();
  cl.sync();
  if (threadIdx.x == 0) {
    out[blockIdx.x * 4 + 0] = (t1 - t0) / iters;
    out[blockIdx.x * 4 + 1] = (t2 - t1) / iters;
    out[blockIdx.x * 4 + 2] = (t4 - t3) / iters;
    out[blockIdx.x * 4 + 3] = acc;
  }
}

int main() {
  cudaFuncSetAttribute(k_sync, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(k_sync, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  int sizes[] = {2, 4, 8, 16};
  int threads[] = {256, 512};
  int smems[] = {16 * 1024, 48 * 1024, 100 * 1024, 200 * 1024};
  for (int g : sizes)
    for (int t : threads)
      for (int s : smems) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(8 * g);
        cfg.blockDim = dim3(t);
        cfg.dynamicSmemBytes = s;
        cudaLaunchAttribute a[1];
        a[0].id = cudaLaunchAttributeClusterDimension;
        a[0].val.clusterDim.x = g;
        a[0].val.clusterDim.y = 1;
        a[0].val.clusterDim.z = 1;
        cfg.attrs = a;
        cfg.numAttrs = 1;
        int n = -1;
        cudaError_t e = cudaOccupancyMaxActiveClusters(&n, k_sync, &cfg);
        printf("cluster %2d threads %3d smem %6d: max active clusters %d (%s)\n",
               g, t, s, n, cudaGetErrorString(e));
      }
  for (int g : {8, 16}) {
    long long* d;
    cudaMalloc(&d, 8 * g * 4 * sizeof(long long));
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(8 * g);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 48 * 1024;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = g;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, k_sync, 1000, d);
    cudaError_t e2 = cudaDeviceSynchronize();
    long long h[16 * 4 * 8];
    cudaMemcpy(h, d, 8 * g * 4 * sizeof(long long), cudaMemcpyDeviceToHost);
    printf("cluster %d launch %s/%s: cluster.sync %lld cycles, __syncthreads %lld, dsmem load %lld\n",
           g, cudaGetErrorString(e), cudaGetErrorString(e2), h[0], h[1], h[2]);
    cudaFree(d);
  }
  return 0;
}
