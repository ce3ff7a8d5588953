// Shared-memory load latency of one thread on the card, in SM clock cycles.
//
// `chip_smoke.py` builds this beside the port's kernels and multiplies the
// latency by the dependent shared-memory round trips of a replay access to
// get the replay kernel's serial-chain bound.  The chain below is what that
// kernel's walking thread does: each load's address is the value the last
// load returned, so no two loads overlap.
//
// `cluster_latency` times the two steps the sharded replay adds to that
// chain, on a thread-block cluster of one thread a CTA: a cluster barrier
// (barrier.cluster.arrive.release + wait.acquire) and a dependent load from
// another CTA's shared memory (distributed shared memory, through the
// generic address `mapa` gives).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void smem_latency_kernel(int hops, long long* out) {
  constexpr int kRing = 256;
  __shared__ uint32_t ring[kRing];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  for (int j = 0; j < kRing; ++j) ring[j] = base + 4u * ((j + 33) % kRing);
  uint32_t a = base;
  for (int j = 0; j < kRing; ++j) {   // warm up
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a));
  }
  const long long t0 = clock64();
#pragma unroll 16
  for (int j = 0; j < hops; ++j) {
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a));
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = a;
}

__global__ void cluster_latency_kernel(int hops, long long* out) {
  constexpr int kRing = 256;
  __shared__ unsigned long long ring[kRing];
  unsigned rank, size;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(size));
  // each CTA's ring holds the generic addresses of the next CTA's ring
  unsigned long long next;
  const unsigned peer = (rank + 1) % size;
  for (int j = 0; j < kRing; ++j) {
    asm volatile("mapa.u64 %0, %1, %2;"
                 : "=l"(next)
                 : "l"(reinterpret_cast<unsigned long long>(
                       &ring[(j + 33) % kRing])),
                   "r"(peer));
    ring[j] = next;
  }
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
  const long long t0 = clock64();
  for (int j = 0; j < hops; ++j)
    asm volatile("barrier.cluster.arrive.release;\n\t"
                 "barrier.cluster.wait.acquire;" ::: "memory");
  const long long t1 = clock64();
  unsigned long long a = ring[0];
  for (int j = 0; j < hops; ++j)
    asm volatile("ld.u64 %0, [%0];" : "+l"(a));
  const long long t2 = clock64();
  if (rank == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = static_cast<long long>(a);
  }
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

}  // namespace

extern "C" {

// Time `hops` cluster barriers and `hops` dependent distributed-shared-
// memory loads on a cluster of `shards` CTAs (2-16) of one thread each:
// writes their SM clock cycles, measured on CTA 0, to out[0] and out[1] (a
// device pointer to three int64).  Returns the CUDA error code.
int cluster_latency(int shards, int hops, long long* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_latency_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shards, 1, 1);
  cfg.blockDim = dim3(1, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_latency_kernel, hops, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}


// Time `hops` dependent shared-memory loads on one thread: writes the SM
// clock cycles they took to out[0] (a device pointer to two int64).
// Returns the CUDA error code of the launch.
int smem_latency(int hops, long long* out, void* stream) {
  smem_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(hops,
                                                                      out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
