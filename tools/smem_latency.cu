// Shared-memory load latency of one thread on the card, in SM clock cycles.
//
// `chip_smoke.py` builds this beside the port's kernels and multiplies the
// latency by the dependent shared-memory round trips of a replay access to
// get the replay kernel's serial-chain bound.  The chain below is what that
// kernel's walking thread does: each load's address is the value the last
// load returned, so no two loads overlap.

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

}  // namespace

extern "C" {

// Time `hops` dependent shared-memory loads on one thread: writes the SM
// clock cycles they took to out[0] (a device pointer to two int64).
// Returns the CUDA error code of the launch.
int smem_latency(int hops, long long* out, void* stream) {
  smem_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(hops,
                                                                      out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
