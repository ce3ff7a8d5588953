// Table-indexed page copies on Hopper (sm_90a): gather (pool -> dense) and
// scatter (dense -> pool, in place).
//
// Replaces the two Pallas kernels of the JAX package's
// kernels/page_gather.py: `_gather_kernel` behind `page_gather` and
// `_scatter_kernel` behind `page_scatter` (whose pool is aliased input to
// output).  Pages are (R, C) blocks of any dtype; the kernels copy bytes,
// so one pair serves every dtype.  For duplicate slots in a scatter table
// the last entry wins, as in the reference's sequential grid.
//
// What bounds them on this card: device-memory bytes.  Each page is read
// once and written once (2 x 5.9 MB for one KV page of the serving path,
// 3.5 us at 3.35 TB/s).
//
// What the design does about it: a 2-D grid, pages on y and slices of a
// page on x, so one launch keeps the whole card copying even for one
// page; neighbouring threads copy neighbouring 16-byte words when the
// page size and the base pointers allow it, else bytes.  The page table
// is read by each block directly (no scalar prefetch is needed on this
// card).  A scatter block first checks, with
// the whole block, whether a later table entry names the same slot, and
// then skips its write: last writer wins without ordering the blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_kernel(U* __restrict__ out, const U* __restrict__ pool,
              const int32_t* __restrict__ table, long long units, int n) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const U* src = pool + static_cast<long long>(table[i]) * units;
    U* dst = out + static_cast<long long>(i) * units;
    for (long long u = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         u < units; u += step)
      dst[u] = src[u];
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(U* __restrict__ pool, const U* __restrict__ pages,
               const int32_t* __restrict__ table, long long units, int n) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const int32_t slot = table[i];
    int later = 0;
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads)
      later |= table[j] == slot;
    if (__syncthreads_or(later)) continue;   // a later entry writes this slot
    U* dst = pool + static_cast<long long>(slot) * units;
    const U* src = pages + static_cast<long long>(i) * units;
    for (long long u = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         u < units; u += step)
      dst[u] = src[u];
  }
}

template <typename U>
int launch(void* dst, const void* src, const int32_t* table,
           long long page_bytes, int n, bool scatter, cudaStream_t stream) {
  const long long units = page_bytes / static_cast<long long>(sizeof(U));
  const long long per_block = static_cast<long long>(kThreads) * kUnitsPerThread;
  const long long gx = (units + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(gx < 1 ? 1 : (gx > 65535 ? 65535 : gx)),
                  static_cast<unsigned>(n > 65535 ? 65535 : n));
  if (scatter)
    scatter_kernel<U><<<grid, kThreads, 0, stream>>>(
        static_cast<U*>(dst), static_cast<const U*>(src), table, units, n);
  else
    gather_kernel<U><<<grid, kThreads, 0, stream>>>(
        static_cast<U*>(dst), static_cast<const U*>(src), table, units, n);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(void* dst, const void* src, const int32_t* table,
             long long page_bytes, int n, int unit_bytes, bool scatter,
             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16: return launch<uint4>(dst, src, table, page_bytes, n, scatter, s);
    default: return launch<uint8_t>(dst, src, table, page_bytes, n, scatter, s);
  }
}

}  // namespace

extern "C" {

// out[i] = pool[table[i]] for i < n, each page `page_bytes` long, copied in
// units of `unit_bytes` (16 or 1; the caller checks the alignment).
// Returns the CUDA error code of the launch (0 on success).
int page_gather_launch(void* out, const void* pool, const int32_t* table,
                       long long page_bytes, int n, int unit_bytes,
                       void* stream) {
  return dispatch(out, pool, table, page_bytes, n, unit_bytes, false, stream);
}

// pool[table[i]] = pages[i] for i < n, in place; the last i wins a slot.
int page_scatter_launch(void* pool, const void* pages, const int32_t* table,
                        long long page_bytes, int n, int unit_bytes,
                        void* stream) {
  return dispatch(pool, pages, table, page_bytes, n, unit_bytes, true, stream);
}

const char* page_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
