// Set-associative cache replay on Hopper (sm_90a), with an optional
// closed-loop latency chain in the same pass.
//
// Replaces the two Pallas kernels of the JAX package's
// kernels/cache_sim.py: `_cache_sim_kernel` (behind `cache_sim`) and
// `_cache_sim_fused_kernel` (behind `cache_sim_fused`).  One template serves
// both; FUSED compiles the latency chain in.
//
// What bounds it on this card: the serial per-access chain.  Every access
// depends on the state the previous one left, so one trace is one block on
// one SM, and each access scans the 8 * ways bytes of its set's tags and
// stamps and reduces them to a hit way and a victim way (the victim's dirty
// flag is read once, by the updating thread).  At the main-path shape
// (1 set x 4096 ways) that is 32 KB of shared memory read per access, about
// 256 cycles of shared-memory bandwidth on one SM, plus two block barriers.
// Device-memory traffic is small, about 15 bytes per access (page and write
// flag in; hit, evict, latency, arrival out).
//
// What the design does about it: the whole cache state stays on chip in
// dynamic shared memory for the whole trace when it fits (49,152 bytes at
// the main-path shape, above the 48 KB default, so the host side raises the
// block's limit), else in a global scratch that stays in L2.  Each access is
// one strided scan, one warp-shuffle + shared-memory block reduction and one
// update by a single thread, which also runs the latency chain in registers
// with the K-slot arrival ring, always in shared memory.  Independent traces
// (lanes) run as independent blocks.
//
// Semantics are bit-identical to the Pallas kernels: int32 tags, stamps
// t = i + 1 and dirty flags; invalid ways key the victim search at
// NEG = -(2**31) + 1; first-index tie-breaking for both the hit way
// (argmax of the match mask) and the victim way (argmin of the key); ring
// slot i % K on the global access index; int32 nanosecond arithmetic that
// wraps like the reference's.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t NEG = -2147483647;   // -(2**31) + 1: key of an invalid way
constexpr int kMaxWarps = 32;          // blockDim.x <= 1024
// shared-memory words of the two-level reduction: one int32 match and one
// packed int64 (key, way) per warp
constexpr int kRedWords = kMaxWarps * 3;

struct Params {
  const int32_t* pages;    // (lanes, n)
  const uint8_t* writes;   // (lanes, n)
  int64_t n;
  int num_sets, ways, is_lru;
  int outstanding, issue_ns, hit_ns, miss_ns, miss_occ_ns, wb_ns;
  int state_in_smem;
  uint8_t* hits;           // (lanes, n)
  uint8_t* evicts;         // (lanes, n)
  int32_t* lat;            // (lanes, n), FUSED only
  int32_t* arr;            // (lanes, n), FUSED only
  int32_t* state;          // (lanes, 3, num_sets, ways): final tags/meta/dirty
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ void warp_min(int& match, long long& best) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    match = min(match, __shfl_down_sync(0xffffffffu, match, off));
    best = min(best, __shfl_down_sync(0xffffffffu, best, off));
  }
}

template <bool FUSED>
__global__ void cache_sim_kernel(Params p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int64_t row_words = p.ways;
  const int64_t sw = static_cast<int64_t>(p.num_sets) * p.ways;
  const int64_t trace = static_cast<int64_t>(blockIdx.x) * p.n;
  const int K = p.outstanding;

  // shared layout: [match (32)] [packed key (32 x int64)] [ring (K)] [state?]
  int* red_match = smem;
  long long* red_best = reinterpret_cast<long long*>(smem + kMaxWarps);
  int32_t* ring = smem + kRedWords;
  int32_t* state_out = p.state + static_cast<int64_t>(blockIdx.x) * 3 * sw;
  int32_t* state = p.state_in_smem ? ring + K : state_out;
  int32_t* tags = state;
  int32_t* meta = state + sw;
  int32_t* dirty = state + 2 * sw;

  for (int64_t j = tid; j < sw; j += blockDim.x) {
    tags[j] = -1;
    meta[j] = 0;
    dirty[j] = 0;
  }
  if (FUSED) {
    for (int j = tid; j < K; j += blockDim.x) ring[j] = 0;
  }
  __syncthreads();

  const int32_t* pages = p.pages + trace;
  int32_t busy = 0;   // fill-path busy-until (thread 0 only)
  int32_t prev = 0;   // previous arrival (thread 0 only)

  for (int64_t i = 0; i < p.n; ++i) {
    const int32_t page = __ldg(pages + i);
    const int64_t row = static_cast<int64_t>(page % p.num_sets) * row_words;

    // 1. strided scan of the set: first matching way, and the
    //    lexicographic min of (key, way) with key = stamp, or NEG if invalid
    int match = INT_MAX;
    long long best = LLONG_MAX;
    for (int w = tid; w < p.ways; w += blockDim.x) {
      const int32_t tag = tags[row + w];
      if (tag == page && match == INT_MAX) match = w;
      const int32_t key = tag >= 0 ? meta[row + w] : NEG;
      best = min(best, static_cast<long long>(key) * 4294967296LL + w);
    }

    // 2. block reduction: warps, then warp 0 over the warp results
    warp_min(match, best);
    if (lane == 0) {
      red_match[warp] = match;
      red_best[warp] = best;
    }
    __syncthreads();

    if (warp == 0) {
      match = lane < nwarps ? red_match[lane] : INT_MAX;
      best = lane < nwarps ? red_best[lane] : LLONG_MAX;
      warp_min(match, best);

      // 3. one thread applies the update and runs the latency chain
      if (lane == 0) {
        const int32_t wr = p.writes[trace + i] != 0;
        const int32_t t = static_cast<int32_t>(i + 1);
        const bool hit = match != INT_MAX;
        const int victim = static_cast<int>(best & 0xffffffffLL);
        const int64_t v = row + victim;
        const bool dirty_evict = !hit && tags[v] >= 0 && dirty[v] > 0;
        if (hit) {
          const int64_t h = row + match;
          if (p.is_lru) meta[h] = t;     // FIFO keeps its insertion stamp
          dirty[h] = dirty[h] | wr;
        } else {
          tags[v] = page;
          meta[v] = t;
          dirty[v] = wr;
        }
        p.hits[trace + i] = hit;
        p.evicts[trace + i] = dirty_evict;

        if (FUSED) {
          // closed-loop arrival through the K-slot ring, then busy-until
          // queueing on the fill path for misses
          const int slot = static_cast<int>(i % K);
          const int32_t t_arr = max(wrap_add(prev, p.issue_ns), ring[slot]);
          const int32_t start = max(t_arr, busy);
          const int32_t done =
              hit ? wrap_add(t_arr, p.hit_ns)
                  : wrap_add(wrap_add(start, p.miss_ns),
                             dirty_evict ? p.wb_ns : 0);
          if (!hit) busy = wrap_add(start, p.miss_occ_ns);
          prev = t_arr;
          ring[slot] = done;
          p.lat[trace + i] = wrap_sub(done, t_arr);
          p.arr[trace + i] = t_arr;
        }
      }
    }
    __syncthreads();
  }

  if (p.state_in_smem) {
    for (int64_t j = tid; j < 3 * sw; j += blockDim.x) state_out[j] = state[j];
  }
}

template <bool FUSED>
int launch(const Params& p, int lanes, int threads, int smem_bytes,
           cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_sim_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cache_sim_kernel<FUSED><<<lanes, threads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one block per lane on `stream`.  Returns the CUDA error code of the
// launch (0 on success); the kernel itself does not synchronise.
int cache_sim_launch(const int32_t* pages, const uint8_t* writes, int64_t n,
                     int lanes, int num_sets, int ways, int is_lru, int fused,
                     int outstanding, int issue_ns, int hit_ns, int miss_ns,
                     int miss_occ_ns, int wb_ns, int state_in_smem,
                     int threads, int smem_bytes, uint8_t* hits,
                     uint8_t* evicts, int32_t* lat, int32_t* arr,
                     int32_t* state, void* stream) {
  Params p;
  p.pages = pages;
  p.writes = writes;
  p.n = n;
  p.num_sets = num_sets;
  p.ways = ways;
  p.is_lru = is_lru;
  p.outstanding = outstanding;
  p.issue_ns = issue_ns;
  p.hit_ns = hit_ns;
  p.miss_ns = miss_ns;
  p.miss_occ_ns = miss_occ_ns;
  p.wb_ns = wb_ns;
  p.state_in_smem = state_in_smem;
  p.hits = hits;
  p.evicts = evicts;
  p.lat = lat;
  p.arr = arr;
  p.state = state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fused ? launch<true>(p, lanes, threads, smem_bytes, s)
               : launch<false>(p, lanes, threads, smem_bytes, s);
}

// Largest dynamic shared memory a block may opt in to on `device`.
int cache_sim_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* cache_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
