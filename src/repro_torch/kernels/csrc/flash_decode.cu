// Single-token grouped-query decode attention on Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's kernels/flash_decode.py:
// `_decode_kernel` behind `flash_decode_tpu`.  Same function: for each
// batch row b and query head h = kv * G + g, softmax(q . K^T * hd^-0.5)
// over the first n_valid cache slots, times V, plus the running max m and
// sum l of the softmax (for a cross-shard merge).  Keys at pos >= n_valid
// are masked to -1e30, tiles that start at or past n_valid are skipped,
// and out = acc / max(l, 1e-37).  float32 throughout.
//
// What bounds it on this card: device-memory bytes.  Every valid key and
// value row is read once (2 * B * n_valid * KV * hd * 4 bytes: 15.7 MB at
// the serving shape B = 4, n_valid = 512, KV = 8, hd = 120, 4.7 us at
// 3.35 TB/s); the arithmetic is 4 flops per byte read at most.
//
// What the design does about it: one block per (b, kv head), so the G
// query heads of a group share every K/V tile it loads (the reference's
// `bh // G` index map).  The cache is read in place in its (B, Skv, KV,
// hd) layout through its strides (no transpose copy), in tiles of 32 rows
// double-buffered in shared memory with cp.async: tile t + 1 streams in
// while tile t is scored (one warp per key, lanes across hd in 16-byte
// vectors), run through the online softmax (one warp per query head) and
// accumulated (one thread per output dimension, G accumulators each).  hd
// need not be a power of two (120 floats are 480 bytes: 30 float4 lanes);
// it must be a multiple of 4 with 16-byte aligned rows, which the wrapper
// checks.  At the serving shape the grid is only B * KV = 32 blocks, so
// the kernel is latency-bound, not bandwidth-bound; splitting the keys
// over more blocks is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // cache rows per tile
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;                    // (B, H, hd) contiguous
  const float* k;                    // (B, Skv, KV, hd), unit stride in hd
  const float* v;
  float* out;                        // (B, H, hd)
  float* m;                          // (B, H)
  float* l;                          // (B, H)
  int H, KV, hd, n_valid;
  long long k_sb, k_ss, k_sh;        // strides in elements
  long long v_sb, v_ss, v_sh;
  float scale;
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16-byte copy from device memory to shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying the valid rows of the tile at k0 into k_s / v_s.
__device__ __forceinline__ void load_tile(const Params& p, const float* kb,
                                          const float* vb, float* k_s,
                                          float* v_s, int k0) {
  const int rows = min(kTile, p.n_valid - k0);
  const int nc = p.hd / 4;
  for (int i = threadIdx.x; i < rows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = (i - r * nc) * 4;
    cp_async16(k_s + r * p.hd + c, kb + (k0 + r) * p.k_ss + c);
    cp_async16(v_s + r * p.hd + c, vb + (k0 + r) * p.v_ss + c);
  }
  cp_async_commit();
}

template <int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int hd = p.hd;
  float* kv_s = smem;                          // 2 buffers x (K, V) tiles
  float* q_s = kv_s + 4 * kTile * hd;          // (G, hd)
  float* acc_s = q_s + G * hd;                 // (G, hd)
  float* s_s = acc_s + G * hd;                 // (G, kTile) scores, then p
  float* m_s = s_s + G * kTile;                // (G,) running max
  float* l_s = m_s + G;                        // (G,) running sum
  float* c_s = l_s + G;                        // (G,) this tile's correction

  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x - b * p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = kvh * G;                      // first query head of the group
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  const int n_tiles = (p.n_valid + kTile - 1) / kTile;
  if (n_tiles > 0)
    load_tile(p, kb, vb, kv_s, kv_s + kTile * hd, 0);
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = p.q[(static_cast<long long>(b) * p.H + h0) * hd + i];
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    float* k_s = kv_s + (t & 1) * 2 * kTile * hd;
    float* v_s = k_s + kTile * hd;
    if (t + 1 < n_tiles) {
      float* nk = kv_s + ((t + 1) & 1) * 2 * kTile * hd;
      load_tile(p, kb, vb, nk, nk + kTile * hd, k0 + kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: one warp per key, lanes across hd in float4s
    const int nc = hd / 4;
    for (int j = warp; j < kTile; j += kWarps) {
      if (k0 + j < p.n_valid) {
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.f;
        const float4* krow = reinterpret_cast<const float4*>(k_s + j * hd);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int c = lane; c < nc; c += 32) {
          const float4 kv = krow[c];
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += dot4(kv, q4[g * nc + c]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = warp_sum(part[g]);
        if (lane == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) s_s[g * kTile + j] = part[g] * p.scale;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) s_s[g * kTile + j] = kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head (kTile == 32: a key per lane)
    for (int g = warp; g < G; g += kWarps) {
      const float x = s_s[g * kTile + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float e = expf(x - m_new);
      s_s[g * kTile + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V: one thread per output dimension
    const int rows = min(kTile, p.n_valid - k0);
    for (int d = tid; d < hd; d += kThreads) {
      float a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] = acc_s[g * hd + d] * c_s[g];
#pragma unroll 8
      for (int j = 0; j < rows; ++j) {
        const float vv = v_s[j * hd + d];
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] += s_s[g * kTile + j] * vv;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) acc_s[g * hd + d] = a[g];
    }
    __syncthreads();   // tile buffers and scores are reused next round
  }

  __syncthreads();   // the statistics, when no tile ran (n_valid == 0)
  const long long row = static_cast<long long>(b) * p.H + h0;
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    p.out[row * hd + i] = acc_s[i] / fmaxf(l_s[g], 1e-37f);
  }
  if (tid < G) {
    p.m[row + tid] = m_s[tid];
    p.l[row + tid] = l_s[tid];
  }
}

template <int G>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (4 * kTile * p.hd + 2 * G * p.hd + G * kTile + 3 * G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_decode_kernel<G><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch one block per (batch row, kv head) on `stream`.  hd, the cache
// strides and the base pointers must allow 16-byte copies (the caller
// checks).  Returns the CUDA error code of the launch (0 on success), or
// -1 for a group size G = H / KV the kernel is not compiled for.
int flash_decode_launch(const float* q, const float* k, const float* v,
                        float* out, float* m, float* l, int B, int H, int KV,
                        int hd, int n_valid, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, float scale, void* stream) {
  const Params p{q, k, v, out, m, l, H, KV, hd, n_valid,
                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  const int blocks = B * KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / KV) {
    case 1: return launch<1>(p, blocks, s);
    case 2: return launch<2>(p, blocks, s);
    case 4: return launch<4>(p, blocks, s);
    case 8: return launch<8>(p, blocks, s);
    case 16: return launch<16>(p, blocks, s);
    default: return -1;
  }
}

const char* flash_decode_error_string(int err) {
  return err < 0 ? "unsupported group size"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
