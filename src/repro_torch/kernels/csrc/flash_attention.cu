// Prefill attention (causal / sliding-window / cross, grouped-query) on
// Hopper (sm_90a), float32.
//
// Replaces the Pallas kernel of the JAX package's kernels/flash_attention.py:
// `_flash_kernel` behind `flash_attention_tpu`.  Same function: for batch
// row b, query position i and query head h = kv * G + g,
// softmax(q . K^T * hd^-0.5) . V over the keys of KV head kv, with keys at
// k >= Skv masked, and, when causal, keys k > i and (window > 0) keys
// i - k >= window masked to -1e30; out = acc / max(l, 1e-37).  The online
// softmax runs tile by tile as in the reference: a tile whose keys are all
// masked for a row still adds exp(0) terms while that row has seen no real
// key, and the first real maximum wipes them through corr = 0, so the
// result is the full softmax's.
//
// What bounds it on this card: float32 operations.  Each live (q, k) pair
// costs 4 * hd flops (the score and the P.V product); at the prefill shape
// (B 2, S 8192, 32 / 8 heads of 120, window 4096) that is 7.7e11 flops,
// 11.5 ms at 67 TFLOP/s, against 0.38 GB of q, k, v and out (0.1 ms).
//
// What the design does about it:
// - No padding and no transposed copies: q, k and v are read in place in
//   their (B, S, heads, hd) layout through their strides, with cp.async
//   16-byte copies (hd a multiple of 4, rows 16-byte aligned: the wrapper
//   checks).  Rows past S or Skv are zero-filled in shared memory, never
//   read from device memory; hd need not be a power of two (120 floats are
//   30 float4s).
// - One block per (64 query rows, KV head, batch row).  A block's rows are
//   the (position, head) pairs R = i * G + g of one KV head, so the G query
//   heads of a group share every K/V tile the block loads, for any G.
// - Each block walks only the key tiles that its rows' causal / window
//   band reaches, computed from its first and last position; blocks with
//   the longest bands are scheduled first.
// - Register tiling for the float32 FMA units (no TF32): 128 threads as 8
//   row groups x 16 lanes.  A thread owns 8 query rows (ty + 8 i,
//   interleaved so the two row groups of a warp read other banks): for a
//   tile of KEYS keys it computes 8 x KEYS / 16 scores from float4 reads of
//   q and k in shared memory, reduces the row max / sum over its 16 lanes
//   by shuffles, and keeps an 8 x (4 * NG) slice of the output accumulator
//   in registers (16 loads for 256 FMAs in P.V).
// - One K and one V buffer: V tile t streams in while Q.K^T of tile t runs,
//   K tile t + 1 while the softmax and P.V of tile t run.  Tiles are sized
//   so that three blocks (12 warps, <= 170 registers a thread) share an
//   SM: 64 keys up to hd 64 (69,632 bytes of shared memory at hd 64), 32
//   keys above (72,704 bytes at hd 120; 64-key tiles there leave room for
//   two blocks only, and ran slower per flop than 32-key tiles at hd 128).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // 8 row groups x 16 lanes
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;         // query rows (position, head) per block
constexpr int kRowsPerThread = 8;
constexpr int kBlocksPerSM = 3;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;                 // (B, S, H, hd), unit stride in hd
  const float* k;                 // (B, Skv, KV, hd)
  const float* v;
  float* out;                     // (B, S, H, hd) contiguous
  int S, Skv, H, KV, G, hd;
  long long q_sb, q_ss, q_sh;     // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
  int row_tiles;                  // ceil(S * G / kRows)
  int stride;                     // row stride of the q / k / v tiles, floats
};

// 16-byte copy from device memory to shared memory, bypassing L1; with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane_of(const float4 a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// max / sum over the 16 lanes that share a row group
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Start copying the block's query rows R = r0 .. r0 + kRows - 1 (R = i * G
// + g) into q_s, one row per warp at a time, a float4 per lane; rows past
// S * G are zero-filled.
__device__ __forceinline__ void load_q(const Params& p, float* q_s, int b,
                                       int kvh, int r0) {
  const int lane = threadIdx.x & 31;
  if (lane >= p.hd / 4) return;
  const int rows_total = p.S * p.G;
  for (int r = threadIdx.x >> 5; r < kRows; r += kWarps) {
    const int R = r0 + r;
    const bool ok = R < rows_total;
    const int pos = ok ? R / p.G : 0;
    const int g = ok ? R - pos * p.G : 0;
    cp_async16(q_s + r * p.stride + lane * 4,
               p.q + b * p.q_sb + pos * p.q_ss + (kvh * p.G + g) * p.q_sh +
                   lane * 4,
               ok);
  }
}

// Start copying rows k0 .. k0 + KEYS - 1 of one KV head's keys or values
// (`base`, row stride `ss`) into dst; rows past Skv are zero-filled.
template <int KEYS>
__device__ __forceinline__ void load_tile(const Params& p, float* dst,
                                          const float* base, long long ss,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  if (lane >= p.hd / 4) return;
  for (int r = threadIdx.x >> 5; r < KEYS; r += kWarps) {
    const bool ok = k0 + r < p.Skv;
    cp_async16(dst + r * p.stride + lane * 4,
               base + (ok ? k0 + r : 0) * ss + lane * 4, ok);
  }
}

// NG: float4 column groups 64 floats apart that a thread accumulates in
// P.V (hd <= 64 * NG); KEYS: keys per tile.
template <int NG, int KEYS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_attention_kernel(const Params p) {
  constexpr int kKeys = KEYS;
  constexpr int kKeysPerThread = KEYS / 16;
  constexpr int kPStride = KEYS + 4;         // row stride of the P tile
  extern __shared__ __align__(16) float smem[];
  const int st = p.stride;
  float* q_s = smem;                         // (kRows, st)
  float* k_s = q_s + kRows * st;             // (kKeys, st)
  float* v_s = k_s + kKeys * st;             // (kKeys, st)
  float* p_s = v_s + kKeys * st;             // (kRows, kPStride) probabilities

  const int tile = p.row_tiles - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;                   // rows ty + 8 * i
  const int tx = tid & 15;                   // keys tx + 16 * j; columns
                                             // tx * 4 + 64 * g
  const int rows_total = p.S * p.G;
  const int r0 = tile * kRows;
  const int p_lo = r0 / p.G;
  const int p_hi = (min(r0 + kRows, rows_total) - 1) / p.G;

  // the key tiles this block's band reaches
  int t_lo = 0;
  int t_hi = (p.Skv - 1) / kKeys;
  if (p.causal) {
    t_hi = min(p_hi, p.Skv - 1) / kKeys;
    if (p.window > 0) t_lo = max(p_lo - p.window + 1, 0) / kKeys;
  }

  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  load_q(p, q_s, b, kvh, r0);
  load_tile<KEYS>(p, k_s, kb, p.k_ss, t_lo * kKeys);
  cp_async_commit();

  int qpos[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][4 * NG];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    qpos[i] = (r0 + ty + 8 * i) / p.G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * NG; ++d) acc[i][d] = 0.f;
  }
  bool col_ok[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) col_ok[g] = tx * 4 + 64 * g < p.hd;

  // K tile t streams in during P.V of tile t - 1, V tile t during Q.K^T
  // of tile t: one buffer each
  for (int t = t_lo; t <= t_hi; ++t) {
    load_tile<KEYS>(p, v_s, vb, p.v_ss, t * kKeys);
    cp_async_commit();
    cp_async_wait<1>();                      // K tile t (and q) have landed
    __syncthreads();

    // scores of rows ty + 8 i against keys tx + 16 j
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
    for (int c = 0; c < p.hd; c += 4) {
      float4 kv[kKeysPerThread];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * st + c);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (ty + 8 * i) * st + c);
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = dot4(qv, kv[j], s[i][j]);
      }
    }
    __syncthreads();                         // every warp is done with K
    if (t < t_hi) {
      load_tile<KEYS>(p, k_s, kb, p.k_ss, (t + 1) * kKeys);
      cp_async_commit();
    }

    // mask, online softmax, rescale the accumulator, publish P
    const int key0 = t * kKeys + tx;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float x[kKeysPerThread];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kp = key0 + 16 * j;
        bool ok = kp < p.Skv;
        if (p.causal) {
          ok = ok && qpos[i] >= kp;
          if (p.window > 0) ok = ok && qpos[i] - kp < p.window;
        }
        x[j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float e = expf(x[j] - m_new);
        p_s[(ty + 8 * i) * kPStride + tx + 16 * j] = e;
        sum += e;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < 4 * NG; ++d) acc[i][d] *= corr;
    }
    if (t < t_hi)
      cp_async_wait<1>();                    // V tile t has landed
    else
      cp_async_wait<0>();
    __syncthreads();

    // acc += P . V over the tile's keys, four at a time
#pragma unroll 2
    for (int c = 0; c < kKeys; c += 4) {
      float4 pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 8 * i) * kPStride
                                                 + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (!col_ok[g]) continue;
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (c + cc) * st + tx * 4 + 64 * g);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const float w = lane_of(pv[i], cc);
            acc[i][4 * g + 0] = fmaf(w, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(w, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(w, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(w, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();   // V and P are rewritten next round
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int R = r0 + ty + 8 * i;
    if (R >= rows_total) continue;
    const int pos = qpos[i];
    const int h = kvh * p.G + (R - pos * p.G);
    float* o = p.out + ((static_cast<long long>(b) * p.S + pos) * p.H + h) *
                           p.hd;
    const float den = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (!col_ok[g]) continue;
      float4 r;
      r.x = acc[i][4 * g + 0] / den;
      r.y = acc[i][4 * g + 1] / den;
      r.z = acc[i][4 * g + 2] / den;
      r.w = acc[i][4 * g + 3] / den;
      *reinterpret_cast<float4*>(o + tx * 4 + 64 * g) = r;
    }
  }
}

template <int NG, int KEYS>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  // q, K and V tiles, and P with rows of KEYS + 4
  const int smem = static_cast<int>(sizeof(float)) *
                   ((kRows + 2 * KEYS) * p.stride + kRows * (KEYS + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NG, KEYS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_kernel<NG, KEYS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<NG, KEYS><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`: q (B, S, H, hd), k / v (B, Skv, KV, hd), read through
// their strides (in elements; unit stride in hd, every row 16-byte aligned:
// the caller checks), into out (B, S, H, hd) contiguous.  Returns the CUDA
// error code of the launch (0 on success), or a negative code for a shape
// the kernel does not take.
int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* out, int B, int S, int Skv, int H, int KV,
                           int hd, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, int causal, int window,
                           float scale, void* stream) {
  if (hd < 4 || hd > 128 || hd % 4) return -1;
  if (KV < 1 || H % KV) return -2;
  if (B < 1 || B > 65535 || KV > 65535 || S < 1 || Skv < 1) return -3;
  if (causal && Skv != S) return -4;
  const int G = H / KV;
  if (static_cast<long long>(S) * G > (1LL << 30)) return -3;
  // row stride of the tiles: hd floats, plus 4 when hd / 4 is even, so the
  // 8 lanes of a shared-memory phase read 8 distinct 16-byte bank groups
  const int stride = (hd / 4) % 2 ? hd : hd + 4;
  const int row_tiles = (S * G + kRows - 1) / kRows;
  const Params p{q, k, v, out, S, Skv, H, KV, G, hd,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, scale, row_tiles, stride};
  const dim3 grid(row_tiles, KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tiles sized so that three blocks share an SM's 228 KB of shared memory
  return hd <= 64 ? launch<1, 64>(p, grid, s) : launch<2, 32>(p, grid, s);
}

const char* flash_attention_error_string(int err) {
  switch (err) {
    case -1: return "unsupported head_dim (a multiple of 4 in [4, 128])";
    case -2: return "H is not a multiple of KV";
    case -3: return "unsupported batch, sequence or head count";
    case -4: return "causal attention needs Skv == S";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
