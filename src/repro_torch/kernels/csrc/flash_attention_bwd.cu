// Backward of prefill attention (causal / sliding-window / cross,
// grouped-query) on Hopper (sm_90a), float32, deterministic (no atomics).
//
// Replaces no Pallas kernel: the JAX package differentiates its attention
// through a jnp custom VJP, models/flash_vjp.py `_flash_bwd` (and `_tri_bwd`
// for the triangular tiling, the same function).  Same function: with the
// forward's lse (B, H, S) (flash_attention.cu's LSE instance) and out, for
// every (b, query head h = kv * G + g, query row i, key c) pair the mask
// lets through (c < Skv; when causal c <= i and, for window > 0,
// i - c < window),
//   P = exp(q_i . k_c * scale - lse_i),  delta_i = sum_d dO_i,d * O_i,d,
//   dS = P * (dO_i . v_c - delta_i) * scale,
//   dV_c += P * dO_i,  dK_c += dS * q_i,  dQ_i += dS * k_c,
// dK and dV summed over the G query heads of KV head kv; masked pairs give
// P = 0, as exp(-1e30 - lse) does in the reference.
//
// Three kernels:
// - delta: one warp a (b, i, h) row, delta = rowsum(dO * O);
// - dkdv: a block a (key tile of 64, KV head, b).  K and V stay in shared
//   memory; the block walks the G heads and every query tile of 64 rows
//   that its keys' causal / window band reaches, recomputing S and dO . V^T
//   there, and keeps its dK and dV in registers to the end;
// - dq: a block a (query tile of 64, head, b).  Q and dO stay in shared
//   memory; it walks the key tiles its band reaches, recomputing S and
//   dO . V^T, and keeps dQ in registers.
// Each output element is summed by one thread in one order: reruns give
// the same bits.
//
// Numerics: plain FP32 FMA on the CUDA cores, float32 products and sums
// (no TF32).  The CPU version (kernels/flash_attention.py,
// `flash_attention_bwd_plain`) takes the same float32 products and sums
// them in another order; each sum runs over at most Skv (or S x G) terms,
// so the two agree to float32 rounding (held at 2e-5 absolute and
// relative, the CPU tests' tolerance against the reference).
//
// What bounds it: operations.  At minicpm-2b's training shape (B 2, S
// 2048, 36 / 36 heads of 64, causal) dkdv takes four products of 2 hd
// flops a live (q, k) pair and dq three: 1.35e11 flops, 2.0 ms on the
// FP32 FMA units at 67 TFLOP/s, against 0.13 GB of inputs and outputs
// (0.04 ms).  A tile's four products run from shared memory, a 4 x 4 register
// tile a thread (ty, tx) of 16 x 16: rows ty + 16 i, columns tx + 16 j.
// Rows are padded to HD + 1 floats, so the 16 rows a warp reads at one
// column fall in distinct banks.  Making it fast (wgmma on split TF32 as
// the forward, TMA) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kTile = 64;            // query rows and keys a tile
constexpr int kPL = kTile + 1;       // row stride of the P / dS tiles

struct Params {
  const float* q;      // (B, S, H, hd) contiguous
  const float* k;      // (B, Skv, KV, hd) contiguous
  const float* v;
  const float* dout;   // (B, S, H, hd) contiguous
  const float* lse;    // (B, H, S)
  const float* delta;  // (B, H, S)
  float* dq;           // (B, S, H, hd)
  float* dk;           // (B, Skv, KV, hd)
  float* dv;
  int S, Skv, H, KV, G, hd, causal, window;
  float scale;
};

__host__ __device__ constexpr int row_floats(int hd_pad) { return hd_pad + 1; }

// Rows r0 .. r0 + kTile - 1 of one head of a (rows, heads, hd) tensor
// (src at the head's row 0, row stride `stride` floats) into dst (row
// stride HD + 1); rows at or past `rows` and columns at or past hd are
// zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, long long stride,
                                          int hd) {
  constexpr int C4 = HD / 4;
  for (int idx = threadIdx.x; idx < kTile * C4; idx += kThreads) {
    const int r = idx / C4, c = 4 * (idx - r * C4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows && c < hd)
      x = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c);
    float* d = dst + r * row_floats(HD) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// s[i][j] = a_row(ty + 16 i) . b_row(tx + 16 j) and t[i][j] = c_row . d_row
// over HD columns (two products in one pass over the columns)
template <int HD>
__device__ __forceinline__ void two_products(float (&s)[4][4],
                                             float (&t)[4][4], const float* a,
                                             const float* b, const float* c,
                                             const float* d, int ty, int tx) {
  constexpr int LD = row_floats(HD);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < HD; ++e) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * LD + e];
      cv[i] = c[(ty + 16 * i) * LD + e];
      bv[i] = b[(tx + 16 * i) * LD + e];
      dv[i] = d[(tx + 16 * i) * LD + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], dv[j], t[i][j]);
      }
  }
}

// is the (query position, key) pair live?
__device__ __forceinline__ bool live(const Params& p, int pos, int key) {
  bool ok = pos < p.S && key < p.Skv;
  if (p.causal) ok = ok && pos >= key && (p.window <= 0 || pos - key < p.window);
  return ok;
}

// P and dS of a tile from S = Q . K^T and dP = dO . V^T, rows of query
// positions q0 + ty + 16 i, keys k0 + tx + 16 j
__device__ __forceinline__ void scores(const Params& p, float (&s)[4][4],
                                       float (&dp)[4][4], const float* lse_s,
                                       const float* delta_s, int q0, int k0,
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float pij = 0.f;
      if (live(p, q0 + r, k0 + c)) pij = expf(s[i][j] * p.scale - lse_s[r]);
      s[i][j] = pij;
      dp[i][j] = pij * (dp[i][j] - delta_s[r]) * p.scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const float* dout, const float* out,
                                 float* delta, int S, int H, int hd,
                                 long long rows) {
  const long long r = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* a = dout + r * hd;
  const float* o = out + r * hd;
  float acc = 0.f;
  for (int e = lane; e < hd; e += 32) acc = fmaf(a[e], o[e], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // r = (b * S + i) * H + h  ->  delta[(b * H + h) * S + i]
    const long long bi = r / H;
    const int h = static_cast<int>(r - bi * H);
    const long long b = bi / S;
    const int i = static_cast<int>(bi - b * S);
    delta[(b * H + h) * S + i] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const Params p) {
  constexpr int LD = row_floats(HD);
  constexpr int NJ = HD / 16;                 // dK / dV columns a thread
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                          // kTile x LD each
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;             // kTile x kPL, [row][key]
  float* ds_s = p_s + kTile * kPL;
  float* lse_s = ds_s + kTile * kPL;          // kTile
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long kv_stride = static_cast<long long>(p.KV) * p.hd;
  const long long q_stride = static_cast<long long>(p.H) * p.hd;
  const float* kb = p.k + (static_cast<long long>(b) * p.Skv * p.KV + kvh) * p.hd;
  const float* vb = p.v + (static_cast<long long>(b) * p.Skv * p.KV + kvh) * p.hd;
  load_tile<HD>(k_s, kb, k0, p.Skv, kv_stride, p.hd);
  load_tile<HD>(v_s, vb, k0, p.Skv, kv_stride, p.hd);

  // the query tiles this key tile's band reaches
  const int k1 = min(k0 + kTile, p.Skv) - 1;
  int q_lo = 0, q_hi = p.S - 1;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(q_hi, k1 + p.window - 1);
  }
  const int t_lo = q_lo / kTile, t_hi = q_hi / kTile;

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < p.G; ++g) {
    const int h = kvh * p.G + g;
    const float* qb = p.q + (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
    const float* dob = p.dout + (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
    const float* lseb = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
    const float* deltab = p.delta + (static_cast<long long>(b) * p.H + h) * p.S;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();                        // the last tile's reads done
      load_tile<HD>(q_s, qb, q0, p.S, q_stride, p.hd);
      load_tile<HD>(do_s, dob, q0, p.S, q_stride, p.hd);
      if (threadIdx.x < kTile) {
        const int pos = q0 + threadIdx.x;
        lse_s[threadIdx.x] = pos < p.S ? lseb[pos] : 0.f;
        delta_s[threadIdx.x] = pos < p.S ? deltab[pos] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      // S = Q . K^T and dP = dO . V^T: rows = queries, columns = keys
      two_products<HD>(s, dp, q_s, k_s, do_s, v_s, ty, tx);
      scores(p, s, dp, lse_s, delta_s, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(ty + 16 * i) * kPL + tx + 16 * j] = s[i][j];
          ds_s[(ty + 16 * i) * kPL + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV += P^T . dO, dK += dS^T . Q: rows = keys ty + 16 i, columns =
      // head dims tx + 16 j
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pv[4], dsv[4], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * kPL + ty + 16 * i];
          dsv[i] = ds_s[r * kPL + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = do_s[r * LD + tx + 16 * j];
          qv[j] = q_s[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Skv) continue;
    const long long row = (static_cast<long long>(b) * p.Skv + key) * p.KV + kvh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.hd) {
        p.dk[row * p.hd + c] = dk[i][j];
        p.dv[row * p.hd + c] = dv[i][j];
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const Params p) {
  constexpr int LD = row_floats(HD);
  constexpr int NJ = HD / 16;                 // dQ columns a thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // kTile x LD each
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;             // kTile x kPL, [row][key]
  float* lse_s = ds_s + kTile * kPL;
  float* delta_s = lse_s + kTile;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long kv_stride = static_cast<long long>(p.KV) * p.hd;
  const long long q_stride = static_cast<long long>(p.H) * p.hd;
  const float* qb = p.q + (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
  const float* dob = p.dout + (static_cast<long long>(b) * p.S * p.H + h) * p.hd;
  const float* kb = p.k + (static_cast<long long>(b) * p.Skv * p.KV + kvh) * p.hd;
  const float* vb = p.v + (static_cast<long long>(b) * p.Skv * p.KV + kvh) * p.hd;
  load_tile<HD>(q_s, qb, q0, p.S, q_stride, p.hd);
  load_tile<HD>(do_s, dob, q0, p.S, q_stride, p.hd);
  if (threadIdx.x < kTile) {
    const int pos = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.S + pos;
    lse_s[threadIdx.x] = pos < p.S ? p.lse[at] : 0.f;
    delta_s[threadIdx.x] = pos < p.S ? p.delta[at] : 0.f;
  }

  // the key tiles this query tile's band reaches
  const int q1 = min(q0 + kTile, p.S) - 1;
  int c_lo = 0, c_hi = p.Skv - 1;
  if (p.causal) {
    c_hi = min(c_hi, q1);
    if (p.window > 0) c_lo = max(q0 - p.window + 1, 0);
  }

  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  for (int t = c_lo / kTile; t <= c_hi / kTile; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                          // the last tile's reads done
    load_tile<HD>(k_s, kb, k0, p.Skv, kv_stride, p.hd);
    load_tile<HD>(v_s, vb, k0, p.Skv, kv_stride, p.hd);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<HD>(s, dp, q_s, k_s, do_s, v_s, ty, tx);
    scores(p, s, dp, lse_s, delta_s, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * kPL + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ += dS . K: rows = queries ty + 16 i, columns = head dims tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * kPL + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty + 16 * i;
    if (pos >= p.S) continue;
    float* row = p.dq + ((static_cast<long long>(b) * p.S + pos) * p.H + h) * p.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.hd) row[c] = dq[i][j];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, dim3 grid, int smem_floats,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int check_shape(int B, int S, int Skv, int H, int KV, int hd, int causal) {
  if (hd < 4 || hd > 128 || hd % 4) return -1;
  if (KV < 1 || H % KV) return -2;
  if (B < 1 || B > 65535 || H > 65535 || KV > 65535 || S < 1 || Skv < 1)
    return -3;
  if (causal && Skv != S) return -4;
  return 0;
}

Params make_params(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dq, float* dk, float* dv, int S, int Skv, int H,
                   int KV, int hd, int causal, int window, float scale) {
  return Params{q, k, v, dout, lse, delta, dq, dk, dv, S, Skv, H, KV,
                H / KV, hd, causal, window, scale};
}

// shared memory of the two tile kernels, floats: four hd tiles, the P / dS
// tiles (dkdv two, dq one), lse and delta
constexpr int dkdv_floats(int hd_pad) {
  return 4 * kTile * row_floats(hd_pad) + 2 * kTile * kPL + 2 * kTile;
}
constexpr int dq_floats(int hd_pad) {
  return 4 * kTile * row_floats(hd_pad) + kTile * kPL + 2 * kTile;
}

}  // namespace

extern "C" {

// delta (B, H, S) = rowsum(dout * out) over hd, dout and out (B, S, H, hd)
// contiguous.  Returns the CUDA error of the launch (0 on success).
int flash_attention_bwd_delta_launch(const float* dout, const float* out,
                                     float* delta, int B, int S, int H,
                                     int hd, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1) return -3;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -3;
  flash_attention_bwd_delta_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                     0, static_cast<cudaStream_t>(stream)>>>(
      dout, out, delta, S, H, hd, rows);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (B, Skv, KV, hd) contiguous from q, dout (B, S, H, hd), k, v (B,
// Skv, KV, hd), lse and delta (B, H, S), all contiguous.  Returns the CUDA
// error of the launch, or a negative code for a shape it does not take.
int flash_attention_bwd_dkdv_launch(const float* q, const float* k,
                                    const float* v, const float* dout,
                                    const float* lse, const float* delta,
                                    float* dk, float* dv, int B, int S,
                                    int Skv, int H, int KV, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
  const int bad = check_shape(B, S, Skv, H, KV, hd, causal);
  if (bad) return bad;
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, S,
                               Skv, H, KV, hd, causal, window, scale);
  const dim3 grid((Skv + kTile - 1) / kTile, KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd <= 64
             ? launch(flash_attention_bwd_dkdv_kernel<64>, p, grid,
                      dkdv_floats(64), s)
             : launch(flash_attention_bwd_dkdv_kernel<128>, p, grid,
                      dkdv_floats(128), s);
}

// dq (B, S, H, hd) contiguous; the rest as above.
int flash_attention_bwd_dq_launch(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* delta,
                                  float* dq, int B, int S, int Skv, int H,
                                  int KV, int hd, int causal, int window,
                                  float scale, void* stream) {
  const int bad = check_shape(B, S, Skv, H, KV, hd, causal);
  if (bad) return bad;
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr,
                               nullptr, S, Skv, H, KV, hd, causal, window,
                               scale);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd <= 64
             ? launch(flash_attention_bwd_dq_kernel<64>, p, grid,
                      dq_floats(64), s)
             : launch(flash_attention_bwd_dq_kernel<128>, p, grid,
                      dq_floats(128), s);
}

const char* flash_attention_bwd_error_string(int err) {
  switch (err) {
    case -1: return "unsupported head_dim (a multiple of 4 in [4, 128])";
    case -2: return "H is not a multiple of KV";
    case -3: return "unsupported batch, sequence or head count";
    case -4: return "causal attention needs Skv == S";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
