// Prefill attention (causal / sliding-window / cross, grouped-query) on
// Hopper (sm_90a), float32 in and out, both products on the tensor cores
// in split TF32 (3xTF32).
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
// Numerics.  Plain TF32 keeps 10 mantissa bits and misses the 2e-5
// tolerance the port is held to.  Each operand x is split into big =
// tf32(x) and small = tf32(x - big), tf32 being cvt.rna.tf32.f32 (round to
// nearest, ties away from zero), and every product a . b is taken as
// small_a . big_b + big_a . small_b + big_a . big_b, in that order, into
// one float32 accumulator.  The dropped small . small term is ~2^-22
// relative, so the result keeps float32's accuracy.  The rounding is done
// as (bits + 0x1000) & ~0x1fff, the same function for finite x on the
// integer pipe; the conversion instruction itself made the kernel 10%
// slower.
//
// What bounds it on this card: tensor-core operations.  Each live (q, k)
// pair costs 4 * hd flops (the score and the P.V product), three times
// over in the split: at the prefill shape (B 2, S 8192, 32 / 8 heads of
// 120, window 4096) 3 x 7.7e11 flops, 4.69 ms at 495 TFLOP/s (TF32 dense),
// against 11.5 ms for the same work on the FP32 FMA units and 0.38 GB of
// q, k, v and out (0.1 ms).  mma.sync reaches ~320 of the 495 TFLOP/s
// (tools/mma_rate.cu); wgmma would be needed for the rest.
//
// What the design does about it:
// - mma.sync.m16n8k8 TF32 with float32 accumulators in registers.  A
//   block is 8 compute warps of 16 query rows each, plus 4 producer warps.
//   S (16 x 32 a tile) and O (16 x hd) stay in registers.  The block's Q
//   stays in shared memory as raw float32 for the whole band; each
//   k-step's A fragment is one ldmatrix.x4, split at use.  Held in
//   registers instead (with 64-key tiles), Q took ptxas to 255 registers
//   and 220-412 bytes of spills at hd 120 / 128.
// - K and V are split once a tile, not once a warp, and not by the warps
//   that multiply: the producers copy tile t + 1 with cp.async (raw K
//   into its buffer, split in place; raw V into one staging tile) and
//   write big and small copies of K (row-major) and of V^T into one of two
//   split buffers while the compute warps run tile t from the other; named
//   barriers hand each buffer over (full) and back (free).  Every B
//   fragment is one ldmatrix.x4 (two n-tiles) a copy.  Splitting at each
//   fragment cost 2 loads and 6 operations a product triple and held the
//   products to ~155 TFLOP/s; splitting between two block barriers in the
//   compute warps left the tensor cores idle a quarter of the time.
// - P never leaves registers.  The m16n8k8 accumulator gives a thread the
//   columns (2t, 2t+1) of its rows; the A operand wants (t, t + 4).  P.V
//   sums over keys, so the S accumulator of keys 8j .. 8j + 7 is fed in as
//   A unchanged, and V^T's columns are stored in the same permuted order
//   (column 8j + t <- key 8j + 2t, 8j + t + 4 <- key 8j + 2t + 1).
// - Rows are the (position, head) pairs R = i * G + g of one KV head, so
//   the G query heads of a group share every K / V tile, for any G.  A
//   block walks only the 32-key tiles that its rows' causal / window band
//   reaches; blocks with the longest bands are scheduled first.  A warp
//   skips the products of a tile that is masked for all of its rows, and
//   only tiles on the diagonal, the window's edge or past Skv pay for the
//   mask.
// - q, k and v are read in place through their strides, with no padding
//   or transposed copies in device memory.  Rows past S * G or Skv are
//   zero-filled in shared memory, and so are the columns hd .. hd8 when hd
//   is a multiple of 4 but not of 8 (hd8 rounds hd up to 8): never read
//   from device memory.  Row strides are 4 mod 8 floats, so every ldmatrix
//   phase (8 rows of 16 bytes) hits 32 distinct banks.
// - 384 threads, so at most 168 registers a thread (ptxas takes 168 at hd
//   120 / 128, 60 of them O, no spills; `setmaxnreg` did not raise the
//   compute warps' share); one block an SM, 212 / 221 KB of shared memory
//   at hd 120 / 128 (Q 62 / 66 KB, two split buffers 134 / 138, raw V
//   16 / 17).

#include <cstdint>
#include <cuda_runtime.h>

// Per-phase clock64 stamps; a stamped copy of this source defines these
// (tools/time_attention.py --phases).  Here they compile to nothing.
#ifndef FA_PHASE
#define FA_PHASE_BEGIN()
#define FA_PHASE(k)
#define FA_PHASE_END()
#endif

namespace {

constexpr int kWarps = 8;            // compute warps
constexpr int kProducers = 128;      // four warps that copy and split
constexpr int kProducerWarps = kProducers / 32;
constexpr int kThreads = kWarps * 32 + kProducers;
constexpr int kRows = kWarps * 16;   // query rows (position, head) a block
// named barriers (0 is __syncthreads): Q landed in the compute warps;
// split buffer u full (kBarFull + u) and free (kBarFree + u); the
// producers' own
constexpr int kBarQ = 1, kBarFull = 2, kBarFree = 4, kBarProd = 6;
constexpr int kKeys = 32;            // keys a tile
constexpr int kNT = kKeys / 8;       // n-tiles of S = k-steps of P.V
constexpr int kVST = kKeys + 4;      // row stride of V^T, floats
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// row stride of the Q and K tiles for NK k-steps of 8 columns, floats
__host__ __device__ constexpr int tile_stride(int nk) { return 8 * nk + 4; }

// shared memory: Q, two split K tiles (big, small), two split V^T tiles
// (rows rounded up to a pair of n-tiles), the raw V tile
__host__ __device__ constexpr int smem_floats(int nk) {
  return (kRows + 5 * kKeys) * tile_stride(nk) +
         4 * 16 * ((nk + 1) / 2) * kVST;
}

struct Params {
  const float* q;                 // (B, S, H, hd), unit stride in hd
  const float* k;                 // (B, Skv, KV, hd)
  const float* v;
  float* out;                     // (B, S, H, hd) contiguous
  int S, Skv, H, KV, G, hd;
  int nk;                         // k-steps of 8 columns: ceil(hd / 8)
  long long q_sb, q_ss, q_sh;     // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
  int row_tiles;                  // ceil(S * G / kRows)
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8 x 4 float matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8 and gets, of matrix i, register r[i] = the
// element (row l / 4, column l % 4).
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// cvt.rna.tf32.f32 (10 mantissa bits, round to nearest, ties away from
// zero), bit for bit for finite x, as two integer operations: with the
// conversion instruction the kernel ran 10% slower (tools/mma_rate.cu,
// modes 1 and 3, shows the same in the bare inner loop)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ ~2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a . b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in split TF32 for the B fragment h of a pair read by
// ldmatrix4 (big in bb, small in bs): the small terms first, then big . big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[4],
                                     const uint32_t (&bs)[4], int h) {
  mma(d, as, bb[2 * h], bb[2 * h + 1]);
  mma(d, ab, bs[2 * h], bs[2 * h + 1]);
  mma(d, ab, bb[2 * h], bb[2 * h + 1]);
}

// named barrier `id` over n threads: wait for all, or arrive and go on
// (after this thread's shared-memory accesses are made visible)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Start copying the block's query rows R = r0 .. r0 + kRows - 1 (R = i * G
// + g) into dq (row stride ST), a float4 a lane; rows past S * G are
// zero-filled.
template <int ST>
__device__ __forceinline__ void load_q(const Params& p, float* dq, int b,
                                       int kvh, int r0) {
  const int lane = threadIdx.x & 31;
  if (lane >= p.hd / 4) return;
  const int rows_total = p.S * p.G;
  for (int r = threadIdx.x >> 5; r < kRows; r += kWarps) {
    const int R = r0 + r;
    const bool ok = R < rows_total;
    const int pos = ok ? R / p.G : 0;
    const int g = ok ? R - pos * p.G : 0;
    cp_async16(dq + r * ST + lane * 4,
               p.q + b * p.q_sb + pos * p.q_ss + (kvh * p.G + g) * p.q_sh +
                   lane * 4,
               ok);
  }
}

// Start copying key rows k0 .. k0 + kKeys - 1 of K and V into dk / dv (row
// stride ST): producer warp w copies rows w, w + 4, ..., a float4 a lane;
// rows past Skv are zero-filled.  One commit group.
template <int ST>
__device__ __forceinline__ void load_tile(const Params& p, float* dk,
                                          float* dv, const float* kb,
                                          const float* vb, int k0, int w) {
  const int lane = threadIdx.x & 31;
  if (lane < p.hd / 4) {
    for (int r = w; r < kKeys; r += kProducerWarps) {
      const bool ok = k0 + r < p.Skv;
      const long long row = ok ? k0 + r : 0;
      cp_async16(dk + r * ST + lane * 4, kb + row * p.k_ss + lane * 4, ok);
      cp_async16(dv + r * ST + lane * 4, vb + row * p.v_ss + lane * 4, ok);
    }
  }
  cp_async_commit();
}

// Split a landed tile, producer warp w's share: K rows w, w + 4, ... in
// place (big over the raw row, small into ksmall, row stride ST; lane =
// float4 chunk), and V chunks c = w, w + 4, ... (lane = key) from the raw
// V tile into vbig / vsmall transposed (row = column of V, stride kVST),
// key 8j + 2t at column 8j + t and key 8j + 2t + 1 at 8j + t + 4.
template <int ST>
__device__ __forceinline__ void split_tile(const Params& p, float* kbig,
                                           float* ksmall, const float* rv,
                                           float* vbig, float* vsmall,
                                           int w) {
  const int lane = threadIdx.x & 31;
  const int chunks = 2 * p.nk;             // float4s a row, hd8 / 4
  if (lane < chunks) {
#pragma unroll 2
    for (int r = w; r < kKeys; r += kProducerWarps) {
      const int at = r * ST + 4 * lane;
      const float4 x = *reinterpret_cast<const float4*>(kbig + at);
      uint4 big, small;
      split(x.x, big.x, small.x);
      split(x.y, big.y, small.y);
      split(x.z, big.z, small.z);
      split(x.w, big.w, small.w);
      *reinterpret_cast<uint4*>(kbig + at) = big;
      *reinterpret_cast<uint4*>(ksmall + at) = small;
    }
  }
  const int col = (lane & ~7) | ((lane & 1) << 2) | ((lane >> 1) & 3);
#pragma unroll 2
  for (int c = w; c < chunks; c += kProducerWarps) {
    const float4 x = *reinterpret_cast<const float4*>(rv + lane * ST + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t big, small;
      split(xs[e], big, small);
      vbig[(4 * c + e) * kVST + col] = __uint_as_float(big);
      vsmall[(4 * c + e) * kVST + col] = __uint_as_float(small);
    }
  }
}

// NK: k-steps of 8 columns compiled in; EXACT: NK == p.nk, else p.nk <= NK
// and the steps past p.nk are skipped.
template <int NK, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const Params p) {
  constexpr int ST = tile_stride(NK);
  constexpr int NP = (NK + 1) / 2;                  // n-tile pairs of P.V
  constexpr int KT = kKeys * ST;                    // a K tile, floats
  constexpr int VT = 16 * NP * kVST;                // a V^T tile, floats
  // Q, then split buffers u = 0, 1 (kbig = k_s + 2 u KT, ksmall = + KT;
  // vbig = v_s + 2 u VT, vsmall = + VT), then the raw V tile; raw K lands
  // in its buffer's kbig and is split in place
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                // kRows x ST
  float* k_s = q_s + kRows * ST;
  float* v_s = k_s + 4 * KT;
  float* raw_v = v_s + 4 * VT;
  FA_PHASE_BEGIN();

  const int tile = p.row_tiles - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;                  // fragment row group
  const int tq = lane & 3;                   // thread in the group
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
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (warp >= kWarps) {
    // The producers: tile t into split buffer (t - t_lo) % 2, once the
    // compute warps are done with tile t - 2 there.  Columns hd .. hd + 3
    // when hd % 8 == 4 are zeroed once in both kbig tiles and the raw V
    // tile (a copy never writes them), so they are zero in the split ones.
    const int w = warp - kWarps;
    if (p.hd % 8)
      for (int r = threadIdx.x - kWarps * 32; r < 3 * kKeys; r += kProducers)
        *reinterpret_cast<float4*>(
            (r < 2 * kKeys ? k_s + 2 * (r / kKeys) * KT + (r % kKeys) * ST
                           : raw_v + (r - 2 * kKeys) * ST) + p.hd) = zero;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int u = (t - t_lo) & 1;
      float* kbig = k_s + 2 * u * KT;
      if (t - t_lo >= 2) bar_sync(kBarFree + u, kThreads);
      load_tile<ST>(p, kbig, raw_v, kb, vb, t * kKeys, w);
      cp_async_wait_all();
      bar_sync(kBarProd, kProducers);        // landed for every producer
      split_tile<ST>(p, kbig, kbig + KT, raw_v, v_s + 2 * u * VT,
                     v_s + (2 * u + 1) * VT, w);
      bar_sync(kBarProd, kProducers);        // raw V read by every producer
      bar_arrive(kBarFull + u, kThreads);
    }
    return;
  }

  load_q<ST>(p, q_s, b, kvh, r0);
  cp_async_commit();
  if (p.hd % 8)
    for (int r = threadIdx.x; r < kRows; r += kWarps * 32)
      *reinterpret_cast<float4*>(q_s + r * ST + p.hd) = zero;
  cp_async_wait_all();
  bar_sync(kBarQ, kWarps * 32);

  // this thread's rows: Ra (fragment rows gr) and Rb = Ra + 8
  const int w_lo = r0 + warp * 16;
  const int Ra = w_lo + gr, Rb = Ra + 8;
  const int pos_a = Ra / p.G, pos_b = Rb / p.G;
  const bool warp_live = w_lo < rows_total;
  const int wp_lo = w_lo / p.G;
  const int wp_hi = (min(w_lo + 16, rows_total) - 1) / p.G;

  // O accumulator: o[n] = rows (gr, gr + 8) x columns (8 n + 2 tq, + 1)
  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;        // running max of rows a, b
  float l_a = 0.f, l_b = 0.f;                // this thread's share of l
  // ldmatrix rows: for B fragments lane l reads row 8 (l / 16) + l % 8,
  // columns + 4 ((l / 8) % 2), of a pair of 8-row blocks; for Q's A
  // fragment (rows gr, gr + 8 x columns tq, tq + 4) row 8 ((l / 8) % 2) +
  // l % 8, columns + 4 (l / 16) of the warp's 16 rows
  const int lm = 8 * (lane >> 4) + (lane & 7);
  const int lc = 4 * ((lane >> 3) & 1);
  const float* q_l =
      q_s + (warp * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * ST +
      4 * (lane >> 4);
  const float* kb_l = k_s + lm * ST + lc;
  const float* vb_l = v_s + lm * kVST + lc;
  FA_PHASE(0);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int u = (t - t_lo) & 1;
    bar_sync(kBarFull + u, kThreads);        // tile t split into buffer u
    FA_PHASE(1);
    const int k0 = t * kKeys, k1 = k0 + kKeys - 1;
    const float* kb_u = kb_l + 2 * u * KT;   // big; small at + KT
    const float* vb_u = vb_l + 2 * u * VT;   // big; small at + VT
    // a tile masked for every row of the warp adds nothing: skip it
    if (warp_live &&
        !(p.causal && (k0 > wp_hi ||
                       (p.window > 0 && wp_lo - k1 >= p.window)))) {
      // does any (row, key) pair of the warp's tile need the mask?
      const bool edge = k1 >= p.Skv ||
                        (p.causal && (k1 > wp_lo || (p.window > 0 &&
                                                     wp_hi - k0 >= p.window)));

      // S = Q . K^T: B fragments of n-tiles 2jp, 2jp + 1 by one ldmatrix4
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (!EXACT && kk >= p.nk) break;
        uint32_t qa[4], ab[4], as[4];
        ldmatrix4(qa, q_l + kk * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(qa[i]), ab[i], as[i]);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t bb[4], bs[4];
          ldmatrix4(bb, kb_u + jp * 16 * ST + kk * 8);
          ldmatrix4(bs, kb_u + KT + jp * 16 * ST + kk * 8);
          mma3(s[2 * jp], ab, as, bb, bs, 0);
          mma3(s[2 * jp + 1], ab, as, bb, bs, 1);
        }
      }
      FA_PHASE(2);

      // scale, mask (edge tiles only), online softmax
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
      if (edge) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * tq + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            bool ok = key < p.Skv;
            if (p.causal)
              ok = ok && pos >= key && (p.window <= 0 || pos - key < p.window);
            if (!ok) s[j][e] = kNegInf;
          }
      }
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float corr_a = ex2((m_a - mn_a) * kLog2e);
      const float corr_b = ex2((m_b - mn_b) * kLog2e);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = ex2((s[j][0] - mn_a) * kLog2e);
        s[j][1] = ex2((s[j][1] - mn_a) * kLog2e);
        s[j][2] = ex2((s[j][2] - mn_b) * kLog2e);
        s[j][3] = ex2((s[j][3] - mn_b) * kLog2e);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        o[n][0] *= corr_a;
        o[n][1] *= corr_a;
        o[n][2] *= corr_b;
        o[n][3] *= corr_b;
      }
      FA_PHASE(3);

      // O += P . V: the S accumulator of keys 8j .. 8j + 7 is the A
      // fragment (a0, a1, a2, a3) = (s0, s2, s1, s3); V^T's columns hold the
      // keys in the matching order; B fragments of n-tiles 2np, 2np + 1 by
      // one ldmatrix4
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ab[4], as[4];
        split(s[j][0], ab[0], as[0]);
        split(s[j][2], ab[1], as[1]);
        split(s[j][1], ab[2], as[2]);
        split(s[j][3], ab[3], as[3]);
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          if (!EXACT && 2 * np >= p.nk) break;
          uint32_t bb[4], bs[4];
          ldmatrix4(bb, vb_u + np * 16 * kVST + j * 8);
          ldmatrix4(bs, vb_u + VT + np * 16 * kVST + j * 8);
          mma3(o[2 * np], ab, as, bb, bs, 0);
          if (2 * np + 1 < NK && (EXACT || 2 * np + 1 < p.nk))
            mma3(o[2 * np + 1], ab, as, bb, bs, 1);
        }
      }
      FA_PHASE(4);
    }
    if (t + 2 <= t_hi) bar_arrive(kBarFree + u, kThreads);   // u free
    FA_PHASE(5);
  }

  // out = acc / max(l, 1e-37), l summed over the quad
  const float den_a = fmaxf(quad_sum(l_a), 1e-37f);
  const float den_b = fmaxf(quad_sum(l_b), 1e-37f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = half ? Rb : Ra;
    if (R >= rows_total) continue;
    const int pos = half ? pos_b : pos_a;
    const int h = kvh * p.G + (R - pos * p.G);
    float* orow = p.out + ((static_cast<long long>(b) * p.S + pos) * p.H + h) *
                              p.hd;
    const float den = half ? den_b : den_a;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c >= p.hd) break;                  // hd is a multiple of 4
      *reinterpret_cast<float2*>(orow + c) =
          make_float2(o[n][2 * half] / den, o[n][2 * half + 1] / den);
    }
  }
  FA_PHASE(6);
  FA_PHASE_END();
}

template <int NK, bool EXACT>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(NK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NK, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<NK, EXACT><<<grid, kThreads, smem, stream>>>(p);
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
  const int nk = (hd + 7) / 8;
  const int row_tiles = (S * G + kRows - 1) / kRows;
  const Params p{q, k, v, out, S, Skv, H, KV, G, hd, nk,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, scale, row_tiles};
  const dim3 grid(row_tiles, KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // exact builds for the configured families' head dims (64, 120, 128)
  switch (nk) {
    case 8: return launch<8, true>(p, grid, s);
    case 15: return launch<15, true>(p, grid, s);
    case 16: return launch<16, true>(p, grid, s);
    default:
      return nk < 8 ? launch<8, false>(p, grid, s)
                    : launch<16, false>(p, grid, s);
  }
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
