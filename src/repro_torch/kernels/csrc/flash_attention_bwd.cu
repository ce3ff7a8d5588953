// Backward of prefill attention (causal / sliding-window / cross,
// grouped-query) on Hopper (sm_90a), float32 in and out, every product on
// the tensor cores in split TF32 (3xTF32), deterministic (no atomics).
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
// - dkdv: a block a (key tile, KV head, b).  Its keys' raw K and V rows
//   stay in shared memory; it walks the query rows of its keys' causal /
//   window band, a tile at a time, and keeps dK and dV in registers to the
//   end;
// - dq: a block a (query row tile, KV head, b).  Its rows' raw Q and dO
//   stay in shared memory; it walks the key tiles its band reaches and
//   keeps dQ in registers.
// As in the forward, the rows of a KV head are its (position, head) pairs
// R = i * G + g, so the G query heads of a group share every tile.  Each
// output element is summed by one thread in one fixed order: reruns give
// the same bits.  dQ has a kernel of its own for that (no atomicAdd into
// dQ, no per-key-tile partials).
//
// Numerics: tf32_mma.cuh's split TF32, the forward's: every product is
// small . big + big . small + big . big on TF32 mma.sync, float32
// accumulators.  mma.sync truncates (its products cut to 2^-25 of the
// largest term, its sum to float32; tools/mma_rounding.cu), so nothing is
// summed onto a large running value inside it:
// - S and dP (sums over hd) are kept as hi + lo (`products`): each
//   k-step's big . big onto hi, then again onto what that add changed,
//   negated, which gives back what its truncation lost; that and the
//   small terms onto lo (`step_hi_lo`);
//   P = exp2((hi scale - lse + lo scale) log2e), dS = P ((dP_hi - delta) +
//   dP_lo) scale;
// - dV, dK and dQ (sums over S x G rows or Skv keys) add each k-step of 8
//   to the running sum by Fast2Sum, the step's products summed onto the
//   error the previous add left, the last error added at the end of the
//   tile (`accumulate`).
// At a trained layer's scores (to ~80) that keeps dq, dk and dv within
// atol = rtol = 2e-5 of the plain version in float64, where the float32
// plain version itself is not (tests/test_torch_attention_bwd_tf32.py
// models the arithmetic on the CPU, mma.sync's rounding included; plain
// TF32 misses that tolerance).
//
// What bounds it on this card: tensor-core operations.  At minicpm-2b's
// training shape (B 2, S 2048, 36 / 36 heads of 64, causal) dkdv takes
// four products of 2 hd flops a live (q, k) pair and dq three: 1.35e11
// flops, three times over in the split, 0.82 ms at 495 TFLOP/s (TF32
// dense), against 2.0 ms for the same flops on the FP32 FMA units and
// 0.13 GB of inputs and outputs (0.04 ms).  mma.sync reaches ~320 of the
// 495 TFLOP/s (tools/mma_rate.cu).
//
// What the design does about it:
// - mma.sync.m16n8k8 TF32, as the forward.  wgmma takes TF32 operands from
//   shared memory K-major only and multiplies 64-row warpgroup tiles: the
//   transposed operands (dO^T, Q^T, K^T) would still need copies of their
//   own, and a 64-key dK and dV at hd 128 would not fit a warpgroup's
//   registers.  mma.sync lets an accumulator feed the next product.
// - Keys are the M rows in dkdv: a warp owns 16 keys and computes S^T =
//   K . Q^T and dP^T = V . dO^T.  P^T and dS^T come out in accumulator
//   registers and feed dV += P^T . dO and dK += dS^T . Q as A operands
//   unchanged, through the key permutation of tf32_mma.cuh's `permuted`
//   (dO^T and Q^T are stored with their query columns in that order).  In
//   dq, a warp owns 16 rows and dS feeds dQ += dS . K the same way (K^T
//   key-permuted).  Nothing goes through shared memory between the
//   products and there is no block barrier inside a step.
// - A block is W compute warps and 4 producer warps.  The producers copy
//   the next streamed tile (Q and dO rows in dkdv, K and V rows in dq)
//   with cp.async into one of two buffers while the compute warps run the
//   other, and split it there once, not once a warp: raw rows split in
//   place into big copies, small copies beside them, and the transposed,
//   permuted big and small copies the second product reads.  Named
//   barriers hand each buffer over (full) and back (free; bar.arrive
//   alone: the compute warps only read it).  The block's own tile (K and
//   V in dkdv, Q and dO in dq) stays raw; a warp splits its A fragment at
//   use, as the forward does with Q.
// - Registers.  With more than 8 warps a block, a sub-partition holds 3
//   of them and its 16,384 registers cap every thread at 168, which
//   spilled dK / dV.  At NK <= 8 (12 warps) `setmaxnreg` moves registers
//   from the producer warpgroup (56 a thread, dq's 40) to the two compute
//   ones (224, dq's 232); the CTA's pool holds 12 x 168 = 2,016 a lane.
//   Fully unrolled, ptxas still hoisted a whole phase's loads and spilled
//   a few values: a run-time bound it cannot see past (never taken) on
//   each hd pair of dkdv's accumulate and each k-step of dq's keeps every
//   instance at 0 bytes of spill, at no measured cost.
// - Row strides are 4 mod 8 floats, so every ldmatrix phase (8 rows of 16
//   bytes) and every transposed store of a warp hit 32 distinct banks.
// - Longest bands first: dkdv's key tile 0 and dq's last row tile have the
//   longest causal bands and take the lowest blockIdx.x.  A warp skips a
//   tile masked for all of its rows (keys), and only tiles on the
//   diagonal, the window's edge or past Skv pay for the mask.  Rows past
//   S * G (and keys past Skv) are zero-filled: their Q and dO rows add
//   nothing to dK, dV (dO = 0, so dP = delta = 0) or dQ.
// - Instances are templates: NK k-steps of 8 columns (8, 15, 16 exact,
//   8 and 16 bounding the rest), no runtime branch on the width.  NK <= 8
//   runs 8 compute warps (128 owned keys or rows) and 32-row / 32-key
//   streamed tiles; NK > 8 runs 4 compute warps (255 registers without
//   setmaxnreg) and 16-row / 16-key tiles, S and dP one after the other,
//   so that dK and dV (128 registers a thread at hd 128) and the buffers
//   (209-217 KB) fit.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"   // split TF32 mma, ldmatrix, cp.async, barriers

// Per-phase clock64 stamps of the compute warps; a stamped copy of this
// source defines these (tools/time_attention.py --backward --phases).
// Here they compile to nothing.
#ifndef BWD_PHASE
#define BWD_PHASE_BEGIN()
#define BWD_PHASE(k)
#define BWD_PHASE_END()
#endif

namespace {

constexpr int kDeltaThreads = 256;
// named barriers (0 is __syncthreads): the block's own tile landed in the
// compute warps; buffer u full (kBarFull + u) and free (kBarFree + u);
// the producers' own
constexpr int kBarOwn = 1, kBarFull = 2, kBarFree = 4, kBarProd = 6;
constexpr float kLog2e = 1.4426950408889634f;

// The tiling of the dkdv (DQ false) or dq instance with NK k-steps of 8
// columns.  Each choice was measured on the card against its
// alternatives (PERF.md, the backward's findings).
template <int NK, bool DQ>
struct Tiling {
  static constexpr bool WIDE = NK <= 8;
  static constexpr int W = WIDE ? 8 : 4;         // compute warps
  static constexpr int kProducers = 128;         // four warps copy and split
  static constexpr int kThreads = W * 32 + kProducers;
  static constexpr int OWN = 16 * W;             // keys (dkdv) / rows (dq)
  static constexpr int T = WIDE ? 32 : 16;       // rows / keys streamed
  // S and dP one after the other (fewer live registers) past hd 64
  static constexpr bool SDP_SPLIT = !WIDE;
  // a run-time bound ptxas cannot see past, in the accumulate of the
  // exact instances: on each hd pair (dkdv) or on each k-step (dq); it
  // keeps ptxas from hoisting a whole phase's loads, which spilled
  static constexpr int ACC_GUARD = DQ ? 2 : 1;
  // setmaxnreg: the producer warpgroup keeps 56 registers a thread (dq's
  // 40), the two compute ones take 224 (232): 8 x 224 + 4 x 56 = 12 x 168,
  // the CTA's pool a lane
  static constexpr bool REGS = WIDE;
  static constexpr int COMPUTE_REGS = DQ ? 232 : 224;
  static constexpr int PRODUCER_REGS = DQ ? 40 : 56;
  static constexpr int NT = T / 8;               // n-tiles of a step's S
  static constexpr int NP = (NK + 1) / 2;        // pairs of hd n-tiles
  static constexpr int ST = 8 * NK + 4;          // row-major row stride
  static constexpr int TS = T + 4;               // transposed row stride
  static constexpr int RT = T * ST;              // a row-major tile
  static constexpr int TT = 16 * NP * TS;        // a transposed tile
  // dkdv's buffer: Q and dO big / small row-major, Q^T and dO^T big /
  // small, lse and delta of the rows
  static constexpr int DKDV_BUF = 4 * RT + 4 * TT + 2 * T;
  // dq's buffer: K and V big / small row-major, K^T big / small
  static constexpr int DQ_BUF = 4 * RT + 2 * TT;
  static constexpr int DKDV_FLOATS = 2 * OWN * ST + 2 * DKDV_BUF;
  static constexpr int DQ_FLOATS = 2 * OWN * ST + 2 * DQ_BUF;
};

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
  int S, Skv, H, KV, G, hd;
  int nk;              // k-steps of 8 columns: ceil(hd / 8)
  int causal, window;
  float scale;
};

// Offset (floats) of row R = i * G + g of KV head kvh in a (B, S, H, hd)
// tensor; rows past S * G give row 0 (never read: the copy zero-fills).
__device__ __forceinline__ long long row_offset(const Params& p, int b,
                                                int kvh, int R) {
  const bool ok = R < p.S * p.G;
  const int pos = ok ? R / p.G : 0;
  const int g = ok ? R - pos * p.G : 0;
  return ((static_cast<long long>(b) * p.S + pos) * p.H + kvh * p.G + g) *
         p.hd;
}

// Start copying `rows` rows of a and c into da / dc (row stride ST): rows
// R0 + r of a KV head's (position, head) rows when `by_head`, else keys
// R0 + r of (B, Skv, KV, hd) tensors; warp w of `warps` copies rows w, w +
// warps, ..., a float4 a lane; rows past the end are zero-filled.
template <int ST>
__device__ __forceinline__ void copy_rows(const Params& p, float* da,
                                          float* dc, const float* a,
                                          const float* c, int b, int kvh,
                                          int R0, int rows, bool by_head,
                                          int w, int warps) {
  const int lane = threadIdx.x & 31;
  if (lane >= p.hd / 4) return;
  const int end = by_head ? p.S * p.G : p.Skv;
  for (int r = w; r < rows; r += warps) {
    const int R = R0 + r;
    const bool ok = R < end;
    const long long off =
        by_head ? row_offset(p, b, kvh, R)
                : ((static_cast<long long>(b) * p.Skv + (ok ? R : 0)) * p.KV +
                   kvh) * p.hd;
    cp_async16(da + r * ST + 4 * lane, a + off + 4 * lane, ok);
    cp_async16(dc + r * ST + 4 * lane, c + off + 4 * lane, ok);
  }
}

// Zero columns hd .. hd + 3 (hd % 8 == 4) of `rows` rows at `at` (row
// stride ST): a copy never writes them, and the products read them.
template <int ST>
__device__ __forceinline__ void zero_pad(const Params& p, float* at,
                                         int rows, int i0, int n) {
  for (int r = i0; r < rows; r += n)
    *reinterpret_cast<float4*>(at + r * ST + p.hd) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// Split one float4 of a landed row in place: big over the raw values,
// small at the same place of `small`; with `tbig` non-null also into the
// transposed copies (row = column of the tile, stride TS), at the
// permuted column the caller points them at.
template <int TS>
__device__ __forceinline__ void split4(float* big, float* small, float* tbig,
                                       float* tsmall) {
  const float4 x = *reinterpret_cast<const float4*>(big);
  uint4 b4, s4;
  split(x.x, b4.x, s4.x);
  split(x.y, b4.y, s4.y);
  split(x.z, b4.z, s4.z);
  split(x.w, b4.w, s4.w);
  *reinterpret_cast<uint4*>(big) = b4;
  *reinterpret_cast<uint4*>(small) = s4;
  if (tbig) {
    tbig[0] = __uint_as_float(b4.x);
    tbig[TS] = __uint_as_float(b4.y);
    tbig[2 * TS] = __uint_as_float(b4.z);
    tbig[3 * TS] = __uint_as_float(b4.w);
    tsmall[0] = __uint_as_float(s4.x);
    tsmall[TS] = __uint_as_float(s4.y);
    tsmall[2 * TS] = __uint_as_float(s4.z);
    tsmall[3 * TS] = __uint_as_float(s4.w);
  }
}

// A fragments of the warp's 16 rows of a raw tile (stride ST) at k-step
// kk, split at use: lane l reads row 8 ((l / 8) % 2) + l % 8, columns + 4
// (l / 16), so register i is (rows gr, gr + 8 x columns tq, tq + 4).
__device__ __forceinline__ void a_split(const float* at, uint32_t (&ab)[4],
                                        uint32_t (&as)[4]) {
  uint32_t raw[4];
  ldmatrix4(raw, at);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(raw[i]), ab[i], as[i]);
}

// An accumulator (rows gr, gr + 8 x columns 2tq, 2tq + 1 of a k-step of 8)
// as the A operand of a product summed over those columns: (d0, d2, d1,
// d3), split.
__device__ __forceinline__ void acc_as_a(const float (&d)[4],
                                         uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
  split(d[0], ab[0], as[0]);
  split(d[2], ab[1], as[1]);
  split(d[1], ab[2], as[2]);
  split(d[3], ab[3], as[3]);
}

// One k-step of a product kept as hi + lo (products below): the two
// small terms onto lo; big . big onto hi, t = hi + a . b (truncated at
// hi's scale); then big . big again onto hi - t (exact: t is near hi),
// which leaves the step's products, cut only at their own scale, less
// what t took of them; that onto lo, and t is the new hi.  h: n-tile of
// a pair.
__device__ __forceinline__ void step_hi_lo(float (&hi)[4], float (&lo)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[4],
                                           const uint32_t (&bs)[4], int h) {
  mma(lo, as, bb[2 * h], bb[2 * h + 1]);
  mma(lo, ab, bs[2 * h], bs[2 * h + 1]);
  float t[4] = {hi[0], hi[1], hi[2], hi[3]};
  mma(t, ab, bb[2 * h], bb[2 * h + 1]);
  float e[4] = {hi[0] - t[0], hi[1] - t[1], hi[2] - t[2], hi[3] - t[3]};
  mma(e, ab, bb[2 * h], bb[2 * h + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] += e[i];
    hi[i] = t[i];
  }
}

// s (16 rows x T) = A . B^T and dp = C . D^T over NK k-steps of 8, each
// as hi + lo (s + sl, dp + dpl): A, C the warp's 16 rows of raw tiles
// (a_at into them), split at use; B, D row-major split tiles (big at b /
// d, small at + RT), a pair of n-tiles an ldmatrix4 each.  SPLIT: the two
// products one after the other (fewer live registers), else in one pass
// over the k-steps.
//
// mma.sync rounds as tools/mma_rounding.cu measured on the card: its 8
// products and C are aligned to the largest exponent, each cut to 2^-25
// of it, summed, and the sum truncated to float32.  Summed onto a running
// value, at a trained layer's scores (to ~80) that biased S, so P, by
// several ulps of S: dv 1.7x its tolerance from float64 (PERF.md, the
// backward's findings).  Here a second big . big product gives back what
// the first one's truncation at the running value's scale lost
// (step_hi_lo): what is left is the cut of products 2^-5 and more below
// the sum of their k-step.
template <int NK, int NT, int ST, int RT, bool SPLIT, bool EXACT>
__device__ __forceinline__ void products(float (&s)[NT][4],
                                         float (&sl)[NT][4],
                                         float (&dp)[NT][4],
                                         float (&dpl)[NT][4],
                                         const float* a, const float* b,
                                         const float* c, const float* d,
                                         int lm, int lc, const Params& p) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = dp[j][e] = dpl[j][e] = 0.f;
#pragma unroll
  for (int pass = 0; pass < (SPLIT ? 2 : 1); ++pass) {
    const bool do_s = !SPLIT || pass == 0, do_dp = !SPLIT || pass == 1;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (!EXACT && kk >= p.nk) break;
      uint32_t ab[4], as[4], cb[4], cs[4];
      if (do_s) a_split(a + kk * 8, ab, as);
      if (do_dp) a_split(c + kk * 8, cb, cs);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int at = (jp * 16 + lm) * ST + lc + kk * 8;
        uint32_t bb[4], bs[4];
        if (do_s) {
          ldmatrix4(bb, b + at);
          ldmatrix4(bs, b + RT + at);
          step_hi_lo(s[2 * jp], sl[2 * jp], ab, as, bb, bs, 0);
          step_hi_lo(s[2 * jp + 1], sl[2 * jp + 1], ab, as, bb, bs, 1);
        }
        if (do_dp) {
          ldmatrix4(bb, d + at);
          ldmatrix4(bs, d + RT + at);
          step_hi_lo(dp[2 * jp], dpl[2 * jp], cb, cs, bb, bs, 0);
          step_hi_lo(dp[2 * jp + 1], dpl[2 * jp + 1], cb, cs, bb, bs, 1);
        }
      }
    }
  }
}

// d += a . b as mma3, compensated (Fast2Sum): the step's products are
// summed onto the rounding error `e` that the previous step's add onto d
// left, then added to d, and the error of that add is kept in e.
__device__ __forceinline__ void mma3_comp(float (&d)[4], float (&e)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[4],
                                          const uint32_t (&bs)[4], int h) {
  float t[4] = {e[0], e[1], e[2], e[3]};
  mma3(t, ab, as, bb, bs, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = d[i] + t[i];
    e[i] = t[i] - (s - d[i]);
    d[i] = s;
  }
}

// d (rows x hd) += a . B over a tile's NT k-steps of 8 of a's columns: a
// is an accumulator of NT n-tiles fed as A operands (acc_as_a, split
// once); B is read from a transposed tile (big at bt, small at bt + TT)
// whose columns hold a's columns in `permuted` order, a pair of hd
// n-tiles an ldmatrix4 each.  For each pair, the k-steps' split products
// are added to d compensated (mma3_comp) and the error left is added at
// the end of the tile: d takes one rounding a tile instead of one a
// k-step.  GUARD (exact instances): a run-time bound on each hd pair (1)
// or each k-step (2) that is never taken.
template <int NK, int NT, int NP, int TS, bool EXACT, int GUARD>
__device__ __forceinline__ void accumulate(float (&d)[NK][4],
                                           const float (&a)[NT][4],
                                           const float* bt, int TT, int lm,
                                           int lc, const Params& p) {
  uint32_t ab[NT][4], as[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc_as_a(a[j], ab[j], as[j]);
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    if ((!EXACT || GUARD == 1) && 2 * np >= p.nk) break;
    const bool odd = 2 * np + 1 < NK && (EXACT || 2 * np + 1 < p.nk);
    float e0[4] = {0.f, 0.f, 0.f, 0.f}, e1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (GUARD == 2 && j >= NT + p.nk) break;
      const int at = (np * 16 + lm) * TS + lc + j * 8;
      uint32_t bb[4], bs[4];
      ldmatrix4(bb, bt + at);
      ldmatrix4(bs, bt + TT + at);
      mma3_comp(d[2 * np], e0, ab[j], as[j], bb, bs, 0);
      if (odd) mma3_comp(d[2 * np + 1], e1, ab[j], as[j], bb, bs, 1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[2 * np][i] += e0[i];
      if (odd) d[2 * np + 1][i] += e1[i];
    }
  }
}

// (hi + lo) scale - lse, the exponent of P: hi scale - lse rounded once
// (small where P is not), then lo's share
__device__ __forceinline__ float logit(float hi, float lo, float lse,
                                       float scale) {
  return fmaf(lo, scale, fmaf(hi, scale, -lse));
}

__device__ __forceinline__ bool live(const Params& p, int pos, int key) {
  bool ok = key < p.Skv;
  if (p.causal)
    ok = ok && pos >= key && (p.window <= 0 || pos - key < p.window);
  return ok;
}

// The compute warps hand buffer u back.  They only read it, and bar.arrive
// orders this thread's earlier shared-memory accesses before the barrier
// completes (PTX ISA): bar_arrive's fence cost 1-2% here.
__device__ __forceinline__ void hand_back(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// blockIdx.x read again, a value the compiler cannot carry over from
// before a loop (which would hold a register, or spill, through it)
__device__ __forceinline__ int ctaid_x() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

// Hand registers back (producers) or take them (compute warps), a whole
// warpgroup at once.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__global__ void __launch_bounds__(kDeltaThreads)
flash_attention_bwd_delta_kernel(const float* dout, const float* out,
                                 float* delta, int S, int H, int hd,
                                 long long rows) {
  const long long r = (static_cast<long long>(blockIdx.x) * kDeltaThreads +
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

// NK: k-steps of 8 columns compiled in; EXACT: NK == p.nk, else p.nk <= NK
// and the steps past p.nk are skipped.
template <int NK, bool EXACT>
__global__ void __launch_bounds__(Tiling<NK, false>::kThreads, 1)
flash_attention_bwd_dkdv_kernel(const Params p) {
  using C = Tiling<NK, false>;
  constexpr int W = C::W, T = C::T, NT = C::NT, NP = C::NP;
  constexpr int ST = C::ST, TS = C::TS, RT = C::RT, TT = C::TT;
  constexpr int BUF = C::DKDV_BUF;
  // the block's raw K and V rows, then buffers u = 0, 1 at buf + u BUF:
  // Q big (raw Q lands there and is split in place), Q small, dO big, dO
  // small (RT each), Q^T big, Q^T small, dO^T big, dO^T small (TT each),
  // lse, delta (T each)
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + C::OWN * ST;
  float* buf = v_s + C::OWN * ST;

  const int k0 = blockIdx.x * C::OWN;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_total = p.S * p.G;
  const int nk = EXACT ? NK : p.nk;

  // the row tiles this key tile's band reaches: when causal, positions
  // k0 .. min(S, last key + window) - 1
  int r_lo = 0, r_hi = rows_total - 1;
  if (p.causal) {
    r_lo = k0 * p.G;
    if (p.window > 0) {
      const long long last = min(static_cast<long long>(p.S) - 1,
                                 min(k0 + C::OWN, p.Skv) - 2LL + p.window);
      r_hi = static_cast<int>((last + 1) * p.G - 1);
    }
  }
  const int t_lo = r_lo / T, t_hi = r_hi / T;

  if (warp >= W) {
    if constexpr (C::REGS) regs_dec<C::PRODUCER_REGS>();
    // The producers: row tile t into buffer (t - t_lo) % 2, once the
    // compute warps are done with tile t - 2 there.
    const int pt = threadIdx.x - W * 32;
    if (p.hd % 8)
      for (int u = 0; u < 2; ++u)
        for (int m = 0; m < 2; ++m)
          zero_pad<ST>(p, buf + u * BUF + 2 * m * RT, T, pt,
                       C::kProducers);
    for (int t = t_lo; t <= t_hi; ++t) {
      const int u = (t - t_lo) & 1;
      float* qb = buf + u * BUF;
      float* dob = qb + 2 * RT;
      float* qtb = qb + 4 * RT;
      float* lse_s = qtb + 4 * TT;
      if (t - t_lo >= 2) bar_sync(kBarFree + u, C::kThreads);
      copy_rows<ST>(p, qb, dob, p.q, p.dout, b, kvh, t * T, T, true,
                    warp - W, C::kProducers / 32);
      cp_async_commit();
      for (int i = pt; i < T; i += C::kProducers) {
        const int R = t * T + i;
        float l = 0.f, d = 0.f;
        if (R < rows_total) {
          const int pos = R / p.G;
          const long long at =
              (static_cast<long long>(b) * p.H + kvh * p.G + R - pos * p.G) *
                  p.S + pos;
          l = p.lse[at];
          d = p.delta[at];
        }
        lse_s[i] = l;
        lse_s[T + i] = d;
      }
      cp_async_wait_all();
      bar_sync(kBarProd, C::kProducers);     // landed for every producer
      // item (row r, float4 c): lanes take consecutive rows; Q, then dO
      for (int m = 0; m < 2; ++m)
        for (int i = pt; i < T * 2 * nk; i += C::kProducers) {
          const int r = i % T, c = i / T;
          const int at = 2 * m * RT + r * ST + 4 * c;
          const int tat = 2 * m * TT + 4 * c * TS + permuted(r);
          split4<TS>(qb + at, qb + RT + at, qtb + tat, qtb + TT + tat);
        }
      bar_arrive(kBarFull + u, C::kThreads);
    }
    return;
  }

  if constexpr (C::REGS) regs_inc<C::COMPUTE_REGS>();
  // the block's K and V rows, raw
  copy_rows<ST>(p, k_s, v_s, p.k, p.v, b, kvh, k0, C::OWN, false, warp, W);
  cp_async_commit();
  if (p.hd % 8) {
    zero_pad<ST>(p, k_s, C::OWN, threadIdx.x, W * 32);
    zero_pad<ST>(p, v_s, C::OWN, threadIdx.x, W * 32);
  }
  cp_async_wait_all();
  bar_sync(kBarOwn, W * 32);
  BWD_PHASE_BEGIN();

  const int gr = lane >> 2, tq = lane & 3;
  const int kw0 = k0 + warp * 16;            // the warp's first key
  const bool warp_live = kw0 < p.Skv;
  const int key_a = kw0 + gr, key_b = key_a + 8;
  // A fragments: the warp's K and V rows; B fragments: lane l reads row
  // 8 (l / 16) + l % 8, columns + 4 ((l / 8) % 2) of a pair of n-tiles
  const int a_at = (warp * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * ST +
                   4 * (lane >> 4);
  const int lm = 8 * (lane >> 4) + (lane & 7);
  const int lc = 4 * ((lane >> 3) & 1);

  // dK, dV: keys (gr, gr + 8) x columns (8 n + 2 tq, + 1)
  float dk[NK][4], dv[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int u = (t - t_lo) & 1;
    bar_sync(kBarFull + u, C::kThreads);     // tile t split into buffer u
    BWD_PHASE(0);
    const float* qb = buf + u * BUF;
    const float* qtb = qb + 4 * RT;
    const float* lse_s = qtb + 4 * TT;
    const int r0 = t * T;
    const int pos_lo = r0 / p.G;
    const int pos_hi = (min(r0 + T, rows_total) - 1) / p.G;
    // a tile masked for every key of the warp adds nothing: skip it
    if (warp_live &&
        !(p.causal && (pos_hi < kw0 ||
                       (p.window > 0 && pos_lo - (kw0 + 15) >= p.window)))) {
      // does any (row, key) pair of the warp's tile need the mask?
      const bool edge = kw0 + 15 >= p.Skv ||
                        (p.causal && (kw0 + 15 > pos_lo ||
                                      (p.window > 0 &&
                                       pos_hi - kw0 >= p.window)));

      // S^T = K . Q^T and dP^T = V . dO^T: keys x rows
      float s[NT][4], dp[NT][4], sl[NT][4], dpl[NT][4];
      products<NK, NT, ST, RT, C::SDP_SPLIT, EXACT>(
          s, sl, dp, dpl, k_s + a_at, qb, v_s + a_at, qb + 2 * RT, lm, lc,
          p);
      BWD_PHASE(1);

      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale; the
      // thread's rows are 8 j + 2 tq (+ 1)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tq);
        const float2 d2 =
            *reinterpret_cast<const float2*>(lse_s + T + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = e & 1 ? l2.y : l2.x;
          const float d = e & 1 ? d2.y : d2.x;
          float pe = ex2(logit(s[j][e], sl[j][e], l, p.scale) * kLog2e);
          if (edge) {
            const int R = r0 + 8 * j + 2 * tq + (e & 1);
            if (!live(p, R / p.G, e < 2 ? key_a : key_b)) pe = 0.f;
          }
          s[j][e] = pe;
          dp[j][e] = pe * ((dp[j][e] - d) + dpl[j][e]) * p.scale;
        }
      }
      BWD_PHASE(2);

      // dV += P^T . dO, then dK += dS^T . Q, a k-step of 8 rows at a
      // time: the accumulators are the A operands; dO^T and Q^T hold the
      // rows in the matching order
      accumulate<NK, NT, NP, TS, EXACT, C::ACC_GUARD>(dv, s, qtb + 2 * TT,
                                                     TT, lm, lc, p);
      accumulate<NK, NT, NP, TS, EXACT, C::ACC_GUARD>(dk, dp, qtb, TT, lm,
                                                     lc, p);
      BWD_PHASE(3);
    }
    if (t + 2 <= t_hi) hand_back(kBarFree + u, C::kThreads);    // u free
    BWD_PHASE(4);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key_b : key_a;
    if (key >= p.Skv) continue;
    const long long row =
        ((static_cast<long long>(b) * p.Skv + key) * p.KV + kvh) * p.hd;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c >= p.hd) break;                  // hd is a multiple of 4
      *reinterpret_cast<float2*>(p.dk + row + c) =
          make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<float2*>(p.dv + row + c) =
          make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
  BWD_PHASE(5);
  BWD_PHASE_END();
}

template <int NK, bool EXACT>
__global__ void __launch_bounds__(Tiling<NK, true>::kThreads, 1)
flash_attention_bwd_dq_kernel(const Params p) {
  using C = Tiling<NK, true>;
  constexpr int W = C::W, T = C::T, NT = C::NT, NP = C::NP;
  constexpr int ST = C::ST, TS = C::TS, RT = C::RT, TT = C::TT;
  constexpr int BUF = C::DQ_BUF;
  // the block's raw Q and dO rows, then buffers u = 0, 1 at buf + u BUF:
  // K big (raw K lands there and is split in place), K small, V big, V
  // small (RT each), K^T big, K^T small (TT each)
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + C::OWN * ST;
  float* buf = do_s + C::OWN * ST;

  const int row_tiles = (p.S * p.G + C::OWN - 1) / C::OWN;
  const int tile = row_tiles - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_total = p.S * p.G;
  const int nk = EXACT ? NK : p.nk;
  const int r0 = tile * C::OWN;
  const int p_lo = r0 / p.G;
  const int p_hi = (min(r0 + C::OWN, rows_total) - 1) / p.G;

  // the key tiles this block's band reaches
  int t_lo = 0;
  int t_hi = (p.Skv - 1) / T;
  if (p.causal) {
    t_hi = min(p_hi, p.Skv - 1) / T;
    if (p.window > 0) t_lo = max(p_lo - p.window + 1, 0) / T;
  }

  if (warp >= W) {
    if constexpr (C::REGS) regs_dec<C::PRODUCER_REGS>();
    // The producers: key tile t into buffer (t - t_lo) % 2
    const int pt = threadIdx.x - W * 32;
    if (p.hd % 8)
      for (int u = 0; u < 2; ++u)
        for (int m = 0; m < 2; ++m)
          zero_pad<ST>(p, buf + u * BUF + 2 * m * RT, T, pt,
                       C::kProducers);
    for (int t = t_lo; t <= t_hi; ++t) {
      const int u = (t - t_lo) & 1;
      float* kb = buf + u * BUF;
      float* vb = kb + 2 * RT;
      float* ktb = kb + 4 * RT;
      if (t - t_lo >= 2) bar_sync(kBarFree + u, C::kThreads);
      copy_rows<ST>(p, kb, vb, p.k, p.v, b, kvh, t * T, T, false, warp - W,
                    C::kProducers / 32);
      cp_async_commit();
      cp_async_wait_all();
      bar_sync(kBarProd, C::kProducers);     // landed for every producer
      // K (with its transposed copies), then V
      for (int i = pt; i < T * 2 * nk; i += C::kProducers) {
        const int r = i % T, c = i / T;
        const int at = r * ST + 4 * c, tat = 4 * c * TS + permuted(r);
        split4<TS>(kb + at, kb + RT + at, ktb + tat, ktb + TT + tat);
      }
      for (int i = pt; i < T * 2 * nk; i += C::kProducers) {
        const int at = i % T * ST + 4 * (i / T);
        split4<TS>(vb + at, vb + RT + at, nullptr, nullptr);
      }
      bar_arrive(kBarFull + u, C::kThreads);
    }
    return;
  }

  if constexpr (C::REGS) regs_inc<C::COMPUTE_REGS>();
  copy_rows<ST>(p, q_s, do_s, p.q, p.dout, b, kvh, r0, C::OWN, true, warp,
                W);
  cp_async_commit();
  if (p.hd % 8) {
    zero_pad<ST>(p, q_s, C::OWN, threadIdx.x, W * 32);
    zero_pad<ST>(p, do_s, C::OWN, threadIdx.x, W * 32);
  }

  // this thread's rows: Ra (fragment rows gr) and Rb = Ra + 8
  const int gr = lane >> 2, tq = lane & 3;
  const int w_lo = r0 + warp * 16;
  const int Ra = w_lo + gr, Rb = Ra + 8;
  const int pos_a = Ra / p.G, pos_b = Rb / p.G;
  const bool warp_live = w_lo < rows_total;
  const int wp_lo = w_lo / p.G;
  const int wp_hi = (min(w_lo + 16, rows_total) - 1) / p.G;
  float lse_a = 0.f, lse_b = 0.f, del_a = 0.f, del_b = 0.f;
  if (Ra < rows_total) {
    const long long at = (static_cast<long long>(b) * p.H + kvh * p.G +
                          Ra - pos_a * p.G) * p.S + pos_a;
    lse_a = p.lse[at];
    del_a = p.delta[at];
  }
  if (Rb < rows_total) {
    const long long at = (static_cast<long long>(b) * p.H + kvh * p.G +
                          Rb - pos_b * p.G) * p.S + pos_b;
    lse_b = p.lse[at];
    del_b = p.delta[at];
  }
  cp_async_wait_all();
  bar_sync(kBarOwn, W * 32);
  BWD_PHASE_BEGIN();

  const int a_at = (warp * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * ST +
                   4 * (lane >> 4);
  const int lm = 8 * (lane >> 4) + (lane & 7);
  const int lc = 4 * ((lane >> 3) & 1);

  // dQ: rows (gr, gr + 8) x columns (8 n + 2 tq, + 1)
  float dq[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int u = (t - t_lo) & 1;
    bar_sync(kBarFull + u, C::kThreads);     // tile t split into buffer u
    BWD_PHASE(0);
    const float* kb = buf + u * BUF;
    const float* ktb = kb + 4 * RT;
    const int k0 = t * T, k1 = k0 + T - 1;
    if (warp_live &&
        !(p.causal && (k0 > wp_hi ||
                       (p.window > 0 && wp_lo - k1 >= p.window)))) {
      const bool edge = k1 >= p.Skv ||
                        (p.causal && (k1 > wp_lo || (p.window > 0 &&
                                                     wp_hi - k0 >= p.window)));

      // S = Q . K^T and dP = dO . V^T: rows x keys
      float s[NT][4], dp[NT][4], sl[NT][4], dpl[NT][4];
      products<NK, NT, ST, RT, C::SDP_SPLIT, EXACT>(
          s, sl, dp, dpl, q_s + a_at, kb, do_s + a_at, kb + 2 * RT, lm, lc,
          p);
      BWD_PHASE(1);

      // P = exp(S scale - lse), dS = P (dP - delta) scale; the thread's
      // keys are k0 + 8 j + 2 tq (+ 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool a = e < 2;
          float pe = ex2(logit(s[j][e], sl[j][e], a ? lse_a : lse_b,
                               p.scale) * kLog2e);
          if (edge &&
              !live(p, a ? pos_a : pos_b, k0 + 8 * j + 2 * tq + (e & 1)))
            pe = 0.f;
          dp[j][e] = pe * ((dp[j][e] - (a ? del_a : del_b)) + dpl[j][e]) *
                     p.scale;
        }
      BWD_PHASE(2);

      // dQ += dS . K, a k-step of 8 keys at a time: dS is the A operand;
      // K^T holds the keys in the matching order
      accumulate<NK, NT, NP, TS, EXACT, C::ACC_GUARD>(dq, dp, ktb, TT, lm, lc,
                                                     p);
      BWD_PHASE(3);
    }
    if (t + 2 <= t_hi) hand_back(kBarFree + u, C::kThreads);    // u free
    BWD_PHASE(4);
  }

  // the rows again from the block index, so that Ra need not live
  // through the loop
  const int Re = (row_tiles - 1 - ctaid_x()) * C::OWN + warp * 16 + gr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = Re + 8 * half;
    if (R >= rows_total) continue;
    float* row = p.dq + row_offset(p, b, kvh, R);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c >= p.hd) break;                  // hd is a multiple of 4
      *reinterpret_cast<float2*>(row + c) =
          make_float2(dq[n][2 * half], dq[n][2 * half + 1]);
    }
  }
  BWD_PHASE(5);
  BWD_PHASE_END();
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, dim3 grid, int threads,
           int floats, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch the dkdv (grid: key tiles x KV x B) or the dq kernel (grid: row
// tiles x KV x B) of the instance for p.nk.
template <int NK, bool EXACT>
int launch_instance(bool dkdv, const Params& p, int B, cudaStream_t s) {
  using K = Tiling<NK, false>;
  using Q = Tiling<NK, true>;
  static_assert(K::DKDV_FLOATS * 4 <= 232448 && Q::DQ_FLOATS * 4 <= 232448,
                "a block's shared memory is at most 227 KB");
  if (dkdv)
    return launch(flash_attention_bwd_dkdv_kernel<NK, EXACT>, p,
                  dim3((p.Skv + K::OWN - 1) / K::OWN, p.KV, B), K::kThreads,
                  K::DKDV_FLOATS, s);
  return launch(flash_attention_bwd_dq_kernel<NK, EXACT>, p,
                dim3((p.S * p.G + Q::OWN - 1) / Q::OWN, p.KV, B),
                Q::kThreads, Q::DQ_FLOATS, s);
}

// exact builds for the configured families' head dims (64, 120, 128)
int dispatch(bool dkdv, const Params& p, int B, cudaStream_t s) {
  switch (p.nk) {
    case 8: return launch_instance<8, true>(dkdv, p, B, s);
    case 15: return launch_instance<15, true>(dkdv, p, B, s);
    case 16: return launch_instance<16, true>(dkdv, p, B, s);
    default:
      return p.nk < 8 ? launch_instance<8, false>(dkdv, p, B, s)
                      : launch_instance<16, false>(dkdv, p, B, s);
  }
}

int check_shape(int B, int S, int Skv, int H, int KV, int hd, int causal) {
  if (hd < 4 || hd > 128 || hd % 4) return -1;
  if (KV < 1 || H % KV) return -2;
  if (B < 1 || B > 65535 || H > 65535 || KV > 65535 || S < 1 || Skv < 1)
    return -3;
  if (static_cast<long long>(S) * (H / KV) > (1LL << 30)) return -3;
  if (causal && Skv != S) return -4;
  return 0;
}

Params make_params(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dq, float* dk, float* dv, int S, int Skv, int H,
                   int KV, int hd, int causal, int window, float scale) {
  return Params{q, k, v, dout, lse, delta, dq, dk, dv, S, Skv, H, KV,
                H / KV, hd, (hd + 7) / 8, causal, window, scale};
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
  const long long blocks = (rows * 32 + kDeltaThreads - 1) / kDeltaThreads;
  if (blocks > 0x7fffffffLL) return -3;
  flash_attention_bwd_delta_kernel<<<static_cast<unsigned>(blocks),
                                     kDeltaThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
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
  return dispatch(true, p, B, static_cast<cudaStream_t>(stream));
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
  return dispatch(false, p, B, static_cast<cudaStream_t>(stream));
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
