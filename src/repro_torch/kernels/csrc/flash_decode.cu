// Single-token grouped-query decode attention on Hopper (sm_90a), one
// (batch row, kv head) split over a thread-block cluster.
//
// Replaces the Pallas kernel of the JAX package's kernels/flash_decode.py:
// `_decode_kernel` behind `flash_decode_tpu`.  Same function: for each
// batch row b and query head h = kv * G + g, softmax(q . K^T * hd^-0.5)
// over the first n_valid cache slots, times V, plus the max m and sum l of
// the softmax (for a cross-shard merge).  Keys at pos >= n_valid are
// masked to -1e30 (here: never read), and out = acc / max(l, 1e-37).
// float32 throughout.
//
// What bounds it on this card: device-memory bytes.  Every valid key and
// value row is read once, 2 * B * n_valid * KV * hd * 4 bytes (15.7 MB at
// the serving shape B = 4, n_valid = 512, KV = 8, hd = 120: 4.7 us at
// 3.35 TB/s); the arithmetic is 4 flops per byte read at most.
//
// What the design does about it: the key axis of each (b, kv head) is
// split over a cluster of S <= 16 CTAs (the wrapper's split_plan: about 64
// rows a CTA), so B * KV * S CTAs stream the cache at once (256 at the
// serving shape, where one CTA per (b, kv head) gave 32 on 132 SMs).  CTA
// rank r owns the key rows [r * rows, (r + 1) * rows) of the valid slots
// and reads them in place through the cache's strides, in chunks of up to
// 64 rows whose keys and values are all put in flight with cp.async before
// the first wait; a later chunk's keys stream in while this chunk's values
// are used.  Four barriers a chunk, and each phase reads shared memory as
// little as it can: scores with no warp reduction (a thread takes one key
// row and a quarter of hd's columns for every head, so a key row is read
// once and q is one address across a warp; key rows are stored at an odd
// number of float4s, so 8 rows at one column hit 8 bank groups), an online
// softmax (one warp per head, adding the quarters' partial scores), and
// p . V (a thread per (4 heads, 4 output columns), over a subset of the
// rows when there are fewer of those than threads, so a value row is read
// once per 4 heads).  The partials (m, l, unnormalised acc) are merged in
// distributed shared memory: rank r owns a slice of the G * hd outputs,
// every rank stores its share of that slice and its (m, l) into rank r's
// inbox (remote stores do not wait), one cluster barrier, then each rank
// merges its inbox in rank order as the reference's combine_partials does
// (m = max m_x, w_x = exp(m_x - m), l = sum w_x l_x, out = sum w_x acc_x /
// max(l, 1e-37)).  No CTA reads another's memory after that barrier, so
// none has to wait for the others to exit; a CTA waits for all of its
// cluster to have started before its first remote store.  G is a run-time
// value: kernels are compiled for G_MAX in {1, 2, 4, 8, 16} and a group
// runs in the smallest G_MAX >= G.  hd need not be a power of two (120
// floats are 30 float4 lanes); it must be a multiple of 4 with 16-byte
// aligned rows and at most 512, which the wrapper checks.
//
// The int8 instance (Q8 = true; the wrapper's flash_decode_int8) reads
// int8 caches with float16 scales, one a (slot, kv head), as the JAX
// package's _attn_decode holds them, and computes the same function over
// the dequantized rows k = (float)k_i8 * (float)k_scale: each element is
// that one float32 product, the rounding of the reference's
// dequantization, so the two differ only in summation order.  Rows are
// staged as bytes: a head row is hd bytes and starts on a 4-byte boundary
// of its slot (h2o's 120-byte rows sit at 8-byte offsets of a 960-byte
// slot), so they are copied in 4-byte cp.async pieces into rows of an odd
// number of words (32 rows read at one column hit 32 banks); the scales,
// 2-byte values KV apart, are read with plain loads (a chunk's first into
// shared memory beside the first copies, a later chunk's into a register
// when its rows are put in flight, stored before they are needed).  The
// cache reads are a quarter of the float32 kernel's; everything else (the
// cluster split, the (m, l) partials, the merge) is the same code.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScoreRows = 64;       // rows a score pass covers (two warps)
constexpr int kQuarters = kThreads / kScoreRows;   // column ranges of hd
static_assert(kQuarters == 4, "quarters_sum adds four partial scores");
constexpr int kGroup = 4;            // heads a thread accumulates in p . V
constexpr int kMaxHd = 512;
constexpr int kMaxCluster = 16;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;                    // (B, H, hd) contiguous
  const void* k;                     // (B, Skv, KV, hd), unit stride in hd:
  const void* v;                     // float, or int8 in the Q8 instance
  const __half* k_scale;             // (B, Skv, KV), the Q8 instance only
  const __half* v_scale;
  float* out;                        // (B, H, hd)
  float* m;                          // (B, H)
  float* l;                          // (B, H)
  int H, KV, G, hd, n_valid;
  int rows;                          // key rows of a CTA's range
  int chunk;                         // rows of a shared-memory chunk (<= 64)
  long long k_sb, k_ss, k_sh;        // strides in elements
  long long v_sb, v_ss, v_sh;
  long long ks_sb, ks_ss, ks_sh;     // the scales' strides in elements
  long long vs_sb, vs_ss, vs_sh;
  float scale;
};

// Shared-memory row stride of the key chunk: an odd number of float4s, so
// that 8 consecutive rows read at one column fall in 8 distinct bank
// groups.  The Q8 instance's int8 key rows take the same number in bytes:
// an odd number of words, so 32 consecutive rows fall in 32 banks.
__host__ __device__ constexpr int key_stride(int hd) {
  return 4 * ((hd / 4) | 1);
}

// Floats of the K and V chunks (Q8: int8 rows and their scales as
// floats), which the row-split partials of p . V (kGroup float4s a
// thread) reuse once the last chunk is done
__host__ __device__ constexpr int chunk_floats(int hd, int chunk, bool q8) {
  return q8 ? chunk * (key_stride(hd) + hd) / 4 + 2 * chunk
            : chunk * (key_stride(hd) + hd);
}

__host__ __device__ constexpr int kv_floats(int hd, int chunk, bool q8) {
  return chunk_floats(hd, chunk, q8) > 16 * kThreads
             ? chunk_floats(hd, chunk, q8)
             : 16 * kThreads;
}

// Floats of shared memory: K and V chunks (or the row-split partials), q,
// the scores, (m, l, corr), and the merge's inbox of every rank's slice of
// acc, its (m, l) and weights.
__host__ __device__ constexpr int smem_floats(int gmax, int hd, int chunk,
                                              bool q8) {
  return kv_floats(hd, chunk, q8) + gmax * hd + kQuarters * gmax * chunk +
         4 * gmax +
         (gmax * hd + 4 * kMaxCluster) + 3 * kMaxCluster * gmax;
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

// 4-byte copy from device memory to shared memory (the Q8 instance's rows)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The two halves of a cluster barrier: every thread of every CTA arrives,
// then waits (no memory ordering; the merge's barrier is cluster.sync())
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
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

// The kQuarters partial scores of one (head, row), stride apart, summed
__device__ __forceinline__ float quarters_sum(const float* x, int stride) {
  return (x[0] + x[stride]) + (x[2 * stride] + x[3 * stride]);
}

__device__ __forceinline__ void fma4(float4& a, const float s, const float4 v) {
  a.x += s * v.x;
  a.y += s * v.y;
  a.z += s * v.z;
  a.w += s * v.w;
}

// Put `rows` cache rows from row r0 on in flight into dst (row stride ld),
// as one group.
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* base, long long stride,
                                          int r0, int rows, int nc) {
  for (int i = threadIdx.x; i < rows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    cp_async16(dst + r * ld + 4 * c, base + (r0 + r) * stride + 4 * c);
  }
  cp_async_commit();
}

// The same for int8 rows of nc words, a word a copy (ld and stride in
// bytes)
__device__ __forceinline__ void copy_rows8(signed char* dst, int ld,
                                           const signed char* base,
                                           long long stride, int r0, int rows,
                                           int nc) {
  for (int i = threadIdx.x; i < rows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    cp_async4(dst + r * ld + 4 * c, base + (r0 + r) * stride + 4 * c);
  }
  cp_async_commit();
}

// Four int8 values times their row's scale, each one float32 product
__device__ __forceinline__ float4 dequant4(const char4 x, const float s) {
  return make_float4(static_cast<float>(x.x) * s, static_cast<float>(x.y) * s,
                     static_cast<float>(x.z) * s, static_cast<float>(x.w) * s);
}

// CTAs an SM the kernel is compiled for: three (at most 80 registers a
// thread), so that the serving shape's 256 CTAs in clusters of 8 run in one
// wave on 132 SMs; two for 16 heads' accumulators.  With the score loop
// unrolled twice, nothing spills.
constexpr int min_blocks(int gmax) { return gmax >= 16 ? 2 : 3; }

template <int GM, bool Q8>
__global__ void __launch_bounds__(kThreads, min_blocks(GM))
flash_decode_kernel(const Params p) {
  // p . V: a thread per (group of kGroup heads, float4 column), kSlots of
  // them at most a thread
  constexpr int kGroups = (GM + kGroup - 1) / kGroup;
  constexpr int kSlots = (kGroups * (kMaxHd / 4) + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  const int hd = p.hd, chunk = p.chunk, G = p.G;
  const int ks = key_stride(hd);
  float* k_s = smem;                             // (chunk, ks)
  float* v_s = k_s + chunk * ks;                 // (chunk, hd)
  // Q8: int8 rows (chunk, ks bytes) and (chunk, hd bytes), then the rows'
  // scales as floats
  signed char* k8_s = reinterpret_cast<signed char*>(smem);
  signed char* v8_s = k8_s + chunk * ks;
  float* ksc_s = smem + chunk * (ks + hd) / 4;   // (chunk,)
  float* vsc_s = ksc_s + chunk;                  // (chunk,)
  float4* red_s = reinterpret_cast<float4*>(smem);  // (kThreads, kGroup), after
  float* q_s = smem + kv_floats(hd, chunk, Q8);  // (GM, hd)
  // (kQuarters, GM, chunk) partial scores of each column range; the first
  // GM * chunk then hold p
  float* s_s = q_s + GM * hd;
  float* m_s = s_s + kQuarters * GM * chunk;     // (GM,) running max
  float* l_s = m_s + GM;                         // (GM,) running sum
  float* c_s = l_s + GM;                         // (GM,) this chunk's correction
  float* in_s = c_s + 2 * GM;                    // (S, per), 16-byte aligned
  float* inm_s = in_s + GM * hd + 4 * kMaxCluster;  // (S, GM) ranks' m
  float* inl_s = inm_s + kMaxCluster * GM;       // (S, GM) ranks' l
  float* w_s = inl_s + kMaxCluster * GM;         // (S, GM) merge weights

  cluster_arrive_relaxed();      // waited for before the first remote store
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / S;              // (b, kv head)
  const int b = group / p.KV;
  const int kvh = group - b * p.KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = hd / 4;
  const int h0 = kvh * G;                        // first query head of the group
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const signed char* kb8 =
      static_cast<const signed char*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const signed char* vb8 =
      static_cast<const signed char*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const __half* ksb = p.k_scale + b * p.ks_sb + kvh * p.ks_sh;
  const __half* vsb = p.v_scale + b * p.vs_sb + kvh * p.vs_sh;
  const int lo = min(p.n_valid, rank * p.rows);  // this CTA's key range
  const int hi = min(p.n_valid, lo + p.rows);
  const int n_chunks = (hi - lo + chunk - 1) / chunk;   // 0: an empty range
  // Q8: the scales of a later chunk's key (threads 0..) and value rows
  // (threads kScoreRows..), held from their load to their store
  float k_sc = 0.f, v_sc = 0.f;
  const int vsc_row = tid - kScoreRows;

  if (n_chunks > 0) {
    const int rows0 = min(chunk, hi - lo);
    if constexpr (Q8) {
      copy_rows8(k8_s, ks, kb8, p.k_ss, lo, rows0, nc);
      copy_rows8(v8_s, hd, vb8, p.v_ss, lo, rows0, nc);
      if (tid < rows0) ksc_s[tid] = __half2float(ksb[(lo + tid) * p.ks_ss]);
      if (vsc_row >= 0 && vsc_row < rows0)
        vsc_s[vsc_row] = __half2float(vsb[(lo + vsc_row) * p.vs_ss]);
    } else {
      copy_rows(k_s, ks, kb, p.k_ss, lo, rows0, nc);
      copy_rows(v_s, hd, vb, p.v_ss, lo, rows0, nc);
    }
  }
  const long long row = static_cast<long long>(b) * p.H + h0;
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = p.q[row * hd + i];
  // heads past G (up to GM) keep p = 0 and corr = 0 in p . V
  for (int i = tid; i < GM * chunk; i += kThreads) s_s[i] = 0.f;
  if (tid < GM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    c_s[tid] = 0.f;
  }

  // scores: a thread takes one row of a pass and one column range of hd,
  // every head; the column range is warp-uniform
  const int sj = tid % kScoreRows;
  const int quarter = tid / kScoreRows;
  const int ncq = (nc + kQuarters - 1) / kQuarters;
  const int c_lo = min(nc, quarter * ncq), c_hi = min(nc, c_lo + ncq);
  const int pairs = (G + kGroup - 1) / kGroup * nc;   // p . V pairs
  const int splits = max(1, kThreads / pairs);   // row subsets of a pair
  const int split = tid / pairs;
  float4 acc[kSlots][kGroup];
  int pair_of[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int h = 0; h < kGroup; ++h) acc[s][h] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int idx = tid + s * kThreads;
    pair_of[s] = idx < splits * pairs ? idx % pairs : -1;
  }

  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const float4* v4 = reinterpret_cast<const float4*>(v_s);
  for (int t = 0; t < n_chunks; ++t) {
    const int k0 = lo + t * chunk;
    const int rows = min(chunk, hi - k0);
    const bool more = t + 1 < n_chunks;
    if constexpr (Q8) {          // this chunk's key scales, loaded earlier
      if (t > 0 && tid < rows) ksc_s[tid] = k_sc;
    }
    cp_async_wait<1>();          // this chunk's keys (its values may still fly)
    __syncthreads();

    // partial scores: K is read once, q is one address across a warp
    for (int j = sj; j < rows; j += kScoreRows) {
      float d[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) d[g] = 0.f;
      const float4* krow = reinterpret_cast<const float4*>(k_s + j * ks);
      const char4* krow8 = reinterpret_cast<const char4*>(k8_s + j * ks);
      const float ksc = Q8 ? ksc_s[j] : 0.f;
#pragma unroll 2
      for (int c = c_lo; c < c_hi; ++c) {
        const float4 kv = Q8 ? dequant4(krow8[c], ksc) : krow[c];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4 qv = q4[g * nc + c];
            d[g] += kv.x * qv.x + kv.y * qv.y + kv.z * qv.z + kv.w * qv.w;
          }
        }
      }
      float* part = s_s + quarter * GM * chunk + j;
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) part[g * chunk] = d[g];
    }
    __syncthreads();
    if (more) {                  // the key buffer is free: the next keys
      const int next = min(chunk, hi - k0 - chunk);
      if constexpr (Q8) {
        copy_rows8(k8_s, ks, kb8, p.k_ss, k0 + chunk, next, nc);
        if (tid < next)
          k_sc = __half2float(ksb[(k0 + chunk + tid) * p.ks_ss]);
      } else {
        copy_rows(k_s, ks, kb, p.k_ss, k0 + chunk, next, nc);
      }
    }

    // online softmax: one warp per query head, two keys a lane
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * chunk;
      const bool in0 = lane < rows, in1 = lane + 32 < rows;
      float x0 = kNegInf, x1 = kNegInf;        // the column ranges' sum
      if (in0) x0 = quarters_sum(sg + lane, GM * chunk) * p.scale;
      if (in1) x1 = quarters_sum(sg + lane + 32, GM * chunk) * p.scale;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float e0 = in0 ? expf(x0 - m_new) : 0.f;
      const float e1 = in1 ? expf(x1 - m_new) : 0.f;
      if (in0) sg[lane] = e0;
      if (in1) sg[lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    if constexpr (Q8) {          // this chunk's value scales, loaded earlier
      if (t > 0 && vsc_row >= 0 && vsc_row < rows) vsc_s[vsc_row] = v_sc;
    }
    if (more)
      cp_async_wait<1>();        // this chunk's values; the next keys may fly
    else
      cp_async_wait<0>();
    __syncthreads();

    // acc = acc * corr + p . V: each value row read once for kGroup heads
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (pair_of[s] >= 0) {
        const int hg = pair_of[s] / nc;
        const int c = pair_of[s] - hg * nc;
        const float* pg = s_s + hg * kGroup * chunk;
#pragma unroll
        for (int h = 0; h < kGroup; ++h) {
          const float corr = c_s[hg * kGroup + h];
          acc[s][h].x *= corr;
          acc[s][h].y *= corr;
          acc[s][h].z *= corr;
          acc[s][h].w *= corr;
        }
#pragma unroll 2
        for (int j = split; j < rows; j += splits) {   // split 0 if slot > 0
          const float4 vv =
              Q8 ? dequant4(reinterpret_cast<const char4*>(v8_s + j * hd)[c],
                            vsc_s[j])
                 : v4[j * nc + c];
#pragma unroll
          for (int h = 0; h < kGroup; ++h) fma4(acc[s][h], pg[h * chunk + j], vv);
        }
      }
    }
    __syncthreads();             // values and scores are reused
    if (more) {
      const int next = min(chunk, hi - k0 - chunk);
      if constexpr (Q8) {
        copy_rows8(v8_s, hd, vb8, p.v_ss, k0 + chunk, next, nc);
        if (vsc_row >= 0 && vsc_row < next)
          v_sc = __half2float(vsb[(k0 + chunk + vsc_row) * p.vs_ss]);
      } else {
        copy_rows(v_s, hd, vb, p.v_ss, k0 + chunk, next, nc);
      }
    }
  }
  if (splits > 1 && pair_of[0] >= 0) {   // the chunks' memory is free now
#pragma unroll
    for (int h = 0; h < kGroup; ++h) red_s[tid * kGroup + h] = acc[0][h];
  }
  __syncthreads();               // (m, l) and the row-split partials

  // merge: rank r owns outputs [r * per, (r + 1) * per) of the G * hd (per
  // a multiple of 4).  Every rank stores its partial of those outputs, and
  // its (m, l), into rank r's inbox in distributed shared memory; after one
  // cluster barrier each rank merges its inbox in rank order.
  const int total = G * hd;
  const int per = 4 * ((total + 4 * S - 1) / (4 * S));
  cluster_wait();                // every CTA of the cluster has started
  if (splits > 1) {              // sum the row subsets, in order
    for (int i = tid; i < G * nc; i += kThreads) {   // i = g * nc + c
      const int g = i / nc;
      const int pr = g / kGroup * nc + (i - g * nc);
      float4 a = red_s[pr * kGroup + g % kGroup];
      for (int r = 1; r < splits; ++r) {
        const float4 x = red_s[(r * pairs + pr) * kGroup + g % kGroup];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      const int dst = 4 * i / per;   // float index 4 * i = g * hd + 4 * c
      *reinterpret_cast<float4*>(cluster.map_shared_rank(in_s, dst) +
                                 rank * per + 4 * i - dst * per) = a;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (pair_of[s] >= 0) {
        const int hg = pair_of[s] / nc;
        const int c = pair_of[s] - hg * nc;
#pragma unroll
        for (int h = 0; h < kGroup; ++h) {
          const int i = (hg * kGroup + h) * nc + c;
          if (hg * kGroup + h < G) {
            const int dst = 4 * i / per;
            *reinterpret_cast<float4*>(cluster.map_shared_rank(in_s, dst) +
                                       rank * per + 4 * i - dst * per) =
                acc[s][h];
          }
        }
      }
    }
  }
  if (tid < G * S) {
    const int g = tid % G, dst = tid / G;
    cluster.map_shared_rank(inm_s, dst)[rank * GM + g] = m_s[g];
    cluster.map_shared_rank(inl_s, dst)[rank * GM + g] = l_s[g];
  }
  cluster.sync();                // every partial is in its owner's inbox

  if (tid < G * S) {             // w[x][g] = exp(m_x - max_x m_x)
    const int g = tid % G, x = tid / G;
    float mx = kNegInf;
    for (int y = 0; y < S; ++y) mx = fmaxf(mx, inm_s[y * GM + g]);
    w_s[x * GM + g] = expf(inm_s[x * GM + g] - mx);
  }
  __syncthreads();
  const int i0 = rank * per;
  const int n_out = min(per, total - i0);
  for (int i = tid; i < n_out; i += kThreads) {
    const int g = (i0 + i) / hd;
    float lsum = 0.f, o = 0.f;
#pragma unroll 4
    for (int x = 0; x < S; ++x) {
      const float w = w_s[x * GM + g];
      lsum += w * inl_s[x * GM + g];
      o += w * in_s[x * per + i];
    }
    p.out[row * hd + i0 + i] = o / fmaxf(lsum, 1e-37f);
    if (i0 + i == g * hd) {
      float mx = kNegInf;
      for (int x = 0; x < S; ++x) mx = fmaxf(mx, inm_s[x * GM + g]);
      p.m[row + g] = mx;
      p.l[row + g] = lsum;
    }
  }
}

// Clear a launch error so that it does not surface in a later launch.
int fail(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

template <int GM, bool Q8>
cudaError_t configure(int smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<GM, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(flash_decode_kernel<GM, Q8>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int GM, bool Q8>
cudaLaunchConfig_t config(const Params& p, int groups, int cluster,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats(GM, p.hd, p.chunk, Q8);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int GM, bool Q8>
int launch(const Params& p, int groups, int cluster, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config<GM, Q8>(p, groups, cluster, stream, attr);
  cudaError_t err = configure<GM, Q8>(static_cast<int>(cfg.dynamicSmemBytes),
                                      cluster);
  if (err != cudaSuccess) return fail(err);
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<GM, Q8>, p);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

template <int GM, bool Q8>
int max_clusters(const Params& p, int cluster, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<GM, Q8>(p, 1, cluster, nullptr, attr);
  cudaError_t err = configure<GM, Q8>(static_cast<int>(cfg.dynamicSmemBytes),
                                      cluster);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, flash_decode_kernel<GM, Q8>,
                                         &cfg);
  return err == cudaSuccess ? 0 : fail(err);
}

// The instance for the smallest compiled G_MAX >= G; a G above 16 is
// cudaErrorInvalidValue
template <bool Q8>
int launch_any(const Params& p, int groups, int cluster, cudaStream_t s) {
  if (p.G <= 1) return launch<1, Q8>(p, groups, cluster, s);
  if (p.G <= 2) return launch<2, Q8>(p, groups, cluster, s);
  if (p.G <= 4) return launch<4, Q8>(p, groups, cluster, s);
  if (p.G <= 8) return launch<8, Q8>(p, groups, cluster, s);
  if (p.G <= 16) return launch<16, Q8>(p, groups, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool Q8>
int max_clusters_any(const Params& p, int cluster, int* out) {
  if (p.G <= 1) return max_clusters<1, Q8>(p, cluster, out);
  if (p.G <= 2) return max_clusters<2, Q8>(p, cluster, out);
  if (p.G <= 4) return max_clusters<4, Q8>(p, cluster, out);
  if (p.G <= 8) return max_clusters<8, Q8>(p, cluster, out);
  if (p.G <= 16) return max_clusters<16, Q8>(p, cluster, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch B * KV clusters of `cluster` CTAs on `stream`; CTA rank r of a
// cluster reads the key rows [r * rows, (r + 1) * rows) of the first
// n_valid, `chunk` rows at a time.  hd, the cache strides and the base
// pointers must allow 16-byte copies (the caller checks).  Returns the CUDA
// error code of the launch (0 on success); a group size H / KV above 16 is
// cudaErrorInvalidValue.
int flash_decode_launch(const float* q, const float* k, const float* v,
                        float* out, float* m, float* l, int B, int H, int KV,
                        int hd, int n_valid, int cluster, int rows, int chunk,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, void* stream) {
  const Params p{q, k, v, nullptr, nullptr, out, m, l, H, KV, H / KV, hd,
                 n_valid, rows, chunk, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 0, 0, 0, 0, 0, 0, scale};
  return launch_any<false>(p, B * KV, cluster,
                           static_cast<cudaStream_t>(stream));
}

// The int8 instance: caches k, v int8 (B, Skv, KV, hd) and their float16
// scales k_scale, v_scale (B, Skv, KV), all through their strides (in
// elements).  hd, the cache strides and the base pointers must allow
// 4-byte copies (the caller checks).  Returns as flash_decode_launch.
int flash_decode_int8_launch(const float* q, const signed char* k,
                             const signed char* v, const __half* k_scale,
                             const __half* v_scale, float* out, float* m,
                             float* l, int B, int H, int KV, int hd,
                             int n_valid, int cluster, int rows, int chunk,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long ks_sb, long long ks_ss, long long ks_sh,
                             long long vs_sb, long long vs_ss, long long vs_sh,
                             float scale, void* stream) {
  const Params p{q, k, v, k_scale, v_scale, out, m, l, H, KV, H / KV, hd,
                 n_valid, rows, chunk, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh, scale};
  return launch_any<true>(p, B * KV, cluster,
                          static_cast<cudaStream_t>(stream));
}

// The most clusters of `cluster` CTAs that can be resident at once for a
// group size G, head dim hd and chunk rows (cudaOccupancyMaxActiveClusters)
// of the float32 (q8 = 0) or int8 (q8 = 1) instance, into *out; returns the
// CUDA error code.
int flash_decode_max_active_clusters(int G, int hd, int chunk, int cluster,
                                     int q8, int* out) {
  Params p{};
  p.G = G;
  p.hd = hd;
  p.chunk = chunk;
  return q8 ? max_clusters_any<true>(p, cluster, out)
            : max_clusters_any<false>(p, cluster, out);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
