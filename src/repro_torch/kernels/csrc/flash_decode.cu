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

#include <cooperative_groups.h>
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
  const float* k;                    // (B, Skv, KV, hd), unit stride in hd
  const float* v;
  float* out;                        // (B, H, hd)
  float* m;                          // (B, H)
  float* l;                          // (B, H)
  int H, KV, G, hd, n_valid;
  int rows;                          // key rows of a CTA's range
  int chunk;                         // rows of a shared-memory chunk (<= 64)
  long long k_sb, k_ss, k_sh;        // strides in elements
  long long v_sb, v_ss, v_sh;
  float scale;
};

// Shared-memory row stride of the key chunk: an odd number of float4s, so
// that 8 consecutive rows read at one column fall in 8 distinct bank groups
__host__ __device__ constexpr int key_stride(int hd) {
  return 4 * ((hd / 4) | 1);
}

// Floats of the K and V chunks, which the row-split partials of p . V
// (kGroup float4s a thread) reuse once the last chunk is done
__host__ __device__ constexpr int kv_floats(int hd, int chunk) {
  return chunk * (key_stride(hd) + hd) > 16 * kThreads
             ? chunk * (key_stride(hd) + hd)
             : 16 * kThreads;
}

// Floats of shared memory: K and V chunks (or the row-split partials), q,
// the scores, (m, l, corr), and the merge's inbox of every rank's slice of
// acc, its (m, l) and weights.
__host__ __device__ constexpr int smem_floats(int gmax, int hd, int chunk) {
  return kv_floats(hd, chunk) + gmax * hd + kQuarters * gmax * chunk +
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

// CTAs an SM the kernel is compiled for: three (at most 80 registers a
// thread), so that the serving shape's 256 CTAs in clusters of 8 run in one
// wave on 132 SMs; two for 16 heads' accumulators.  With the score loop
// unrolled twice, nothing spills.
constexpr int min_blocks(int gmax) { return gmax >= 16 ? 2 : 3; }

template <int GM>
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
  float4* red_s = reinterpret_cast<float4*>(smem);  // (kThreads, kGroup), after
  float* q_s = smem + kv_floats(hd, chunk);      // (GM, hd)
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
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const int lo = min(p.n_valid, rank * p.rows);  // this CTA's key range
  const int hi = min(p.n_valid, lo + p.rows);
  const int n_chunks = (hi - lo + chunk - 1) / chunk;   // 0: an empty range

  if (n_chunks > 0) {
    copy_rows(k_s, ks, kb, p.k_ss, lo, min(chunk, hi - lo), nc);
    copy_rows(v_s, hd, vb, p.v_ss, lo, min(chunk, hi - lo), nc);
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
    cp_async_wait<1>();          // this chunk's keys (its values may still fly)
    __syncthreads();

    // partial scores: K is read once, q is one address across a warp
    for (int j = sj; j < rows; j += kScoreRows) {
      float d[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) d[g] = 0.f;
      const float4* krow = reinterpret_cast<const float4*>(k_s + j * ks);
#pragma unroll 2
      for (int c = c_lo; c < c_hi; ++c) {
        const float4 kv = krow[c];
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
    if (more)                    // the key buffer is free: the next keys
      copy_rows(k_s, ks, kb, p.k_ss, k0 + chunk,
                min(chunk, hi - k0 - chunk), nc);

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
          const float4 vv = v4[j * nc + c];
#pragma unroll
          for (int h = 0; h < kGroup; ++h) fma4(acc[s][h], pg[h * chunk + j], vv);
        }
      }
    }
    __syncthreads();             // values and scores are reused
    if (more)
      copy_rows(v_s, hd, vb, p.v_ss, k0 + chunk,
                min(chunk, hi - k0 - chunk), nc);
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

template <int GM>
cudaError_t configure(int smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(flash_decode_kernel<GM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int GM>
cudaLaunchConfig_t config(const Params& p, int groups, int cluster,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats(GM, p.hd, p.chunk);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int GM>
int launch(const Params& p, int groups, int cluster, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<GM>(p, groups, cluster, stream, attr);
  cudaError_t err = configure<GM>(static_cast<int>(cfg.dynamicSmemBytes),
                                  cluster);
  if (err != cudaSuccess) return fail(err);
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<GM>, p);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

template <int GM>
int max_clusters(const Params& p, int cluster, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<GM>(p, 1, cluster, nullptr, attr);
  cudaError_t err = configure<GM>(static_cast<int>(cfg.dynamicSmemBytes),
                                  cluster);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(out, flash_decode_kernel<GM>, &cfg);
  return err == cudaSuccess ? 0 : fail(err);
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
  const int G = H / KV;
  const Params p{q, k, v, out, m, l, H, KV, G, hd, n_valid, rows, chunk,
                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  const int groups = B * KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G <= 1) return launch<1>(p, groups, cluster, s);
  if (G <= 2) return launch<2>(p, groups, cluster, s);
  if (G <= 4) return launch<4>(p, groups, cluster, s);
  if (G <= 8) return launch<8>(p, groups, cluster, s);
  if (G <= 16) return launch<16>(p, groups, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most clusters of `cluster` CTAs that can be resident at once for a
// group size G, head dim hd and chunk rows (cudaOccupancyMaxActiveClusters),
// into *out; returns the CUDA error code.
int flash_decode_max_active_clusters(int G, int hd, int chunk, int cluster,
                                     int* out) {
  Params p{};
  p.hd = hd;
  p.chunk = chunk;
  if (G <= 1) return max_clusters<1>(p, cluster, out);
  if (G <= 2) return max_clusters<2>(p, cluster, out);
  if (G <= 4) return max_clusters<4>(p, cluster, out);
  if (G <= 8) return max_clusters<8>(p, cluster, out);
  if (G <= 16) return max_clusters<16>(p, cluster, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
