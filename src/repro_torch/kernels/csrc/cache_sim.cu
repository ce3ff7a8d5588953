// Set-associative cache replay on Hopper (sm_90a), with an optional
// closed-loop latency chain in the same pass.
//
// Replaces the two Pallas kernels of the JAX package's
// kernels/cache_sim.py: `_cache_sim_kernel` (behind `cache_sim`) and
// `_cache_sim_fused_kernel` (behind `cache_sim_fused`).  One template serves
// both; FUSED compiles the latency chain in, LRU picks the policy (FIFO
// and direct-mapped otherwise), IN_SMEM says where the lane's structures
// live.
//
// What bounds it on this card: the serial chain of one thread.  Every
// access depends on the state the previous one left, so one trace is one
// thread of one block on one SM.  An access waits on two to four dependent
// shared-memory round trips (about 23 cycles each on an H100, by
// tools/smem_latency.cu), but a lone thread issues its ~150 instructions
// per access in order, most of them waiting on the one before: on an H100
// at 1980 MHz the Table I walk takes ~570 cycles an access, so
// instructions, not memory, take most of the time.  Device memory moves
// ~15 bytes per access (page and write flag in; hit, evict, latency,
// arrival out).
//
// What the design does about it: no access scans its set, and the walk
// keeps its instructions and branches few.  A lane keeps:
//   * an open-addressing hash table of {page, frame} int32 pairs, 2^bits >=
//     2 * frames slots, linear probing from home(page) = page * kHashMul
//     mod 2^bits, backward-shift deletion (no tombstones): the hit way is
//     one probe away at load <= 1/2;
//   * per frame, one int4 {tag, dirty, prev, next} (one 16-byte load or
//     store) and the stamp;
//   * per set, one int4 {fill, head, tail}: valid ways are always the prefix
//     [0, fill), so while the set fills the victim (the first invalid way)
//     is way `fill`; under LRU the frames form a doubly linked recency list
//     (a touch moves the frame to the head; the victim of a full set, the
//     least stamp since valid stamps are distinct, is the tail); under FIFO
//     (and direct-mapped, its one-way case) the victim of a full set is way
//     fill - ways, with fill kept in [ways, 2 * ways).
// The policy is a template parameter, and the stores an access does not
// need go to a spare entry instead of being branched around, so the walk
// branches only to probe further and to delete.  One thread walks each
// staged chunk in order, with no barrier and no device-memory access: each
// access issues the next one's loads (its input, the probe's first slot,
// the set, the victim's frame and first probe slot) right after its own
// stores, so they run beside its outputs and latency chain.  In order of
// issue, the set, then the victim's frame (whose tag gives the victim's
// home slot) are waited on by every access; a hit then waits on its own
// frame (three round trips), a miss while the set fills on nothing more
// (two), a miss in a full set on the victim's probe and the deletion's
// next slot (four).  All the block's threads stage the next chunk's input
// into shared memory and flush the chunk's outputs, coalesced, around two
// barriers per chunk.  Everything lives in dynamic shared memory when it
// fits (the Table I lane, 1 set x 4096 ways, takes 147,520 bytes), else in
// a global scratch from the wrapper; the final (tags, meta, dirty) state is
// copied out.  The wrapper computes the layout (`layout()` in cache_sim.py)
// and passes it in, so it is defined once.
//
// Semantics are bit-identical to the Pallas kernels: int32 tags, stamps
// t = i + 1 and dirty flags written at the chosen way of each access; the
// dirty-evict flag is !hit && tags[v] >= 0 && dirty[v]; ring slot i % K on
// the global access index; int32 nanosecond arithmetic that wraps like the
// reference's.  The hash decides only probe lengths, never a result.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// The hash multiplier: home(page) = page * kHashMul mod 2^table_bits.  An
// immediate operand, not a kernel parameter, which the walk would reload
// from the constant bank on its serial chain.  cache_sim_hash_mul() gives
// it to the wrapper, whose HASH_MUL a card test holds equal to it.
constexpr uint32_t kHashMul = 0x9E3779B1u;

// Offsets in int32 words, computed by `layout()` in cache_sim.py (its
// `Layout`, field for field): shared memory holds the `chunk` staged inputs
// at 0, then the staged latencies, arrivals and outcome bytes, the ring, and
// the lane's structures when they live there (at `lane`); a lane's
// structures are its hash table at 0, frames, sets and stamps.  The int4
// arrays start on 16 bytes.
struct Layout {
  int32_t chunk, lat, arr, out, ring, lane, lane_words, frames, sets, meta,
      table_bits;
};
constexpr int kLayoutWords = 11;
static_assert(sizeof(Layout) == 4 * kLayoutWords, "Layout is 11 words");

struct Params {
  const int32_t* pages;    // (lanes, n)
  const uint8_t* writes;   // (lanes, n)
  int64_t n;
  int num_sets, ways;
  Layout at;
  int outstanding, issue_ns, hit_ns, miss_ns, miss_occ_ns, wb_ns;
  uint8_t* hits;           // (lanes, n)
  uint8_t* evicts;         // (lanes, n)
  int32_t* lat;            // (lanes, n), FUSED only
  int32_t* arr;            // (lanes, n), FUSED only
  int32_t* state;          // (lanes, 3, num_sets, ways): final tags/meta/dirty
  int32_t* scratch;        // (lanes, lane words) unless IN_SMEM
};

// A lane's structures.  The table, the frames and the stamps have a spare
// entry past their end (table slot 2^bits, frame `frames`): the walk sends
// there the stores an access does not need, instead of branching around
// them.
struct Lane {
  int2* table;      // (2^bits + 2,) {page, frame}; page -1: empty
  int4* frames;     // (frames + 1,) {tag (-1: invalid), dirty, prev, next}
  int4* sets;       // (num_sets,) {fill, head, tail, unused}
  int32_t* meta;    // (frames + 1,) stamp of the last touch (LRU) or fill
};

// An opaque copy of x: the walk keeps it in a register instead of reading
// the kernel's parameters again for every access.
__device__ __forceinline__ int reg(int x) {
  asm("" : "+r"(x));
  return x;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t home(int32_t page, uint32_t mask) {
  return (static_cast<uint32_t>(page) * kHashMul) & mask;
}

// Slot of `page` (present) or of the empty slot that ends its probe
// (absent), probing from `h`, whose entry `e` the caller loaded.
__device__ __forceinline__ uint32_t probe(const Lane& L, int32_t page,
                                          uint32_t h, int2& e, uint32_t mask) {
  while (e.x != page && e.x != -1) {
    h = (h + 1) & mask;
    e = L.table[h];
  }
  return h;
}

// Backward-shift deletion of the entry at slot `i`: each later entry of the
// cluster whose home is not cyclically in (i, j] moves back into the hole.
__device__ __forceinline__ void erase(const Lane& L, uint32_t i,
                                      uint32_t mask) {
  uint32_t j = (i + 1) & mask;
  int2 e = L.table[j];
  while (e.x != -1) {
    if (((j - home(e.x, mask)) & mask) >= ((j - i) & mask)) {
      L.table[i] = e;
      i = j;
    }
    j = (j + 1) & mask;
    e = L.table[j];
  }
  L.table[i] = make_int2(-1, -1);
}

// The walking thread's registers, carried from one chunk to the next.
struct Walker {
  int32_t t = 0;           // stamp of the last access: its index + 1
  int32_t busy = 0;        // fill-path busy-until
  int32_t prev = 0;        // previous arrival
  int slot = 0;            // ring slot of the next access: i % K
};

// An access's input and the loads that depend only on it and on the state
// its predecessors left: the probe's first entry, the set, the victim the
// set would give up on a miss, and the victim's first probe entry (any slot
// while the set fills; no insertion can land there, since an occupied slot
// precedes the victim's).
struct Ahead {
  int32_t page, wr;
  int set, v;
  uint32_t h, d;
  int2 e, o;
  int4 st, fv;
};

template <bool LRU>
__device__ __forceinline__ void look_ahead(Ahead& a, int32_t in, const Lane& L,
                                           uint32_t mask, int S, int W,
                                           bool sets_pow2) {
  a.page = in & 0x7fffffff;
  a.wr = static_cast<uint32_t>(in) >> 31;
  a.set = sets_pow2 ? (a.page & (S - 1)) : (a.page % S);
  a.h = home(a.page, mask);
  a.e = L.table[a.h];
  a.st = L.sets[a.set];
  const int f = a.st.x;
  a.v = f < W ? a.set * W + f : LRU ? a.st.z : a.set * W + f - W;
  a.fv = L.frames[a.v];
  a.d = home(a.fv.x, mask);
  a.o = L.table[a.d];
}

// One thread replays the m >= 1 staged accesses of a chunk in order.  In:
// page | write << 31; out: hit | dirty evict << 1, and the latency and
// arrival when FUSED.  Each access issues the next one's loads right after
// its own stores, before its outputs and latency chain.
template <bool FUSED, bool LRU>
__device__ __forceinline__ void walk(const Params& p, const Lane& L,
                                     const int32_t* s_in, uint8_t* s_out,
                                     int32_t* s_lat, int32_t* s_arr,
                                     int32_t* ring, int m, Walker& w) {
  const uint32_t mask = reg((1 << p.at.table_bits) - 1);
  const int S = reg(p.num_sets);
  const int W = reg(p.ways);
  const int spare = reg(S * W);   // the spare frame; mask + 1: spare slot
  const int K = reg(p.outstanding);
  const int32_t issue_ns = reg(p.issue_ns), hit_ns = reg(p.hit_ns);
  const int32_t miss_ns = reg(p.miss_ns), wb_ns = reg(p.wb_ns);
  const int32_t miss_occ_ns = reg(p.miss_occ_ns);
  const bool sets_pow2 = (S & (S - 1)) == 0;
  Ahead a;
  look_ahead<LRU>(a, s_in[0], L, mask, S, W, sets_pow2);
  for (int j = 0; j < m; ++j) {
    // past the chunk's end this reads the staged latencies: harmless
    const int32_t in_next = s_in[j + 1];
    const int32_t t = ++w.t;
    int32_t ring_t = 0;
    if (FUSED) ring_t = ring[w.slot];

    const uint32_t h = probe(L, a.page, a.h, a.e, mask);
    const bool hit = a.e.x == a.page;
    const bool full = a.st.x >= W;
    const bool dirty_evict = !hit && full && a.fv.y != 0;
    const int y = hit ? a.e.y : a.v;   // the frame touched or filled
    // a miss inserts its page before erasing the victim's: the table keeps
    // an empty slot either way
    L.table[hit ? mask + 1 : h] = make_int2(a.page, a.v);
    if (!hit && full) erase(L, probe(L, a.fv.x, a.d, a.o, mask), mask);
    int4 st = a.st;
    if (LRU) {   // move y to the head of the set's list
      const int4 r = hit ? L.frames[y] : a.fv;
      const bool move = y != st.y;            // a new frame is never the head
      const bool unlink = move && (hit || full);
      L.frames[unlink ? r.z : spare].w = r.w;
      L.frames[unlink && r.w != -1 ? r.w : spare].z = r.z;
      L.frames[move && st.y != -1 ? st.y : spare].z = y;
      L.frames[y] = make_int4(hit ? r.x : a.page, (hit ? r.y : 0) | a.wr,
                              move ? -1 : r.z, move ? st.y : r.w);
      L.meta[y] = t;
      const int tail = move && st.y == -1 ? y
                       : unlink && r.w == -1 ? r.z : st.z;
      st = make_int4(st.x + (!hit && !full), move ? y : st.y, tail, 0);
    } else {
      L.frames[hit && a.wr ? y : spare].y = 1;
      L.frames[hit ? spare : y] = make_int4(a.page, a.wr, -1, -1);
      L.meta[hit ? spare : y] = t;
      st.x = hit ? st.x : st.x + 1 == 2 * W ? W : st.x + 1;
    }
    L.sets[a.set] = st;
    s_out[j] = static_cast<uint8_t>(hit | dirty_evict << 1);

    look_ahead<LRU>(a, in_next, L, mask, S, W, sets_pow2);

    if (FUSED) {
      // closed-loop arrival through the K-slot ring, then busy-until
      // queueing on the fill path for misses
      const int32_t t_arr = max(wrap_add(w.prev, issue_ns), ring_t);
      const int32_t start = max(t_arr, w.busy);
      const int32_t done =
          hit ? wrap_add(t_arr, hit_ns)
              : wrap_add(wrap_add(start, miss_ns), dirty_evict ? wb_ns : 0);
      if (!hit) w.busy = wrap_add(start, miss_occ_ns);
      w.prev = t_arr;
      ring[w.slot] = done;
      w.slot = w.slot + 1 == K ? 0 : w.slot + 1;
      s_lat[j] = wrap_sub(done, t_arr);
      s_arr[j] = t_arr;
    }
  }
}

// One block per lane, so one block an SM: the minimum of 1 lets ptxas use
// the registers that leaves (72-80), where it otherwise keeps near 40 and
// spills in the global-scratch kernels.
template <bool FUSED, bool LRU, bool IN_SMEM>
__global__ void __launch_bounds__(kThreads, 1) cache_sim_kernel(Params p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int tid = threadIdx.x;
  const Layout& at = p.at;
  const int F = p.num_sets * p.ways;
  const int S = p.num_sets;
  const int T = 1 << at.table_bits;
  const int C = at.chunk;
  const int K = p.outstanding;
  const int64_t lane_row = static_cast<int64_t>(blockIdx.x) * p.n;

  int32_t* s_in = smem;
  int32_t* s_lat = smem + at.lat;
  int32_t* s_arr = smem + at.arr;
  uint8_t* s_out = reinterpret_cast<uint8_t*>(smem + at.out);
  int32_t* ring = smem + at.ring;
  int32_t* base = IN_SMEM
      ? smem + at.lane
      : p.scratch + static_cast<int64_t>(blockIdx.x) * at.lane_words;
  Lane L;
  L.table = reinterpret_cast<int2*>(base);
  L.frames = reinterpret_cast<int4*>(base + at.frames);
  L.sets = reinterpret_cast<int4*>(base + at.sets);
  L.meta = base + at.meta;

  for (int j = tid; j < T; j += kThreads) L.table[j] = make_int2(-1, -1);
  for (int j = tid; j < F; j += kThreads) {
    L.frames[j] = make_int4(-1, 0, -1, -1);
    L.meta[j] = 0;
  }
  for (int j = tid; j < S; j += kThreads) L.sets[j] = make_int4(0, -1, -1, 0);
  if (FUSED) {
    for (int j = tid; j < K; j += kThreads) ring[j] = 0;
  }
  __syncthreads();

  Walker w;   // thread 0's
  for (int64_t c0 = 0; c0 < p.n; c0 += C) {
    const int m = static_cast<int>(p.n - c0 < C ? p.n - c0 : C);
    const int64_t g = lane_row + c0;
    for (int j = tid; j < m; j += kThreads) {
      s_in[j] = p.pages[g + j] | (p.writes[g + j] != 0 ? INT32_MIN : 0);
    }
    __syncthreads();
    if (tid == 0) walk<FUSED, LRU>(p, L, s_in, s_out, s_lat, s_arr, ring, m, w);
    __syncthreads();
    for (int j = tid; j < m; j += kThreads) {
      const uint8_t o = s_out[j];
      p.hits[g + j] = o & 1;
      p.evicts[g + j] = o >> 1;
      if (FUSED) {
        p.lat[g + j] = s_lat[j];
        p.arr[g + j] = s_arr[j];
      }
    }
  }

  int32_t* out = p.state + static_cast<int64_t>(blockIdx.x) * 3 * F;
  for (int j = tid; j < F; j += kThreads) {
    const int4 fr = L.frames[j];
    out[j] = fr.x;
    out[F + j] = L.meta[j];
    out[2 * F + j] = fr.y;
  }
}

template <bool FUSED, bool LRU, bool IN_SMEM>
int launch(const Params& p, int lanes, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_sim_kernel<FUSED, LRU, IN_SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cache_sim_kernel<FUSED, LRU, IN_SMEM>
      <<<lanes, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED, bool LRU>
int launch_in(const Params& p, int lanes, int in_smem, int smem_bytes,
              cudaStream_t stream) {
  return in_smem ? launch<FUSED, LRU, true>(p, lanes, smem_bytes, stream)
                 : launch<FUSED, LRU, false>(p, lanes, smem_bytes, stream);
}

}  // namespace

extern "C" {

// Launch one block per lane on `stream`; `layout` is the host array of the
// kLayoutWords fields of Layout.  Returns the CUDA error code of the launch
// (0 on success); the kernel itself does not synchronise.
int cache_sim_launch(const int32_t* pages, const uint8_t* writes, int64_t n,
                     int lanes, int num_sets, int ways, int is_lru, int fused,
                     const uint32_t* layout, int outstanding, int issue_ns,
                     int hit_ns, int miss_ns, int miss_occ_ns, int wb_ns,
                     int state_in_smem, int smem_bytes, uint8_t* hits,
                     uint8_t* evicts, int32_t* lat, int32_t* arr,
                     int32_t* state, int32_t* scratch, void* stream) {
  Params p;
  p.pages = pages;
  p.writes = writes;
  p.n = n;
  p.num_sets = num_sets;
  p.ways = ways;
  memcpy(&p.at, layout, sizeof(Layout));
  p.outstanding = outstanding;
  p.issue_ns = issue_ns;
  p.hit_ns = hit_ns;
  p.miss_ns = miss_ns;
  p.miss_occ_ns = miss_occ_ns;
  p.wb_ns = wb_ns;
  p.hits = hits;
  p.evicts = evicts;
  p.lat = lat;
  p.arr = arr;
  p.state = state;
  p.scratch = scratch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int in = state_in_smem;
  if (fused) {
    return is_lru ? launch_in<true, true>(p, lanes, in, smem_bytes, s)
                  : launch_in<true, false>(p, lanes, in, smem_bytes, s);
  }
  return is_lru ? launch_in<false, true>(p, lanes, in, smem_bytes, s)
                : launch_in<false, false>(p, lanes, in, smem_bytes, s);
}

// The hash multiplier of the kernel's table (kHashMul).
uint32_t cache_sim_hash_mul() { return kHashMul; }

// Largest dynamic shared memory a block may opt in to on `device`.
int cache_sim_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* cache_sim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
