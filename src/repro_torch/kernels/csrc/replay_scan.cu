// The scan lane's stack replay on Hopper (sm_90a): one thread walks a whole
// trace through the device stack, one access after another.
//
// Replaces the JAX package's per-access lax.scan, which is not a Pallas
// kernel: src/repro/core/replay/engine.py::_scan_chunk (:441, its step: LFB
// slot recycle, `_transport` :100 / `_transport_ecmp` :174 / the faulted
// lane's `_transport_cols` :136 with the qacc / qthr / vft accumulators)
// over src/repro/core/replay/stack.py::step (:611) and
// `media_step` (:578): `_dram_step`, `_pmem_step`, `_buf_step`,
// `_cache_step`, and under them `_hil_read` / `_hil_write`, `_alloc_ppn`,
// `_ftl_invalidate`, greedy GC `_collect`, the free-block FIFO and
// `_pal_read` / `_pal_prog` / `_pal_erase`.  Its plain twin, line for line
// the same arithmetic, is repro_torch/core/replay/stack.py::step under the
// loop of repro_torch/kernels/replay_scan.py::replay_scan_plain.  A
// multi-host instance of its own (`replay_multi`, after the single-host
// block) replaces src/repro/core/replay/multihost.py::_make_multi_step,
// and the sweep instances (after it: one block a lane of a grid) the
// vmapped lanes of src/repro/core/replay/sweep.py.
//
// What bounds it on this card: the serial chain.  Every access starts from
// the state the previous one left (LFB slots, port busy-untils, frames,
// flash busy-untils), so one trace is one chain on one SM; device memory
// moves ~29 bytes an access (address, write flag and route in; issue,
// done and flags out).  An access waits on a few dependent shared-memory
// round trips (about 23 cycles each on an H100, by tools/smem_latency.cu)
// and on the instructions of one thread, which issues them in order: on
// the cached CXL-SSD ~3,000 cycles an access against a model of ~8 round
// trips (PERF.md; tools/scan_phases.py splits them by phase).
//
// What the design does about it: one thread owns the chain, and nothing on
// it scans the frames.  Thread 0 walks a staged chunk of the trace with no
// barrier and no shuffle per access; the argument fields and the state's
// scalars live in its registers, and each access loads the next one's
// input (and, on the flash, its l2p entry) after its own stores.  A block
// is four warps: warps 1-3 stage the next chunk's input (the media key,
// address / page_bytes or / row_bytes, the direct-mapped frame, the write
// flag and route) into shared memory and flush the previous chunk's issue,
// done and flags, coalesced, while thread 0 walks; the chunks are double
// buffered, one block barrier each.
//   * LFB: a tournament tree over the slots (a node holds the {tick, slot}
//     that wins its subtree, lowest slot on ties): the root is the argmin,
//     and the access's commit replays one leaf-to-root path, each level
//     loading the next level's sibling before its own store.
//   * Frames of the fully associative buffer and cache: a page-indexed map
//     where[page] (frame, -1 if absent; pages lie below num_pages, as l2p
//     is indexed by them) gives residency in one load; the victim is the
//     fill pointer while frames are free, then the head of a doubly linked
//     recency list (LRU: a touch moves the frame to the tail) or a
//     round-robin pointer (FIFO).  The packed frames (stamp<<39 | page<<1 |
//     dirty) are kept as the reference keeps them, so the state comes out
//     word for word.  This equals the reference's argmin over the packed
//     words only from a fresh cache (every frame free, as init_state makes
//     it and ReplayEngine passes it) or from the carry of the replay it
//     resumes (below): the wrapper refuses any other frames.
//     Direct-mapped takes page % cap, staged.
//   * MSHR and writeback tables: padded to blocks of eight free entries and
//     read a block at a time (16-byte loads, then bit masks: the lookup's
//     first match, occupancy and first free slot in one pass; MSHR pages
//     are int32 here).  The MSHR's earliest ready tick stays in a register
//     (mmin), so a full table's stall needs no search, and the expiry pass
//     runs only when some entry is ready by the access's arrival.
//   * The flash's die, channel and block arithmetic is 32-bit, one
//     multiply-high by a magic number; l2p[page] comes from the access's
//     early load unless a GC ran in its writeback.  GC (greedy victim
//     argmin over the blocks) runs only when its watermark is reached.
//   * Faults.  A stack with NAND fault statics (its own instance, NAND)
//     keeps the read and erase sequence numbers in registers: each page
//     read, a GC migration's included, draws its retry count from
//     splitmix64 over rd_seq (the seed-side mixes folded on the host) and
//     charges 1 + k sense and transfer rounds; each GC erase draws its
//     failure over er_seq, and a failed erase sets the victim's bit in a
//     retired bitmap, which the greedy victim scan skips, instead of
//     returning it to the free queue.  Under transport faults (its own
//     instance, FAULTED) each access carries a path id (in aux) and one
//     retry byte a hop (staged beside the chunk): the route tables hold
//     the path table, port -1 marks a hop the path does not have, hop h
//     occupies its port for occ * (1 + retries[h]), and a weighted port's
//     virtual clock vft advances by the clean occ.  Poison is a flag bit
//     the host ORs in.  A fault-free replay runs the instances without
//     either.
// Shared memory holds the staging buffers, the tree, the ports, the route
// tables, the MSHR and writeback tables and the die / channel busy-untils;
// then, while they fit, the frames' map, the packed frames, their links,
// l2p, the GC's valid counts, free mask, free queue and p2l.  What does not
// fit stays in device memory (the state tensors themselves; the map and
// links in a scratch tensor from the wrapper).  The wrapper computes that
// layout (`layout()` in kernels/replay_scan.py) and passes it in.  Table I's
// cached CXL-SSD over the 16,384 pages of chip_smoke.py's trace (2^20
// accesses, 32 outstanding, 256-access chunks) takes 216,976 bytes: 18,432
// of staging, 1,024 of tree, 912 of small tables, a 65,536-byte map,
// 32,768 of frames, 32,768 of links and a 65,536-byte l2p; every access
// stays in shared memory.  Mounted on chip_smoke.py's faulted 2 x 2
// spine-leaf (four hops, six ports, two paths) it takes 219,376: the
// retry bytes' staging, the path table and vft add 2,400.
//
// Resumable: a replay can run as a sequence of launches, one a chunk of
// the trace, that carry the whole replay state from one to the next in
// device memory (`Carry`, field for field `CARRY` in the wrapper): the
// accesses already replayed (the stamp base), the issue clock, the fill
// pointer and recency head and tail, the LFB slot ticks, and a port each
// the busy-until, queueing and throttle totals and QoS virtual clock; the
// page map and recency links go back to their home in `maps` at the
// epilogue and come from it at the prologue; the rest of the state (the
// frames, MSHR, writeback, flash and retired blocks) round-trips through
// the state tensors as in every launch.  A resumed launch builds its
// tournament tree from the carried slots, lowest slot on ties.  Without
// a carry a launch runs as a one-launch replay always did.  The
// multi-host instance carries every host's slots, clock and cursor, the
// QoS tables and every lane's victim order alike, over windows of each
// host's trace from its cursor.
//
// Where the JAX reference's semantics need care:
//   * Ties.  jnp.argmin / argmax return the lowest index among ties: the
//     LFB slot (engine.py:461; the tree compares {tick, slot}), the victim
//     over packed frames (invalid frames are -1, stack.py:358 and :434;
//     the fill pointer and list give the same), the MSHR slot
//     argmin(mpage) (:459: the first free one), the writeback slot
//     argmin(wtick) (:449), the GC victim (:189) and the first match of
//     every MSHR lookup: each scan keeps its first winner.
//   * JAX clamps out-of-range gathers and drops out-of-range scatters;
//     CUDA does neither.  Gated calls pass nonsense indices there: an
//     invalid victim's ev_page is 2^38 - 1 (stack.py:434-437, :358-361),
//     _ftl_invalidate reads through `osafe` (:251), _collect through
//     `lsafe` (:212), mready[m_idx] is read when nothing matched
//     (:400-402).  Here every gate is tested before its index is formed,
//     and an unmatched lookup reads index 0 as jnp.argmax does.
//   * lax.cond branches (the miss paths :423-477 and :356-375, GC
//     :276-280) commit state only on their branch; so do the ifs here,
//     and no gated write is hoisted out of them.
//   * Packed frames are stamp<<39 | page<<1 | dirty; the FIFO touch keeps
//     the old stamp (:480); a direct-mapped cache takes page % cap (:411);
//     the stamp counter starts at 1 and rises once an access.
//   * l2p, p2l, valid and free_q are int32 as in the reference (valid's
//     non-candidate score is 2^31 - 1); ticks are int64 (1 tick = 1 ps),
//     and every ns() constant comes rounded from the host.
//   * QoS: qthr[h] += pb[h] > t on the weighted hops, read before pb[h]
//     moves (engine.py:123-125).  ECMP: hop h of route r occupies port
//     hop_port[r, h] of the port union (:186).
//   * jnp's % is a floor modulo; the FIFO's count can go negative once the
//     pool has run dry (the sticky `bad` the wrapper turns into a
//     refusal), so its positions use floor_mod.

#include <cstdint>
#include <cstring>

#ifndef REPLAY_SCAN_EMULATE
#include <cuda_runtime.h>
#endif

// Per-phase clock64 stamps of the walking thread; a stamped copy of this
// source defines these (tools/scan_phases.py).  Here they compile to
// nothing.
#ifndef SCAN_PHASE
#define SCAN_PHASE_MEMBERS
#define SCAN_PHASE_BEGIN()
#define SCAN_PHASE(k)
#define SCAN_PHASE_DEP(k, v)
#define SCAN_PHASE_END()
#endif

namespace {

constexpr int kThreads = 128;        // thread 0 walks; warps 1-3 stage
constexpr int kStagers = kThreads - 32;
constexpr long long kBig = 1LL << 62;
constexpr long long kFree = -1;
constexpr int kStampShift = 39;
constexpr long long kPageField = ((1LL << 38) - 1) << 1;
constexpr long long kStampField = -(1LL << kStampShift);
constexpr long long kInt32Max = 2147483647LL;
constexpr int kBlock = 8;            // MSHR / writeback entries a pass loads

// phases of tools/scan_phases.py
enum Phase { P_LOAD, P_LFB, P_HOPS, P_MSHR, P_FRAMES, P_MISS, P_FLASH,
             P_COMMIT };

enum Kind { kDram = 0, kPmem = 1, kSsdBuf = 2, kSsdCache = 3 };

// The argument block, field for field `ARGS` in kernels/replay_scan.py.
enum Arg {
  A_KIND, A_N, A_START, A_OUTSTANDING, A_POSTED, A_HOPS, A_PORTS, A_ROUTES,
  A_PAGE_BYTES, A_FRAMES, A_ASSOC, A_MSHR, A_WB, A_CHANNELS, A_DIES, A_PPB,
  A_BUF, A_GC, A_NUM_BLOCKS, A_WATERMARK, A_NUM_PAGES,
  A_ISSUE_OV, A_RT_EXTRA, A_OCC, A_LOAD, A_PACK, A_ROW_BYTES,
  A_LAT_R_MISS, A_LAT_R_HIT, A_LAT_W_MISS, A_LAT_W_HIT,
  A_HIL_OV, A_XFER_PAGE, A_READ_T, A_PROG_T, A_SUS_T, A_ERASE_T, A_INTERNAL,
  A_HIT_LAT, A_LINE_XFER, A_PAGE_XFER, A_PACK10, A_IS_LRU, A_CAP,
  A_FAULT_HOPS, A_PATHS, A_NAND, A_RD_KEY, A_RD_THRESH, A_RD_MAX, A_ER_KEY,
  A_ER_THRESH,
  kNumArgs
};

// The layout, field for field `LAYOUT` in kernels/replay_scan.py: the
// chunk's accesses, the tree's leaves (a power of two), then byte offsets
// into dynamic shared memory.  The staging buffers, the tree and the small
// tables are always there; a placed array (frames and after) at an offset
// < 0 lives in device memory: the state tensor, or for the map and links
// the scratch tensor at byte -1 - offset.
enum Lay {
  L_CHUNK, L_LEAVES,
  L_IN_KEY, L_IN_AUX, L_IN_SET, L_IN_RT, L_OUT_ISSUE, L_OUT_DONE,
  L_OUT_FLAGS, L_TREE, L_PB, L_QACC, L_QTHR, L_VFT, L_TABLES, L_MPAGE,
  L_MREADY, L_WTICK, L_DIE_BUSY, L_DIE_PROG, L_CHAN_BUSY,
  L_WHERE, L_FRAMES, L_LINKS, L_L2P, L_VALID, L_FREE_MASK, L_FREE_Q, L_P2L,
  L_RETIRED,
  kLayoutWords
};

// The state's scalars, in and out, in the order of `SCALARS` in
// kernels/replay_scan.py.
enum Scalar {
  S_BUSY, S_ROW, S_DRAM_BUSY, S_WPB, S_WPP, S_NFREE, S_FQ_HEAD, S_FQ_COUNT,
  S_GCS, S_BAD, S_C_HR, S_C_HW, S_C_GW, S_C_GE, S_RD_SEQ, S_ER_SEQ, S_C_RR,
  S_C_RB, kNumScalars
};

// The carry of a resumable replay, field for field `CARRY` in
// kernels/replay_scan.py: the accesses already replayed (the stamp base),
// the issue clock, the victim order's fill pointer and recency head and
// tail; then the K LFB slot ticks and, a port each, the busy-untils, the
// queueing and throttle totals and the QoS virtual clocks.
enum Carry { C_SEEN, C_NOW, C_FILL, C_HEAD, C_TAIL, kCarryHead };

struct Args {
  long long v[kNumArgs];
};

struct Layout {
  long long v[kLayoutWords];
};

// Device pointers of one replay.  The trace (`routes` is the ECMP route
// or the faulted lane's path id, `retries` that lane's CRC retries, one
// byte a hop) and the per-access outputs; `tables` holds hop_port,
// hop_occ and hop_after (routes or paths x hops each) and the per-port
// QoS mask; `totals` receives qacc then qthr (ports each); `scal` the
// state's scalars; `scratch` the map, links and retired bitmap that the
// layout leaves in device memory.  The rest are the state's arrays, then
// the carry of a resumable replay (null for a one-launch replay) and the
// home of its page map and recency links (`maps`: the map, then the links
// at the next 16 bytes), where they live between launches.
struct Ptrs {
  const long long* addrs;
  const uint8_t* writes;
  const int32_t* routes;
  const uint8_t* retries;
  const long long* tables;
  long long* issues;
  long long* dones;
  int32_t* flags;
  long long* totals;
  long long* scal;
  long long* frames;
  long long* mpage;
  long long* mready;
  long long* wtick;
  int32_t* l2p;
  int32_t* p2l;
  int32_t* valid;
  int32_t* free_q;
  uint8_t* free_mask;
  uint8_t* rtr_mask;
  long long* die_busy;
  long long* die_prog;
  long long* chan_busy;
  char* scratch;
  long long* carry;
  char* maps;
};

// The home of a resumable replay's links in `maps`, past its map of
// `map_words` int32 entries.
__device__ __forceinline__ long long links_home(long long map_words) {
  return (4 * map_words + 15) / 16 * 16;
}

// Defining REPLAY_SCAN_EMULATE leaves these primitives, the CUDA keywords
// and the vector types to the file that includes this one: a host compiler
// then builds the replay for a thread-per-CUDA-thread emulation of the
// block (tests/torch_replay_scan_emulate.cpp, run by
// tests/test_torch_scan_emulate.py under AddressSanitizer).
#ifndef REPLAY_SCAN_EMULATE
__device__ __forceinline__ int thread_id() { return threadIdx.x; }
__device__ __forceinline__ void block_sync() { __syncthreads(); }

// The thread-block cluster of the sharded instance: this CTA's rank, the
// cluster's CTAs, a barrier of every thread of the cluster (release /
// acquire, not .aligned: thread 0 reaches it from inside its walk while
// the rest of its warp waits at it from their own loop), and the address
// of `p`'s counterpart in CTA `rank`'s shared memory (distributed shared
// memory, read through a generic pointer).
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
template <typename T>
__device__ __forceinline__ const T* cluster_map(const T* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}
#endif

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}
__device__ __forceinline__ long long min64(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long floor_mod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// x / d and x % d of a 32-bit x < 2^31 for a fixed d >= 1, by one
// multiply-high: with l = ceil(log2 d) and m = floor(2^32 (2^l - d) / d) + 1,
// x / d = (umulhi(m, x) + x) >> l for every 32-bit x (Granlund and
// Montgomery's round-up method); x < 2^31 keeps the sum in 32 bits.
struct Div {
  uint32_t d = 1, m = 1;
  int l = 0;
  __device__ void set(long long v) {
    d = v > 0 ? static_cast<uint32_t>(v) : 1u;
    l = 0;
    while ((1ull << l) < d) ++l;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    return (__umulhi(m, x) + x) >> l;
  }
  __device__ __forceinline__ uint32_t mod(uint32_t x) const {
    return x - div(x) * d;
  }
};

// Eight int64 entries of a table block (16-byte aligned: the tables start
// on 16 bytes and a block is 64), four 16-byte loads.
__device__ __forceinline__ void load_block(const long long* p,
                                           long long (&r)[kBlock]) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
#pragma unroll
  for (int u = 0; u < kBlock / 2; ++u) {
    const longlong2 x = q[u];
    r[2 * u] = x.x;
    r[2 * u + 1] = x.y;
  }
}

template <typename T>
__device__ __forceinline__ T* placed(char* sm, long long off, T* dev) {
  return off >= 0 ? reinterpret_cast<T*>(sm + off) : dev;
}

// ------------------------------------------------------------ the chain
// Thread 0's registers and the state's arrays.  NAND: the stack carries
// NAND fault statics (its own instance, so that a fault-free flash chain
// holds none of their registers).
template <bool NAND>
struct Chain {
  // argument fields
  int H, nf, nm, nw, nm8, nw8, nb, depth, leaves;
  bool ecmp, posted_writes, assoc, lru, gc;
  long long issue_ov, rt_extra, occ, load, pack, lat_rm, lat_rh, lat_wm,
      lat_wh, hil_ov, xfer_page, read_t, prog_t, sus_t, erase_t, internal,
      hit_lat, line_xfer, page_xfer, pack10, watermark, ppb;
  Div C, D, PPB;
  // the NAND decisions' folded seed keys, thresholds and retry maximum
  unsigned long long rd_key, rd_thresh, rd_max, er_key, er_thresh;
  // the state's scalars
  long long busy, row, dram_busy, wpb, wpp, nfree, fq_head, fq_count, gcs,
      bad, c_hr, c_hw, c_gw, c_ge, rd_seq, er_seq, c_rr, c_rb;
  // the frames' fill pointer and recency list; the LFB winner; the next
  // issue floor
  int fill, head, tail;
  long long mmin;     // the MSHR's earliest ready tick (kBig: none)
  longlong2 win;
  long long now;
  // arrays
  longlong2* tree;
  long long *pb, *qacc, *qthr, *vft, *mready, *wtick;
  int32_t* mpage;       // the MSHR's pages, int32 here (-1: free)
  const long long *hop_port, *hop_occ, *hop_after, *qos;
  long long *die_busy, *die_prog, *chan_busy, *frames;
  int32_t *where, *l2p, *p2l, *valid, *free_q;
  int2* links;
  uint8_t* free_mask;
  uint32_t* retired;    // bitmap of the blocks a failed erase retired
  SCAN_PHASE_MEMBERS

  // ---------------------------------------------------- NAND faults
  // fault_hash(seed, salt, 0, seq) of faults/plan.py: the seed-side mixes
  // come folded in `key`; splitmix64's finalizer over seq ^ key
  __device__ __forceinline__ static unsigned long long fault_mix(
      unsigned long long key, long long seq) {
    unsigned long long x = static_cast<unsigned long long>(seq) ^ key;
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  }

  // FaultPlan.nand_read_retries(rd_seq): the low 32 bits gate the event,
  // the high ones pick the burst, 1..rd_max
  __device__ __forceinline__ long long read_retries() const {
    const unsigned long long h = fault_mix(rd_key, rd_seq);
    return (h & 0xffffffffull) < rd_thresh
               ? static_cast<long long>(1 + (h >> 32) % rd_max)
               : 0;
  }

  __device__ __forceinline__ bool erase_fails() const {
    return (fault_mix(er_key, er_seq) & 0xffffffffull) < er_thresh;
  }

  // ---------------------------------------------------------- PAL
  __device__ __forceinline__ void die_of(long long ppn, uint32_t* ch,
                                         uint32_t* i) const {
    const uint32_t u = static_cast<uint32_t>(ppn);
    *ch = C.mod(u);
    *i = *ch * D.d + D.mod(C.div(u));
  }

  __device__ long long pal_read(long long t, long long ppn) {
    uint32_t ch, i;
    die_of(ppn, &ch, &i);
    const long long dbi = die_busy[i], dpi = die_prog[i];
    const long long cbi = chan_busy[ch];
    long long rd = read_t, xfer = xfer_page;
    if (NAND) {
      // 1 + k sense and transfer rounds; the sequence moves once a read
      const long long k = read_retries();
      rd *= 1 + k;
      xfer *= 1 + k;
      rd_seq += 1;
      c_rr += k;
    }
    long long ds = max64(t, dbi);
    if (dpi > ds) ds = min64(dpi, ds + sus_t);
    const long long array_done = ds + rd;
    const long long new_dp = dpi > ds ? dpi + rd : dpi;
    const long long done = max64(array_done, cbi) + xfer;
    die_busy[i] = done;
    die_prog[i] = new_dp;
    chan_busy[ch] = done;
    return done;
  }

  __device__ long long pal_prog(long long t, long long ppn) {
    uint32_t ch, i;
    die_of(ppn, &ch, &i);
    const long long ds = max64(max64(t, die_busy[i]), die_prog[i]);
    const long long bus_done = max64(ds, chan_busy[ch]) + xfer_page;
    const long long done = bus_done + prog_t;
    die_busy[i] = bus_done;
    die_prog[i] = done;
    chan_busy[ch] = bus_done;
    return done;
  }

  __device__ long long pal_erase(long long t, long long ppn) {
    uint32_t ch, i;
    die_of(ppn, &ch, &i);
    const long long done =
        max64(max64(t, die_busy[i]), die_prog[i]) + erase_t;
    die_busy[i] = done;
    return done;
  }

  // ------------------------------------------------ free-block FIFO
  __device__ long long free_pop(bool en) {
    const long long head_ = fq_head, cnt = fq_count;
    const long long v = free_q[head_];
    if (en) {
      fq_head = head_ + 1 == nb ? 0 : head_ + 1;
      fq_count = cnt - 1;
      free_mask[v] = 0;
      if (cnt <= 0) bad = 1;
    }
    return v;
  }

  __device__ void free_append(long long v) {
    free_q[floor_mod(fq_head + fq_count, nb)] = static_cast<int32_t>(v);
    fq_count += 1;
    free_mask[v] = 1;
  }

  // ------------------------------------------------------- FTL + GC
  __device__ long long collect(long long now_) {
    // greedy victim: fewest valid pages among blocks that are neither the
    // write block nor free nor retired, ties to the lowest block id
    long long best = kInt32Max + 1;
    int victim = 0;
    bool any_cand = false;
    for (int b = 0; b < nb; ++b) {
      const bool cand = b != wpb && !free_mask[b] &&
                        !(NAND && ((retired[b >> 5] >> (b & 31)) & 1u));
      any_cand |= cand;
      const long long score = cand ? valid[b] : kInt32Max;
      if (score < best) {
        best = score;
        victim = b;
      }
    }
    const long long base = static_cast<long long>(victim) * ppb;
    long long t = now_;
    for (long long off = 0; off < ppb && any_cand; ++off) {
      const long long ppn = base + off;
      const long long lpn = p2l[ppn];
      if (lpn < 0) continue;
      t = pal_read(t, ppn);
      long long wb_ = wpb, wp_ = wpp;
      if (wp_ >= ppb) {
        wb_ = free_pop(true);
        wp_ = 0;
      }
      const long long new_ppn = wb_ * ppb + wp_;
      wpb = wb_;
      wpp = wp_ + 1;
      t = pal_prog(t, new_ppn);
      p2l[ppn] = static_cast<int32_t>(kFree);
      p2l[new_ppn] = static_cast<int32_t>(lpn);
      l2p[lpn] = static_cast<int32_t>(new_ppn);
      valid[PPB.div(static_cast<uint32_t>(new_ppn))] += 1;
      valid[victim] -= 1;
      c_gw += 1;
    }
    if (any_cand) {
      t = pal_erase(t, base);
      c_ge += 1;
      // FTL._collect's erase-fail consult: a failed erase retires the
      // victim instead of returning it to the pool
      bool fail = false;
      if (NAND) {
        fail = erase_fails();
        er_seq += 1;
      }
      if (fail) {
        retired[victim >> 5] |= 1u << (victim & 31);
        c_rb += 1;
      } else {
        free_append(victim);
      }
    }
    return t;
  }

  __device__ void ftl_invalidate(long long lpn) {
    const long long old = l2p[lpn];
    if (old >= 0) {
      valid[PPB.div(static_cast<uint32_t>(old))] -= 1;
      p2l[old] = static_cast<int32_t>(kFree);
    }
  }

  // FTL._next_ppn; returns the ppn and sets *gc_done
  __device__ long long alloc_ppn(long long t, long long* gc_done) {
    const bool need = wpp >= ppb;
    *gc_done = t;
    if (!gc) {
      if (need) {
        wpb = nfree;
        wpp = 0;
        nfree += 1;
      }
      wpp += 1;
      return wpb * ppb + wpp - 1;
    }
    if (need && fq_count <= watermark) {
      gcs += 1;
      *gc_done = collect(t);
    }
    // `need` as taken before the collection, as in the reference
    const long long v = free_pop(need);
    const long long b = need ? v : wpb;
    const long long p = need ? 0 : wpp;
    wpb = b;
    wpp = p + 1;
    return b * ppb + p;
  }

  __device__ long long hil_write(long long t, long long lpn) {
    SCAN_PHASE(P_MISS);
    c_hw += 1;
    if (gc) ftl_invalidate(lpn);
    long long t1;
    const long long ppn = alloc_ppn(t + hil_ov, &t1);
    l2p[lpn] = static_cast<int32_t>(ppn);
    if (gc) {
      p2l[ppn] = static_cast<int32_t>(lpn);
      valid[PPB.div(static_cast<uint32_t>(ppn))] += 1;
    }
    const long long done = pal_prog(t1, ppn);
    SCAN_PHASE_DEP(P_FLASH, done);
    return done;
  }

  __device__ long long hil_read(long long t, long long ppn) {
    SCAN_PHASE(P_MISS);
    c_hr += 1;
    const long long done = pal_read(t + hil_ov, ppn);
    SCAN_PHASE_DEP(P_FLASH, done);
    return done;
  }

  // ------------------------------------------------------------ MSHR
  // Free every MSHR entry ready by `tick` (pages -1, ticks kBig), block by
  // block: four 16-byte loads of ticks, a mask, the stores.  Sets mmin to
  // the smallest tick left (kBig when none; the pads hold kBig) and
  // returns the lowest slot freed (-1 if none).
  __device__ __forceinline__ int expire(long long tick) {
    int first = -1;
    long long left = kBig;
#pragma unroll 1
    for (int i0 = 0; i0 < nm8; i0 += kBlock) {
      long long r[kBlock];
      load_block(mready + i0, r);
      unsigned kill = 0;
      long long keep[kBlock];
#pragma unroll
      for (int u = 0; u < kBlock; ++u) {
        const bool k = r[u] <= tick && i0 + u < nm;
        kill |= static_cast<unsigned>(k) << u;
        keep[u] = k ? kBig : r[u];
      }
      // the survivors' minimum as a tree of independent mins
#pragma unroll
      for (int w = kBlock / 2; w; w /= 2) {
#pragma unroll
        for (int u = 0; u < w; ++u) keep[u] = min64(keep[u], keep[u + w]);
      }
      left = min64(left, keep[0]);
#pragma unroll
      for (int u = 0; u < kBlock; ++u) {
        if ((kill >> u) & 1) {
          mpage[i0 + u] = -1;
          mready[i0 + u] = kBig;
        }
      }
      if (first < 0 && kill) first = i0 + __ffs(kill) - 1;
    }
    mmin = left;
    return first;
  }

  // ------------------------------------------- frames: map and list
  // Move frame f (valid) to the tail of the recency list.
  __device__ __forceinline__ void to_tail(int f) {
    if (f == tail) return;
    const int2 lk = links[f];           // lk.y >= 0: f is not the tail
    if (lk.x >= 0) links[lk.x].y = lk.y;
    else head = lk.y;
    links[lk.y].x = lk.x;
    links[f] = make_int2(tail, -1);
    links[tail].y = f;
    tail = f;
  }

  // The victim of a fully associative miss: the first free frame while
  // any is, then the list's head (LRU) or the round-robin pointer (FIFO).
  __device__ __forceinline__ int victim() const {
    return fill < nf ? fill : lru ? head : fill - nf;
  }

  // Frame v takes `page` on a miss; `vval` is its old packed word.
  __device__ __forceinline__ void insert(int v, long long vval,
                                         long long page) {
    if (vval >= 0) where[(vval & kPageField) >> 1] = -1;
    where[page] = v;
    if (lru) {
      if (fill < nf) {
        links[v] = make_int2(tail, -1);
        if (tail >= 0) links[tail].y = v;
        else head = v;
        tail = v;
        fill += 1;
      } else {
        to_tail(v);
      }
    } else {
      fill = fill + 1 == 2 * nf ? nf : fill + 1;
    }
  }

  // ---------------------------------------------------------- media
  // Each returns the completion tick and sets the event bits of `flags`:
  // 0 hit, 1 dirty evict, then FLAG_EVENT_BITS (metrics.py) of its kind.
  __device__ __forceinline__ long long dram_step(long long t, bool posted) {
    const long long occ_done = max64(t, busy) + occ;
    busy = occ_done;
    return occ_done + (posted ? pack : load);
  }

  __device__ __forceinline__ long long pmem_step(long long t, long long row_,
                                                 bool wr, bool posted,
                                                 int* flags) {
    const bool row_hit = row_ == row;
    const long long occ_done = max64(t, busy) + occ;
    busy = occ_done;
    row = row_;
    *flags = row_hit ? 1 : 0;
    const long long lat = wr ? (row_hit ? lat_wh : lat_wm)
                             : (row_hit ? lat_rh : lat_rm);
    return occ_done + (posted ? pack : lat);
  }

  __device__ __forceinline__ long long buf_step(long long t, long long page,
                                                bool wr, long long ctr,
                                                long long early_ppn,
                                                int* flags) {
    const long long pfield = page << 1;
    const int f = where[page];
    const int v = victim();
    const long long vval = frames[v];
    SCAN_PHASE_DEP(P_FRAMES, f + vval);
    if (f >= 0) {                                        // hit
      const long long old = frames[f];
      frames[f] = (ctr << kStampShift) | pfield | ((old & 1) | (long long)wr);
      to_tail(f);
      *flags = 1;
      return t + internal;
    }
    const bool flushed = vval >= 0 && (vval & 1) > 0;
    const bool filled = early_ppn >= 0;
    long long done0 = t;
    if (filled) done0 = hil_read(t, early_ppn);
    if (flushed) hil_write(done0, (vval & kPageField) >> 1);
    frames[v] = (ctr << kStampShift) | pfield | (long long)wr;
    insert(v, vval, page);
    SCAN_PHASE(P_MISS);
    *flags = (flushed ? 2 : 0) | (filled ? 4 : 0);
    return done0 + internal;
  }

  __device__ __forceinline__ long long cache_step(long long t,
                                                  long long page, int set,
                                                  bool wr, bool posted,
                                                  long long ctr,
                                                  long long early_ppn,
                                                  int* flags) {
    const long long pfield = page << 1;
    const int page32 = static_cast<int>(page);    // pages lie below num_pages

    // MSHR lookup, the first match (an unmatched lookup reads slot 0, as
    // jnp.argmax does), with the occupancy and the first free slot (the
    // insert's argmin(mpage): pages are >= 0, a free slot -1) in the same
    // pass: a block is eight int32 pages, two 16-byte loads, bit masks; the
    // pads hold page -1
    int m_idx = nm, used = 0, mslot = -1;
#pragma unroll 1
    for (int i0 = 0; i0 < nm8; i0 += kBlock) {
      const int4 lo = *reinterpret_cast<const int4*>(mpage + i0);
      const int4 hi = *reinterpret_cast<const int4*>(mpage + i0 + 4);
      const int v[kBlock] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      unsigned hits = 0, frees = 0;
#pragma unroll
      for (int u = 0; u < kBlock; ++u) {
        hits |= static_cast<unsigned>(v[u] == page32) << u;
        frees |= static_cast<unsigned>(v[u] < 0) << u;
      }
      const unsigned real =
          nm - i0 >= kBlock ? (1u << kBlock) - 1 : (1u << (nm - i0)) - 1;
      used += __popc(real & ~frees);
      if (m_idx == nm && (hits & real)) m_idx = i0 + __ffs(hits & real) - 1;
      if (mslot < 0 && (frees & real)) mslot = i0 + __ffs(frees & real) - 1;
    }
    const bool m_exists = m_idx < nm;
    if (!m_exists) m_idx = 0;
    const long long m_ready = mready[m_idx];
    const bool coalesce = m_exists && m_ready > t;
    SCAN_PHASE_DEP(P_MSHR, m_ready);

    // residency and the victim
    int fidx, vic;
    bool resident;
    if (assoc) {
      const int f = where[page];
      resident = f >= 0;
      fidx = resident ? f : 0;
      vic = victim();
    } else {
      fidx = set;
      const long long fv = frames[fidx];
      resident = fv >= 0 && (fv & kPageField) == pfield;
      vic = fidx;
    }
    const long long old = frames[fidx];
    const long long vval = frames[vic];
    const bool hit = !coalesce && resident;
    const bool miss = !coalesce && !resident;
    const long long xdone = max64(t, dram_busy) + line_xfer;
    SCAN_PHASE_DEP(P_FRAMES, old + vval);

    long long start2 = t, fill_done = t;
    bool do_wb = false, stalled = false, evicted = false;
    if (miss) {
      // MSHR allocate: a full table stalls until its earliest fill (mmin),
      // which frees every slot ready by then; the insert takes the lowest
      stalled = used >= nm;
      long long start1 = t;
      if (stalled) {
        const long long vic_ready = mmin;
        start1 = max64(t, vic_ready);
        mslot = expire(vic_ready);
      }
      evicted = vval >= 0;
      do_wb = evicted && (vval & 1) > 0;
      long long stall = start1;
      if (do_wb) {
        // writeback queue: reap, stall on the earliest drain if full
        int alive = 0;
        long long wmin = kBig;
#pragma unroll 1
        for (int i0 = 0; i0 < nw8; i0 += kBlock) {
          long long w[kBlock];
          load_block(wtick + i0, w);
#pragma unroll
          for (int u = 0; u < kBlock; ++u) {
            const bool real = i0 + u < nw, dead = w[u] <= start1;
            if (real && dead) wtick[i0 + u] = kFree;
            alive += real && !dead;
            wmin = real && !dead ? min64(wmin, w[u]) : wmin;
          }
        }
        if (alive >= nw) {
          stall = wmin;
#pragma unroll 1
          for (int i = 0; i < nw; ++i) {
            if (wtick[i] <= stall) wtick[i] = kFree;
          }
        }
        const long long wdone = hil_write(stall, (vval & kPageField) >> 1);
        int slot = 0;
        long long wbest = kBig;
#pragma unroll 1
        for (int i0 = nw8 - kBlock; i0 >= 0; i0 -= kBlock) {
          long long w[kBlock];
          load_block(wtick + i0, w);
#pragma unroll
          for (int u = kBlock - 1; u >= 0; --u) {
            const bool take = i0 + u < nw && w[u] <= wbest;
            wbest = take ? w[u] : wbest;
            slot = take ? i0 + u : slot;
          }
        }
        wtick[slot] = wdone;
        start2 = max64(start1, stall);
      } else {
        start2 = start1;
      }
      // fill from flash (virgin pages skip the read), then cache-DRAM; a
      // GC in the writeback may have moved this page
      const long long ppn = do_wb && gc ? static_cast<long long>(l2p[page])
                                        : early_ppn;
      const long long flash_done = ppn >= 0 ? hil_read(start2, ppn) : start2;
      fill_done = max64(flash_done, dram_busy) + page_xfer;
      // MSHR insert (an existing key is overwritten), then expiry
      const int slot = m_exists ? m_idx : mslot;
      mpage[slot] = page32;
      mready[slot] = fill_done;
      mmin = min64(mmin, fill_done);
      // nothing expires while the earliest fill is after t (mmin stays the
      // table's minimum: an overwritten entry was ready by t, so then the
      // pass runs and takes the minimum anew)
      if (mmin <= t) expire(t);
      frames[vic] = (ctr << kStampShift) | pfield | (long long)wr;
      if (assoc) insert(vic, vval, page);
      SCAN_PHASE(P_MISS);
    } else if ((coalesce && wr && resident) || hit) {
      // touch: LRU restamps, FIFO keeps the insertion stamp
      const long long stamp = lru ? (ctr << kStampShift) : (old & kStampField);
      frames[fidx] = stamp | pfield | ((old & 1) | (long long)wr);
      if (assoc && lru) to_tail(fidx);
    }

    if (hit) dram_busy = xdone;
    else if (miss) dram_busy = fill_done;
    long long ret;
    if (coalesce) {
      ret = wr ? t + hit_lat : m_ready + hit_lat;
    } else if (hit) {
      ret = wr ? (posted ? t + pack10 : t + hit_lat)
               : max64(xdone, t + hit_lat);
    } else {
      ret = wr ? start2 + hit_lat : fill_done + hit_lat;
    }
    *flags = (hit ? 1 : 0) | (do_wb ? 2 : 0) | (miss ? 4 : 0) |
             (coalesce ? 8 : 0) | (stalled ? 16 : 0) | (evicted ? 32 : 0);
    return max64(t, ret);
  }

  // ---------------------------------------------------- LFB and ports
  // Slot k (the winner) now holds `done`: replay its leaf-to-root path,
  // one compare a level (a sibling on the left, of lower slots, wins a
  // tie: it wins when its tick, less one if it is on the left, is below
  // the path's).  Each level loads the next level's sibling before its own
  // store, into the other of two registers (the loop is unrolled by two,
  // so no copy waits on the load); past the root that is node 0, which no
  // level uses.
  __device__ __forceinline__ void lfb_commit(long long done) {
    int node = leaves + static_cast<int>(win.y);
    longlong2 cur = make_longlong2(done, win.y);
    longlong2 a = tree[node ^ 1];
    tree[node] = cur;
#pragma unroll 1
    for (int l = 0; l < depth; l += 2) {
      const longlong2 b = tree[(node >> 1) ^ 1];
      if (a.x - (node & 1) < cur.x) cur = a;
      node >>= 1;
      tree[node] = cur;
      if (l + 1 == depth) break;
      a = tree[(node >> 1) ^ 1];
      if (b.x - (node & 1) < cur.x) cur = b;
      node >>= 1;
      tree[node] = cur;
    }
    win = cur;
  }

  // Each hop's loads go before its stores (the compiler cannot tell the
  // tables apart), so they overlap.
  __device__ __forceinline__ long long hops(long long t, int route) {
    const long long row_ = ecmp ? static_cast<long long>(route) * H : 0;
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      const long long pi = ecmp ? hop_port[row_ + h] : h;
      const long long occ_h = hop_occ[row_ + h], after_h = hop_after[row_ + h];
      const long long b = pb[pi], q = qos[pi], acc = qacc[pi], thr = qthr[pi];
      const long long st = max64(t, b);
      qthr[pi] = thr + (q && b > t ? 1 : 0);
      qacc[pi] = acc + (st - t);
      const long long done = st + occ_h;
      pb[pi] = done;
      t = done + after_h;
    }
    return t + rt_extra;
  }

  // The faulted lane's hops (engine.py::_transport_cols): path `path` of
  // the path table, whose port -1 marks a hop the path does not have (a
  // no-op); hop h occupies its port for occ * (1 + rt[h]) ticks, and a
  // weighted port's virtual clock vft advances by the clean occ: retries
  // stretch the serialization, not the origin's entitlement.
  __device__ __forceinline__ long long fault_hops(long long t, int path,
                                                  const uint8_t* rt) {
    const long long row_ = static_cast<long long>(path) * H;
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      const long long pi = hop_port[row_ + h];
      if (pi < 0) continue;
      const long long occ_h = hop_occ[row_ + h], after_h = hop_after[row_ + h];
      const long long b = pb[pi], acc = qacc[pi];
      if (qos[pi]) {
        const long long prev = vft[pi];
        qthr[pi] += prev > t ? 1 : 0;
        vft[pi] = max64(prev, t) + occ_h;
      }
      const long long st = max64(t, b);
      qacc[pi] = acc + (st - t);
      const long long done = st + occ_h * (1 + rt[h]);
      pb[pi] = done;
      t = done + after_h;
    }
    return t + rt_extra;
  }

  // ------------------------------------------------------- the walk
  // Thread 0 replays the m staged accesses of a chunk whose first has
  // index `base`.  In: key (PMEM row, buffer / cache page), aux (write |
  // route or path << 1), the direct-mapped frame and the faulted lane's
  // retry bytes (H an access); out: issue, done, flags.
  template <int KIND, bool FAULTED>
  __device__ void walk(int m, long long base, const long long* in_key,
                       const int32_t* in_aux, const int32_t* in_set,
                       const uint8_t* in_rt, long long* o_issue,
                       long long* o_done, int32_t* o_flags) {
    constexpr bool kFlash = KIND == kSsdBuf || KIND == kSsdCache;
    // each access loads the next one's input, and for the flash its
    // l2p[page] (after its own stores, before the next one's)
    long long key = in_key[0];
    int32_t aux = in_aux[0];
    int set = in_set[0];
    long long early_ppn = kFlash ? l2p[key] : 0;
    for (int j = 0; j < m; ++j) {
      const bool wr = (aux & 1) != 0;
      SCAN_PHASE_DEP(P_LOAD, key + aux + early_ppn);
      const long long issue = max64(now, win.x);
      const bool posted = wr && posted_writes;
      const long long t = FAULTED ? fault_hops(issue, aux >> 1, in_rt + j * H)
                                  : hops(issue, aux >> 1);
      SCAN_PHASE_DEP(P_HOPS, t);
      const long long ctr = base + j + 1;          // stamp counter: 1, 2, ...
      int flags = 0;
      long long done;
      if (KIND == kDram) {
        done = dram_step(t, posted);
      } else if (KIND == kPmem) {
        done = pmem_step(t, key, wr, posted, &flags);
      } else if (KIND == kSsdBuf) {
        done = buf_step(t, key, wr, ctr, early_ppn, &flags);
      } else {
        done = cache_step(t, key, set, wr, posted, ctr, early_ppn,
                          &flags);
      }
      o_issue[j] = issue;
      o_done[j] = done;
      o_flags[j] = flags;
      now = issue + issue_ov;
      if (j + 1 < m) {
        key = in_key[j + 1];
        aux = in_aux[j + 1];
        set = in_set[j + 1];
        if (kFlash) early_ppn = l2p[key];
      }
      SCAN_PHASE(P_COMMIT);
      lfb_commit(done);
      SCAN_PHASE_DEP(P_LFB, win.x);
    }
  }
};

// The block: prologue, the chunks, epilogue.  NAND: the stack carries
// NAND fault statics; FAULTED: its transport is the faulted lane's path
// table and retry bytes; CARRY: the replay is resumable (a launch of a
// chunked replay, `ptrs.carry` set); SWEEP: a lane of a cache sweep, whose
// capacity may be below its frame count.  Each is an instance of its own,
// so that a fault-free replay runs the same code as before the faulted
// lane and a one-launch replay the same code as before the carry and the
// sweeps (a runtime branch on any of them cost the walk 1-11% on the
// card).
template <int KIND, bool NAND, bool FAULTED, bool CARRY, bool SWEEP = false>
__device__ void replay(const Args& args, const Layout& lay, const Ptrs& ptrs,
                       char* sm) {
  const long long* a = args.v;
  const long long* L = lay.v;
  const int tid = thread_id();
  const int K = static_cast<int>(a[A_OUTSTANDING]);
  const int P = static_cast<int>(a[A_PORTS]);
  const int H = static_cast<int>(a[A_HOPS]);
  // rows of the route tables: ECMP routes, the faulted lane's paths, or 1
  const int R = static_cast<int>(a[A_PATHS]);
  constexpr bool faulted = FAULTED;
  const int nm = static_cast<int>(a[A_MSHR]), nw = static_cast<int>(a[A_WB]);
  // the tables padded to whole blocks: free pads (page -1, ready kBig)
  const int nm8 = (nm + kBlock - 1) / kBlock * kBlock;
  const int nw8 = (nw + kBlock - 1) / kBlock * kBlock;
  const int nf = static_cast<int>(KIND == kSsdBuf ? a[A_BUF] : a[A_FRAMES]);
  const int dies = static_cast<int>(a[A_CHANNELS] * a[A_DIES]);
  const int chans = static_cast<int>(a[A_CHANNELS]);
  const int nb = static_cast<int>(a[A_NUM_BLOCKS]);
  const long long num_pages = a[A_NUM_PAGES];
  const long long n = a[A_N], start = a[A_START];
  const int chunk = static_cast<int>(L[L_CHUNK]);
  const long long leaves = L[L_LEAVES];
  constexpr bool kFlash = KIND == kSsdBuf || KIND == kSsdCache;
  const bool assoc = KIND == kSsdBuf || (KIND == kSsdCache && a[A_ASSOC]);
  const bool gc = kFlash && a[A_GC];
  const bool nand = kFlash && NAND;
  const int rwords = (nb + 31) / 32;     // the retired bitmap's words
  const bool lru_links = KIND == kSsdBuf || (assoc && a[A_IS_LRU] != 0);
  // a resumable replay: its carry; `seen` accesses replayed before this
  // launch (the stamp base), resumed from the carry when > 0
  long long* carry = CARRY ? ptrs.carry : nullptr;
  const long long seen = CARRY ? carry[C_SEEN] : 0;
  const bool resume = CARRY && seen > 0;
  long long* cslots = CARRY ? carry + kCarryHead : nullptr;
  int32_t* home_where = reinterpret_cast<int32_t*>(ptrs.maps);
  int2* home_links =
      reinterpret_cast<int2*>(ptrs.maps + links_home(num_pages));

  Chain<NAND> c;
  c.tree = reinterpret_cast<longlong2*>(sm + L[L_TREE]);
  c.pb = reinterpret_cast<long long*>(sm + L[L_PB]);
  c.qacc = reinterpret_cast<long long*>(sm + L[L_QACC]);
  c.qthr = reinterpret_cast<long long*>(sm + L[L_QTHR]);
  c.vft = reinterpret_cast<long long*>(sm + L[L_VFT]);
  long long* tables = reinterpret_cast<long long*>(sm + L[L_TABLES]);
  c.hop_port = tables;
  c.hop_occ = tables + R * H;
  c.hop_after = tables + 2 * R * H;
  c.qos = tables + 3 * R * H;
  c.mpage = reinterpret_cast<int32_t*>(sm + L[L_MPAGE]);
  c.mready = reinterpret_cast<long long*>(sm + L[L_MREADY]);
  c.wtick = reinterpret_cast<long long*>(sm + L[L_WTICK]);
  c.die_busy = reinterpret_cast<long long*>(sm + L[L_DIE_BUSY]);
  c.die_prog = reinterpret_cast<long long*>(sm + L[L_DIE_PROG]);
  c.chan_busy = reinterpret_cast<long long*>(sm + L[L_CHAN_BUSY]);
  // the map and links not in shared memory live in the scratch tensor, or
  // in their home when the replay is resumable
  c.where = placed(sm, L[L_WHERE],
                   CARRY ? home_where
                         : reinterpret_cast<int32_t*>(ptrs.scratch - 1 -
                                                      L[L_WHERE]));
  c.frames = placed(sm, L[L_FRAMES], ptrs.frames);
  c.links = placed(sm, L[L_LINKS],
                   CARRY ? home_links
                         : reinterpret_cast<int2*>(ptrs.scratch - 1 -
                                                   L[L_LINKS]));
  c.l2p = placed(sm, L[L_L2P], ptrs.l2p);
  c.valid = placed(sm, L[L_VALID], ptrs.valid);
  c.free_mask = placed(sm, L[L_FREE_MASK], ptrs.free_mask);
  c.free_q = placed(sm, L[L_FREE_Q], ptrs.free_q);
  c.p2l = placed(sm, L[L_P2L], ptrs.p2l);
  c.retired = placed(sm, L[L_RETIRED], reinterpret_cast<uint32_t*>(
                                           ptrs.scratch - 1 - L[L_RETIRED]));

  // prologue (engine.py::_init_carry): LFB slots at start, ports idle;
  // the tables and the placed state copied in, the map emptied.  A
  // resumed replay takes the slots, ports, map and links from its carry.
  const long long T = R * H;
  const long long ppb = a[A_PPB];
  for (long long i = tid; i < 2 * leaves; i += kThreads) {
    if (i == 0) {                // past the root: read, never used
      c.tree[0] = make_longlong2(kBig, 0);
      continue;
    }
    // node i covers the leaves from its leftmost one, lo; every real slot
    // starts at `start`, so its winner is lo when lo is a real slot
    long long lo = i, span = 1;
    while (lo < leaves) {
      lo <<= 1;
      span <<= 1;
    }
    lo -= leaves;
    if (!resume) {
      c.tree[i] = make_longlong2(lo < K ? start : kBig, lo);
      continue;
    }
    // resumed: the earliest carried tick of the node's slots, the lowest
    // slot on ties (engine.py:461's argmin)
    longlong2 best = make_longlong2(kBig, lo);
    for (long long k = lo; k < lo + span && k < K; ++k)
      if (cslots[k] < best.x) best = make_longlong2(cslots[k], k);
    c.tree[i] = best;
  }
  for (int i = tid; i < P; i += kThreads) {
    c.pb[i] = c.qacc[i] = c.qthr[i] = 0;
    if (faulted) c.vft[i] = 0;
    if (resume) {
      const long long* cp = cslots + K;
      c.pb[i] = cp[i];
      c.qacc[i] = cp[P + i];
      c.qthr[i] = cp[2 * P + i];
      if (faulted) c.vft[i] = cp[3 * P + i];
    }
  }
  for (long long i = tid; i < 3 * T + P; i += kThreads)
    tables[i] = ptrs.tables[i];
  for (int i = tid; i < nm8; i += kThreads) {
    c.mpage[i] = i < nm ? static_cast<int32_t>(ptrs.mpage[i]) : -1;
    c.mready[i] = i < nm ? ptrs.mready[i] : kBig;
  }
  for (int i = tid; i < nw8; i += kThreads)
    c.wtick[i] = i < nw ? ptrs.wtick[i] : kFree;
  for (int i = tid; i < dies; i += kThreads) {
    c.die_busy[i] = ptrs.die_busy[i];
    c.die_prog[i] = ptrs.die_prog[i];
  }
  for (int i = tid; i < chans; i += kThreads)
    c.chan_busy[i] = ptrs.chan_busy[i];
  if (assoc && !resume) {
    for (long long i = tid; i < num_pages; i += kThreads) c.where[i] = -1;
    // a resumable replay's links start defined, so that its carry does
    if (CARRY && lru_links)
      for (int i = tid; i < nf; i += kThreads) c.links[i] = make_int2(-1, -1);
  } else if (assoc) {
    if (L[L_WHERE] >= 0)
      for (long long i = tid; i < num_pages; i += kThreads)
        c.where[i] = home_where[i];
    if (lru_links && L[L_LINKS] >= 0)
      for (int i = tid; i < nf; i += kThreads) c.links[i] = home_links[i];
  }
  if (KIND == kSsdCache || assoc) {
    if (L[L_FRAMES] >= 0)
      for (int i = tid; i < nf; i += kThreads) c.frames[i] = ptrs.frames[i];
  }
  if (kFlash) {
    if (L[L_L2P] >= 0)
      for (long long i = tid; i < num_pages; i += kThreads)
        c.l2p[i] = ptrs.l2p[i];
  }
  if (gc) {
    if (L[L_VALID] >= 0)
      for (int i = tid; i < nb; i += kThreads) c.valid[i] = ptrs.valid[i];
    if (L[L_FREE_MASK] >= 0)
      for (int i = tid; i < nb; i += kThreads)
        c.free_mask[i] = ptrs.free_mask[i];
    if (L[L_FREE_Q] >= 0)
      for (int i = tid; i < nb; i += kThreads) c.free_q[i] = ptrs.free_q[i];
    if (L[L_P2L] >= 0)
      for (long long i = tid; i < nb * ppb; i += kThreads)
        c.p2l[i] = ptrs.p2l[i];
    if (nand) {
      for (int w = tid; w < rwords; w += kThreads) {
        uint32_t bits = 0;
        for (int b = 0; b < 32 && 32 * w + b < nb; ++b)
          bits |= static_cast<uint32_t>(ptrs.rtr_mask[32 * w + b] != 0) << b;
        c.retired[w] = bits;
      }
    }
  }

  // thread 0's registers
  if (tid == 0) {
    c.H = H;
    // a sweep's capacity lane: the victim order runs over the cache's
    // first `cap` frames, the others disabled (a standalone cache's cap is
    // its frame count; reading it there cost Table I 2% on the card)
    c.nf = SWEEP ? static_cast<int>(a[A_CAP]) : nf;
    c.nm = nm;
    c.nw = nw;
    c.nm8 = nm8;
    c.nw8 = nw8;
    c.nb = nb;
    c.leaves = static_cast<int>(leaves);
    int depth = 0;
    while ((1LL << depth) < leaves) ++depth;
    c.depth = depth;
    c.ecmp = !faulted && R > 1;
    c.rd_key = static_cast<unsigned long long>(a[A_RD_KEY]);
    c.rd_thresh = static_cast<unsigned long long>(a[A_RD_THRESH]);
    c.rd_max = static_cast<unsigned long long>(a[A_RD_MAX] > 0 ? a[A_RD_MAX]
                                                              : 1);
    c.er_key = static_cast<unsigned long long>(a[A_ER_KEY]);
    c.er_thresh = static_cast<unsigned long long>(a[A_ER_THRESH]);
    c.posted_writes = a[A_POSTED] != 0;
    c.assoc = assoc;
    c.lru = KIND == kSsdBuf || a[A_IS_LRU] != 0;
    c.gc = gc;
    c.issue_ov = a[A_ISSUE_OV];
    c.rt_extra = a[A_RT_EXTRA];
    c.occ = a[A_OCC];
    c.load = a[A_LOAD];
    c.pack = a[A_PACK];
    c.lat_rm = a[A_LAT_R_MISS];
    c.lat_rh = a[A_LAT_R_HIT];
    c.lat_wm = a[A_LAT_W_MISS];
    c.lat_wh = a[A_LAT_W_HIT];
    c.hil_ov = a[A_HIL_OV];
    c.xfer_page = a[A_XFER_PAGE];
    c.read_t = a[A_READ_T];
    c.prog_t = a[A_PROG_T];
    c.sus_t = a[A_SUS_T];
    c.erase_t = a[A_ERASE_T];
    c.internal = a[A_INTERNAL];
    c.hit_lat = a[A_HIT_LAT];
    c.line_xfer = a[A_LINE_XFER];
    c.page_xfer = a[A_PAGE_XFER];
    c.pack10 = a[A_PACK10];
    c.watermark = a[A_WATERMARK];
    c.ppb = ppb;
    c.C.set(a[A_CHANNELS]);
    c.D.set(a[A_DIES]);
    c.PPB.set(ppb);
    const long long* s = ptrs.scal;
    c.busy = s[S_BUSY];
    c.row = s[S_ROW];
    c.dram_busy = s[S_DRAM_BUSY];
    c.wpb = s[S_WPB];
    c.wpp = s[S_WPP];
    c.nfree = s[S_NFREE];
    c.fq_head = s[S_FQ_HEAD];
    c.fq_count = s[S_FQ_COUNT];
    c.gcs = s[S_GCS];
    c.bad = s[S_BAD];
    c.c_hr = s[S_C_HR];
    c.c_hw = s[S_C_HW];
    c.c_gw = s[S_C_GW];
    c.c_ge = s[S_C_GE];
    c.rd_seq = s[S_RD_SEQ];
    c.er_seq = s[S_ER_SEQ];
    c.c_rr = s[S_C_RR];
    c.c_rb = s[S_C_RB];
    c.fill = 0;
    c.head = c.tail = -1;
    c.mmin = kBig;
    for (int i = 0; i < nm; ++i) c.mmin = min64(c.mmin, ptrs.mready[i]);
    c.win = make_longlong2(start, 0);
    c.now = start;
    if (resume) {
      c.fill = static_cast<int>(carry[C_FILL]);
      c.head = static_cast<int>(carry[C_HEAD]);
      c.tail = static_cast<int>(carry[C_TAIL]);
      c.win = make_longlong2(cslots[0], 0);     // the tree's root
      for (int k = 1; k < K; ++k)
        if (cslots[k] < c.win.x) c.win = make_longlong2(cslots[k], k);
      c.now = carry[C_NOW];
    }
  }

  // the chunks, double buffered: while thread 0 walks chunk q from buffer
  // q & 1, warps 1-3 stage chunk q + 1 into the other buffer and flush
  // chunk q - 1 out of it
  long long* in_key = reinterpret_cast<long long*>(sm + L[L_IN_KEY]);
  int32_t* in_aux = reinterpret_cast<int32_t*>(sm + L[L_IN_AUX]);
  int32_t* in_set = reinterpret_cast<int32_t*>(sm + L[L_IN_SET]);
  uint8_t* in_rt = reinterpret_cast<uint8_t*>(sm + L[L_IN_RT]);
  long long* o_issue = reinterpret_cast<long long*>(sm + L[L_OUT_ISSUE]);
  long long* o_done = reinterpret_cast<long long*>(sm + L[L_OUT_DONE]);
  int32_t* o_flags = reinterpret_cast<int32_t*>(sm + L[L_OUT_FLAGS]);
  const long long chunks = (n + chunk - 1) / chunk;
  const long long page_bytes = a[A_PAGE_BYTES], row_bytes = a[A_ROW_BYTES];
  const long long cap = a[A_CAP];
  const bool direct = KIND == kSsdCache && !a[A_ASSOC];
  auto span = [&](long long q) {
    return static_cast<int>(min64(n - q * chunk, chunk));
  };
  auto stage = [&](long long q) {
    const long long g = q * chunk;
    const int m = span(q);
    const int b = static_cast<int>(q & 1) * chunk;
    for (int j = tid - 32; j < m; j += kStagers) {
      const long long addr = ptrs.addrs[g + j];
      long long key = 0;
      if (KIND == kPmem) key = addr / row_bytes;
      if (kFlash) key = addr / page_bytes;
      in_key[b + j] = key;
      in_aux[b + j] = (ptrs.writes[g + j] != 0 ? 1 : 0) |
                      (ptrs.routes ? ptrs.routes[g + j] << 1 : 0);
      in_set[b + j] = direct ? static_cast<int32_t>(key % cap) : 0;
      if (faulted)
        for (int h = 0; h < H; ++h)
          in_rt[(b + j) * H + h] = ptrs.retries[(g + j) * H + h];
    }
  };
  auto flush = [&](long long q) {
    const long long g = q * chunk;
    const int m = span(q);
    const int b = static_cast<int>(q & 1) * chunk;
    for (int j = tid - 32; j < m; j += kStagers) {
      ptrs.issues[g + j] = o_issue[b + j];
      ptrs.dones[g + j] = o_done[b + j];
      ptrs.flags[g + j] = o_flags[b + j];
    }
  };
  if (tid >= 32) stage(0);
  block_sync();
  if (tid == 0) SCAN_PHASE_BEGIN();
  for (long long q = 0; q < chunks; ++q) {
    if (tid == 0) {
      const int b = static_cast<int>(q & 1) * chunk;
      c.template walk<KIND, FAULTED>(
          span(q), seen + q * chunk, in_key + b, in_aux + b, in_set + b,
          in_rt + static_cast<long long>(b) * H, o_issue + b, o_done + b,
          o_flags + b);
    } else if (tid >= 32) {
      if (q + 1 < chunks) stage(q + 1);
      if (q > 0) flush(q - 1);
    }
    block_sync();
  }
  if (tid == 0) SCAN_PHASE_END();

  // epilogue: the last chunk's outputs, the totals, the scalars and the
  // shared-memory state back out
  if (tid >= 32) flush(chunks - 1);
  for (int i = tid; i < P; i += kThreads) {
    ptrs.totals[i] = c.qacc[i];
    ptrs.totals[P + i] = c.qthr[i];
  }
  for (int i = tid; i < nm; i += kThreads) {
    ptrs.mpage[i] = c.mpage[i];
    ptrs.mready[i] = c.mready[i];
  }
  for (int i = tid; i < nw; i += kThreads) ptrs.wtick[i] = c.wtick[i];
  for (int i = tid; i < dies; i += kThreads) {
    ptrs.die_busy[i] = c.die_busy[i];
    ptrs.die_prog[i] = c.die_prog[i];
  }
  for (int i = tid; i < chans; i += kThreads)
    ptrs.chan_busy[i] = c.chan_busy[i];
  if (KIND == kSsdCache || assoc) {
    if (L[L_FRAMES] >= 0)
      for (int i = tid; i < nf; i += kThreads) ptrs.frames[i] = c.frames[i];
  }
  if (kFlash) {
    if (L[L_L2P] >= 0)
      for (long long i = tid; i < num_pages; i += kThreads)
        ptrs.l2p[i] = c.l2p[i];
  }
  if (gc) {
    if (L[L_VALID] >= 0)
      for (int i = tid; i < nb; i += kThreads) ptrs.valid[i] = c.valid[i];
    if (L[L_FREE_MASK] >= 0)
      for (int i = tid; i < nb; i += kThreads)
        ptrs.free_mask[i] = c.free_mask[i];
    if (L[L_FREE_Q] >= 0)
      for (int i = tid; i < nb; i += kThreads) ptrs.free_q[i] = c.free_q[i];
    if (L[L_P2L] >= 0)
      for (long long i = tid; i < nb * ppb; i += kThreads)
        ptrs.p2l[i] = c.p2l[i];
    if (nand)
      for (int i = tid; i < nb; i += kThreads)
        ptrs.rtr_mask[i] = (c.retired[i >> 5] >> (i & 31)) & 1u;
  }
  if (CARRY) {
    // the carry out: slots (the tree's leaves), ports, map and links
    for (int k = tid; k < K; k += kThreads)
      cslots[k] = c.tree[leaves + k].x;
    for (int i = tid; i < P; i += kThreads) {
      long long* cp = cslots + K;
      cp[i] = c.pb[i];
      cp[P + i] = c.qacc[i];
      cp[2 * P + i] = c.qthr[i];
      if (faulted) cp[3 * P + i] = c.vft[i];
    }
    if (assoc && L[L_WHERE] >= 0)
      for (long long i = tid; i < num_pages; i += kThreads)
        home_where[i] = c.where[i];
    if (lru_links && L[L_LINKS] >= 0)
      for (int i = tid; i < nf; i += kThreads) home_links[i] = c.links[i];
    if (tid == 0) {
      carry[C_SEEN] = seen + n;
      carry[C_NOW] = c.now;
      carry[C_FILL] = c.fill;
      carry[C_HEAD] = c.head;
      carry[C_TAIL] = c.tail;
    }
  }
  if (tid == 0) {
    long long* s = ptrs.scal;
    s[S_BUSY] = c.busy;
    s[S_ROW] = c.row;
    s[S_DRAM_BUSY] = c.dram_busy;
    s[S_WPB] = c.wpb;
    s[S_WPP] = c.wpp;
    s[S_NFREE] = c.nfree;
    s[S_FQ_HEAD] = c.fq_head;
    s[S_FQ_COUNT] = c.fq_count;
    s[S_GCS] = c.gcs;
    s[S_BAD] = c.bad;
    s[S_C_HR] = c.c_hr;
    s[S_C_HW] = c.c_hw;
    s[S_C_GW] = c.c_gw;
    s[S_C_GE] = c.c_ge;
    s[S_RD_SEQ] = c.rd_seq;
    s[S_ER_SEQ] = c.er_seq;
    s[S_C_RR] = c.c_rr;
    s[S_C_RB] = c.c_rb;
  }
}

// ------------------------------------------------ the multi-host replay
// The JAX package's multi-host replay (src/repro/core/replay/multihost.py,
// `_make_multi_step` :349, a lax.scan and no Pallas kernel): several hosts'
// traces interleaved in issue order over shared ports and lane-stacked
// media and flash state.  Its plain twin is
// kernels/replay_scan.py::replay_multi_plain.  Thread 0 walks every step:
//   1. the host race: the earliest candidate max(now, LFB root), an
//      exhausted host at kBig, ties to the lowest host (a linear pass over
//      the hosts' candidates in shared memory);
//   2. that host's staged access (loaded from device memory the step it
//      became the host's next, so its latency hides behind that step) and
//      the root of its own LFB tree;
//   3. its route row: per hop the shared port's busy-until, with the QoS
//      mirror of SwitchPort.qos_update on a weighted port (the weight sum
//      in sorted-host order, __dadd_rn / __ddiv_rn / __dmul_rn, which nvcc
//      may neither contract nor reorder; the floor binds the final
//      acknowledgment only; the virtual clock paces on the clean
//      occupancy while the port charges the retries);
//   4. the target's media lane and that lane's flash lane, by moving the
//      chain's array pointers and scalars to them (saved back when the
//      lane changes), with one global stamp counter;
//   5. who, issue, done and flags of the step, stored straight to device
//      memory.
// The lanes' MSHR and writeback tables, die and channel busy-untils and
// scalars stay in shared memory; each placed array kind (map, frames,
// links, l2p, GC state) is in shared memory for every lane or for none, so
// no host's chain is cheaper than another's.  At full width (four Table I
// devices over a 64 MB footprint) only the frames fit; the rest stays in
// device memory, L2-resident.  Per-host staged windows are later work.
//
// The sharded instance (CLUSTER) replaces src/repro/core/replay/shard.py's
// shard_map body (`_body` :90-300): the hosts split over the D CTAs of one
// thread-block cluster, CTA r holding hosts r*H/D ... (r+1)*H/D - 1 (the
// reference's block assignment) with their trees, clocks, cursors,
// candidates, staged accesses, route rows (a table of its own, `mtab` row
// r) and media and private flash lanes in its own shared memory; every CTA
// keeps a replica of the ports' busy-untils, queueing and throttle totals
// and, under QoS, of the virtual-finish and last-arrival tables, and
// updates them from the same inputs, so the replicas never diverge
// (shard.py:176-217).  Each step is one election over the cluster:
//   1. thread 0 of each CTA races its own hosts as above and writes
//      {candidate tick, local host, its staged route row << 1 | write, its
//      retry bytes} into its slot (double-buffered by step parity: a CTA
//      that runs a step ahead cannot overwrite a slot another still
//      reads), then the cluster barrier;
//   2. every CTA reads the D slots through distributed shared memory and
//      takes the least tick, the lowest rank on ties.  Hosts are
//      block-assigned, so that is the global (tick, host index) order and
//      every D replays what the one-CTA instance replays, bit for bit.  The
//      winner's slot carries its row and retry bytes (the reference's
//      record broadcast, shard.py:140-172, with no second barrier), and
//      every CTA loads that row's hops from the owner's table (distributed
//      shared memory again, one round trip for all hops) and walks the
//      replicated ports;
//   3. only the owner runs the media step, commits its host's LFB slot,
//      stages its next access and stores the step's who / issue / done /
//      flags (the reference's `en` gate, :227-229).
// The other threads of every CTA wait at the same barrier once a step, and
// once more after the last, so no CTA leaves while another reads its
// shared memory.

// The multi-host argument block, field for field `MARGS` in
// kernels/replay_scan.py: a sharded instance's hosts, lanes, flash lanes
// and rows are its CTA's.
enum MArg { M_HOSTS, M_LANES, M_FLASH, M_STRIDE, M_QOS, M_ROWS, M_WINDOW,
            kNumMArgs };

// Its layout, field for field `LAYOUT_MULTI`: the trees' leaves, then byte
// offsets into dynamic shared memory; placed arrays as in Lay.
enum LayM {
  LM_LEAVES, LM_TREE, LM_HOST, LM_NEXT, LM_PB, LM_QACC, LM_QTHR, LM_VFT,
  LM_LAST, LM_MTAB, LM_MSCAL, LM_FSCAL, LM_MPAGE, LM_MREADY, LM_WTICK,
  LM_DIE_BUSY, LM_DIE_PROG, LM_CHAN_BUSY, LM_WHERE, LM_FRAMES, LM_LINKS,
  LM_L2P, LM_VALID, LM_FREE_MASK, LM_FREE_Q, LM_P2L, LM_RETIRED,
  kLayoutMultiWords
};

// A media lane's scalars in shared memory (MEDIA_SCALARS in the wrapper).
enum MScal { MS_BUSY, MS_ROW, MS_DRAM_BUSY, MS_FILL, MS_HEAD, MS_TAIL,
             MS_MMIN, kMScal = 8 };

constexpr long long kNever = -(1LL << 61);   // multihost.py's NEVER
// a sharded CTA's election region (after its hosts' arrays in LM_HOST):
// two slots of kElect words
// (by step parity), then a row buffer of the winner's hops (port, occ,
// after; kMaxHops each)
constexpr int kMaxHops = 8;
constexpr int kElect = 4;

struct MArgs {
  long long v[kNumMArgs];
};

struct LayoutM {
  long long v[kLayoutMultiWords];
};

// Device pointers of one multi-host replay.  The trace columns are (hosts,
// stride): device-local addresses, `aux` (route row << 1 | write) and, on
// the faulted lane, each access's retry bytes packed into an int64 (byte h
// for hop h); `mtab` the table (`multi_table` in the wrapper); the
// per-step outputs; `totals` qacc then qthr; `scal` the lanes' scalars (a
// row of kNumScalars a media lane, then a row a flash lane); the state's
// arrays, lane-stacked; `scratch` the map, links and retired bitmaps that
// the layout leaves in device memory; then the carry of a resumable replay
// (null for a one-launch replay) and the home of its lanes' maps and links.
// A resumable replay's trace columns are windows of `stride` accesses, each
// from its host's cursor as the launch begins.
struct MultiPtrs {
  const long long* addrs;
  const int32_t* aux;
  const long long* rt;
  const long long* mtab;
  int32_t* who;
  long long* issues;
  long long* dones;
  int32_t* flags;
  long long* totals;
  long long* scal;
  long long* frames;
  long long* mpage;
  long long* mready;
  long long* wtick;
  int32_t* l2p;
  int32_t* p2l;
  int32_t* valid;
  int32_t* free_q;
  uint8_t* free_mask;
  uint8_t* rtr_mask;
  long long* die_busy;
  long long* die_prog;
  long long* chan_busy;
  char* scratch;
  long long* carry;
  char* maps;
};

// The multi-host carry's words, field for field `multi_carry_words` in
// kernels/replay_scan.py: the steps replayed, then a host each its clock
// and cursor, its LFB slots (hosts x K), a port each the busy-until,
// queueing and throttle totals, the QoS tables (ports x hosts: virtual
// finish, last arrival), and a media lane each its fill pointer and
// recency head and tail.
struct MultiCarry {
  long long *now = nullptr, *idx = nullptr, *slots = nullptr, *pb = nullptr,
            *qacc = nullptr, *qthr = nullptr, *vft = nullptr,
            *last = nullptr, *lanes = nullptr;
  __device__ MultiCarry(long long* w, int NH, int K, int P) {
    if (!w) return;
    now = w + 1;
    idx = now + NH;
    slots = idx + NH;
    pb = slots + static_cast<long long>(NH) * K;
    qacc = pb + P;
    qthr = qacc + P;
    vft = qthr + P;
    last = vft + static_cast<long long>(P) * NH;
    lanes = last + static_cast<long long>(P) * NH;
  }
};

template <int KIND, bool NAND, bool FAULTED, bool CLUSTER = false>
__device__ void replay_multi(const Args& args, const MArgs& margs,
                             const LayoutM& lay, const MultiPtrs& ptrs,
                             char* sm) {
  const long long* a = args.v;
  const long long* ma = margs.v;
  const long long* L = lay.v;
  const int tid = thread_id();
  const int K = static_cast<int>(a[A_OUTSTANDING]);
  const int P = static_cast<int>(a[A_PORTS]);
  const int FH = static_cast<int>(a[A_HOPS]);
  const int NH = static_cast<int>(ma[M_HOSTS]);
  // every host of the replay, and this CTA's rank in a sharded one (its
  // hosts start at rank * NH)
  const int NA = CLUSTER ? NH * cluster_size() : NH;
  const int rank = CLUSTER ? cluster_rank() : 0;
  const int ND = static_cast<int>(ma[M_LANES]);
  const int NF = static_cast<int>(ma[M_FLASH]);
  const int R = static_cast<int>(ma[M_ROWS]);
  const long long stride = ma[M_STRIDE];
  const long long window = ma[M_WINDOW];
  const bool qos = ma[M_QOS] != 0;
  const int nm = static_cast<int>(a[A_MSHR]), nw = static_cast<int>(a[A_WB]);
  const int nm8 = (nm + kBlock - 1) / kBlock * kBlock;
  const int nw8 = (nw + kBlock - 1) / kBlock * kBlock;
  const int nf = static_cast<int>(KIND == kSsdBuf ? a[A_BUF] : a[A_FRAMES]);
  const int dies = static_cast<int>(a[A_CHANNELS] * a[A_DIES]);
  const int chans = static_cast<int>(a[A_CHANNELS]);
  const int nb = static_cast<int>(a[A_NUM_BLOCKS]);
  const long long num_pages = a[A_NUM_PAGES];
  const long long n = a[A_N], start = a[A_START];
  const long long leaves = L[LM_LEAVES];
  const long long ppb = a[A_PPB];
  constexpr bool kFlash = KIND == kSsdBuf || KIND == kSsdCache;
  const bool assoc = KIND == kSsdBuf || (KIND == kSsdCache && a[A_ASSOC]);
  const bool gc = kFlash && a[A_GC];
  const bool nand = kFlash && NAND;
  const int rwords = (nb + 31) / 32;
  const bool lru_links = KIND == kSsdBuf || (assoc && a[A_IS_LRU] != 0);
  const int shards = CLUSTER ? cluster_size() : 1;
  // a resumable replay: its carry; `seen` steps replayed before this launch
  // (the stamp base), resumed from the carry when > 0
  long long* carry = ptrs.carry;
  const long long seen = carry ? carry[0] : 0;
  const bool resume = seen > 0;
  const MultiCarry cw(carry, NH, K, P);
  int32_t* home_where = reinterpret_cast<int32_t*>(ptrs.maps);
  int2* home_links = reinterpret_cast<int2*>(
      ptrs.maps + links_home(static_cast<long long>(ND) * num_pages));

  // the table, copied to shared memory: lengths, host order (every host),
  // the lanes' flash lanes and DRAM timing, rows' lanes, the rows, and the
  // QoS mask and weights (ports x every host; a shard's table has them
  // under QoS only)
  long long* mt = reinterpret_cast<long long*>(sm + L[LM_MTAB]);
  const long long mwords =
      CLUSTER ? NH + NA + 4LL * ND + R + 3LL * R * FH +
                    (qos ? P + static_cast<long long>(P) * NA : 0LL)
              : 2LL * NH + 4LL * ND + R + 3LL * R * FH + P +
                    static_cast<long long>(P) * NH;
  const long long* lens = mt;
  const long long* host_order = mt + NH;
  const long long* flash_of = CLUSTER ? mt + NH + NA : mt + 2 * NH;
  const long long* dev_occ = flash_of + ND;
  const long long* dev_load = dev_occ + ND;
  const long long* dev_pack = dev_load + ND;
  const long long* row_dev = dev_pack + ND;
  const long long* hop_port = row_dev + R;
  const long long* hop_occ = hop_port + static_cast<long long>(R) * FH;
  const long long* hop_after = hop_occ + static_cast<long long>(R) * FH;
  const long long* qos_on = hop_after + static_cast<long long>(R) * FH;
  const double* qos_w = reinterpret_cast<const double*>(qos_on + P);

  longlong2* trees = reinterpret_cast<longlong2*>(sm + L[LM_TREE]);
  long long* h_now = reinterpret_cast<long long*>(sm + L[LM_HOST]);
  long long* h_idx = h_now + NH;
  long long* h_cand = h_idx + NH;
  long long* h_base = h_cand + NH;    // the cursors as the launch began
  long long* elect = h_base + NH;     // a sharded CTA's election region
  long long* x_addr = reinterpret_cast<long long*>(sm + L[LM_NEXT]);
  long long* x_aux = x_addr + NH;
  long long* x_rt = x_aux + NH;
  long long* pb = reinterpret_cast<long long*>(sm + L[LM_PB]);
  long long* qacc = reinterpret_cast<long long*>(sm + L[LM_QACC]);
  long long* qthr = reinterpret_cast<long long*>(sm + L[LM_QTHR]);
  long long* vft = reinterpret_cast<long long*>(sm + L[LM_VFT]);
  long long* last = reinterpret_cast<long long*>(sm + L[LM_LAST]);
  long long* mscal = reinterpret_cast<long long*>(sm + L[LM_MSCAL]);
  long long* fscal = reinterpret_cast<long long*>(sm + L[LM_FSCAL]);
  int32_t* mpage_b = reinterpret_cast<int32_t*>(sm + L[LM_MPAGE]);
  long long* mready_b = reinterpret_cast<long long*>(sm + L[LM_MREADY]);
  long long* wtick_b = reinterpret_cast<long long*>(sm + L[LM_WTICK]);
  long long* die_busy_b = reinterpret_cast<long long*>(sm + L[LM_DIE_BUSY]);
  long long* die_prog_b = reinterpret_cast<long long*>(sm + L[LM_DIE_PROG]);
  long long* chan_busy_b =
      reinterpret_cast<long long*>(sm + L[LM_CHAN_BUSY]);
  int32_t* where_b = placed(
      sm, L[LM_WHERE],
      carry ? home_where
            : reinterpret_cast<int32_t*>(ptrs.scratch - 1 - L[LM_WHERE]));
  long long* frames_b = placed(sm, L[LM_FRAMES], ptrs.frames);
  int2* links_b = placed(
      sm, L[LM_LINKS],
      carry ? home_links
            : reinterpret_cast<int2*>(ptrs.scratch - 1 - L[LM_LINKS]));
  int32_t* l2p_b = placed(sm, L[LM_L2P], ptrs.l2p);
  int32_t* valid_b = placed(sm, L[LM_VALID], ptrs.valid);
  uint8_t* free_mask_b = placed(sm, L[LM_FREE_MASK], ptrs.free_mask);
  int32_t* free_q_b = placed(sm, L[LM_FREE_Q], ptrs.free_q);
  int32_t* p2l_b = placed(sm, L[LM_P2L], ptrs.p2l);
  uint32_t* retired_b = placed(sm, L[LM_RETIRED], reinterpret_cast<uint32_t*>(
                                                      ptrs.scratch - 1 -
                                                      L[LM_RETIRED]));

  // prologue: the table; every host's tree at `start` (engine.py's
  // _init_carry, per host), clock, cursor, candidate and first access;
  // ports idle and QoS tables empty; the lanes' state copied in.  A
  // resumed replay takes the hosts' slots, clocks and cursors, the ports,
  // the QoS tables and the lanes' victim order from its carry.
  for (long long i = tid; i < mwords; i += kThreads) mt[i] = ptrs.mtab[i];
  for (long long i = tid; i < NH * 2 * leaves; i += kThreads) {
    const long long node = i % (2 * leaves);
    if (node == 0) {             // past the root: read, never used
      trees[i] = make_longlong2(kBig, 0);
      continue;
    }
    long long lo = node, span = 1;
    while (lo < leaves) {
      lo <<= 1;
      span <<= 1;
    }
    lo -= leaves;
    if (!resume) {
      trees[i] = make_longlong2(lo < K ? start : kBig, lo);
      continue;
    }
    const long long* sl = cw.slots + (i / (2 * leaves)) * K;
    longlong2 best = make_longlong2(kBig, lo);
    for (long long k = lo; k < lo + span && k < K; ++k)
      if (sl[k] < best.x) best = make_longlong2(sl[k], k);
    trees[i] = best;
  }
  for (int h = tid; h < NH; h += kThreads) {
    const long long len = ptrs.mtab[h];
    long long now = start, idx = 0, root = start;
    if (resume) {
      now = cw.now[h];
      idx = cw.idx[h];
      root = cw.slots[static_cast<long long>(h) * K];
      for (int k = 1; k < K; ++k)
        root = min64(root, cw.slots[static_cast<long long>(h) * K + k]);
    }
    const bool live = idx < len;
    h_now[h] = now;
    h_idx[h] = idx;
    h_base[h] = idx;
    h_cand[h] = live ? max64(now, root) : kBig;
    x_addr[h] = live ? ptrs.addrs[h * stride] : 0;
    x_aux[h] = live ? ptrs.aux[h * stride] : 0;
    x_rt[h] = live && FAULTED ? ptrs.rt[h * stride] : 0;
  }
  for (int i = tid; i < P; i += kThreads) {
    pb[i] = qacc[i] = qthr[i] = 0;
    if (resume) {
      pb[i] = cw.pb[i];
      qacc[i] = cw.qacc[i];
      qthr[i] = cw.qthr[i];
    }
  }
  if (qos) {
    for (long long i = tid; i < static_cast<long long>(P) * NA;
         i += kThreads) {
      vft[i] = resume ? cw.vft[i] : 0;
      last[i] = resume ? cw.last[i] : kNever;
    }
  }
  for (int i = tid; i < ND * nm8; i += kThreads) {
    const int d = i / nm8, e = i % nm8;
    mpage_b[i] = e < nm ? static_cast<int32_t>(ptrs.mpage[d * nm + e]) : -1;
    mready_b[i] = e < nm ? ptrs.mready[d * nm + e] : kBig;
  }
  for (int i = tid; i < ND * nw8; i += kThreads) {
    const int d = i / nw8, e = i % nw8;
    wtick_b[i] = e < nw ? ptrs.wtick[d * nw + e] : kFree;
  }
  for (int i = tid; i < NF * dies; i += kThreads) {
    die_busy_b[i] = ptrs.die_busy[i];
    die_prog_b[i] = ptrs.die_prog[i];
  }
  for (int i = tid; i < NF * chans; i += kThreads)
    chan_busy_b[i] = ptrs.chan_busy[i];
  if (assoc && !resume) {
    for (long long i = tid; i < ND * num_pages; i += kThreads)
      where_b[i] = -1;
    if (carry && lru_links)
      for (long long i = tid; i < static_cast<long long>(ND) * nf;
           i += kThreads)
        links_b[i] = make_int2(-1, -1);
  } else if (assoc) {
    if (L[LM_WHERE] >= 0)
      for (long long i = tid; i < ND * num_pages; i += kThreads)
        where_b[i] = home_where[i];
    if (lru_links && L[LM_LINKS] >= 0)
      for (long long i = tid; i < static_cast<long long>(ND) * nf;
           i += kThreads)
        links_b[i] = home_links[i];
  }
  if (KIND == kSsdCache || assoc) {
    if (L[LM_FRAMES] >= 0)
      for (long long i = tid; i < static_cast<long long>(ND) * nf;
           i += kThreads)
        frames_b[i] = ptrs.frames[i];
  }
  if (kFlash) {
    if (L[LM_L2P] >= 0)
      for (long long i = tid; i < NF * num_pages; i += kThreads)
        l2p_b[i] = ptrs.l2p[i];
  }
  if (gc) {
    if (L[LM_VALID] >= 0)
      for (int i = tid; i < NF * nb; i += kThreads) valid_b[i] = ptrs.valid[i];
    if (L[LM_FREE_MASK] >= 0)
      for (int i = tid; i < NF * nb; i += kThreads)
        free_mask_b[i] = ptrs.free_mask[i];
    if (L[LM_FREE_Q] >= 0)
      for (int i = tid; i < NF * nb; i += kThreads)
        free_q_b[i] = ptrs.free_q[i];
    if (L[LM_P2L] >= 0)
      for (long long i = tid; i < NF * nb * ppb; i += kThreads)
        p2l_b[i] = ptrs.p2l[i];
    if (nand) {
      for (int w = tid; w < NF * rwords; w += kThreads) {
        const int f = w / rwords, w0 = w % rwords;
        uint32_t bits = 0;
        for (int b = 0; b < 32 && 32 * w0 + b < nb; ++b)
          bits |= static_cast<uint32_t>(
                      ptrs.rtr_mask[f * nb + 32 * w0 + b] != 0)
                  << b;
        retired_b[w] = bits;
      }
    }
  }
  for (int d = tid; d < ND; d += kThreads) {
    long long* m = mscal + d * kMScal;
    const long long* s = ptrs.scal + d * kNumScalars;
    m[MS_BUSY] = s[S_BUSY];
    m[MS_ROW] = s[S_ROW];
    m[MS_DRAM_BUSY] = s[S_DRAM_BUSY];
    m[MS_FILL] = resume ? cw.lanes[3 * d] : 0;
    m[MS_HEAD] = resume ? cw.lanes[3 * d + 1] : -1;
    m[MS_TAIL] = resume ? cw.lanes[3 * d + 2] : -1;
    long long mmin = kBig;
    for (int e = 0; e < nm; ++e) mmin = min64(mmin, ptrs.mready[d * nm + e]);
    m[MS_MMIN] = mmin;
  }
  for (int i = tid; i < NF * kNumScalars; i += kThreads)
    fscal[i] = ptrs.scal[ND * kNumScalars + i];
  block_sync();

  if (tid == 0) {
    Chain<NAND> c;
    c.H = FH;
    c.nf = nf;
    c.nm = nm;
    c.nw = nw;
    c.nm8 = nm8;
    c.nw8 = nw8;
    c.nb = nb;
    c.leaves = static_cast<int>(leaves);
    int depth = 0;
    while ((1LL << depth) < leaves) ++depth;
    c.depth = depth;
    c.ecmp = false;
    c.rd_key = static_cast<unsigned long long>(a[A_RD_KEY]);
    c.rd_thresh = static_cast<unsigned long long>(a[A_RD_THRESH]);
    c.rd_max = static_cast<unsigned long long>(a[A_RD_MAX] > 0 ? a[A_RD_MAX]
                                                              : 1);
    c.er_key = static_cast<unsigned long long>(a[A_ER_KEY]);
    c.er_thresh = static_cast<unsigned long long>(a[A_ER_THRESH]);
    c.posted_writes = a[A_POSTED] != 0;
    c.assoc = assoc;
    c.lru = KIND == kSsdBuf || a[A_IS_LRU] != 0;
    c.gc = gc;
    c.issue_ov = a[A_ISSUE_OV];
    c.rt_extra = a[A_RT_EXTRA];
    c.occ = a[A_OCC];
    c.load = a[A_LOAD];
    c.pack = a[A_PACK];
    c.lat_rm = a[A_LAT_R_MISS];
    c.lat_rh = a[A_LAT_R_HIT];
    c.lat_wm = a[A_LAT_W_MISS];
    c.lat_wh = a[A_LAT_W_HIT];
    c.hil_ov = a[A_HIL_OV];
    c.xfer_page = a[A_XFER_PAGE];
    c.read_t = a[A_READ_T];
    c.prog_t = a[A_PROG_T];
    c.sus_t = a[A_SUS_T];
    c.erase_t = a[A_ERASE_T];
    c.internal = a[A_INTERNAL];
    c.hit_lat = a[A_HIT_LAT];
    c.line_xfer = a[A_LINE_XFER];
    c.page_xfer = a[A_PAGE_XFER];
    c.pack10 = a[A_PACK10];
    c.watermark = a[A_WATERMARK];
    c.ppb = ppb;
    c.C.set(a[A_CHANNELS]);
    c.D.set(a[A_DIES]);
    c.PPB.set(ppb);
    c.pb = pb;
    c.qacc = qacc;
    c.qthr = qthr;
    const long long page_bytes = a[A_PAGE_BYTES], row_bytes = a[A_ROW_BYTES];
    const long long cap = a[A_CAP];

    // the chain's lane: its array pointers and scalars move with it
    auto load_media = [&](int d) {
      c.frames = frames_b + static_cast<long long>(d) * nf;
      c.where = where_b + d * num_pages;
      c.links = links_b + static_cast<long long>(d) * nf;
      c.mpage = mpage_b + d * nm8;
      c.mready = mready_b + d * nm8;
      c.wtick = wtick_b + d * nw8;
      const long long* m = mscal + d * kMScal;
      c.busy = m[MS_BUSY];
      c.row = m[MS_ROW];
      c.dram_busy = m[MS_DRAM_BUSY];
      c.fill = static_cast<int>(m[MS_FILL]);
      c.head = static_cast<int>(m[MS_HEAD]);
      c.tail = static_cast<int>(m[MS_TAIL]);
      c.mmin = m[MS_MMIN];
      if (KIND == kDram) {
        c.occ = dev_occ[d];
        c.load = dev_load[d];
        c.pack = dev_pack[d];
      }
    };
    auto save_media = [&](int d) {
      long long* m = mscal + d * kMScal;
      m[MS_BUSY] = c.busy;
      m[MS_ROW] = c.row;
      m[MS_DRAM_BUSY] = c.dram_busy;
      m[MS_FILL] = c.fill;
      m[MS_HEAD] = c.head;
      m[MS_TAIL] = c.tail;
      m[MS_MMIN] = c.mmin;
    };
    auto load_flash = [&](int f) {
      c.l2p = l2p_b + f * num_pages;
      c.p2l = p2l_b + f * nb * ppb;
      c.valid = valid_b + f * nb;
      c.free_q = free_q_b + f * nb;
      c.free_mask = free_mask_b + f * nb;
      c.retired = retired_b + f * rwords;
      c.die_busy = die_busy_b + f * dies;
      c.die_prog = die_prog_b + f * dies;
      c.chan_busy = chan_busy_b + f * chans;
      const long long* s = fscal + f * kNumScalars;
      c.wpb = s[S_WPB];
      c.wpp = s[S_WPP];
      c.nfree = s[S_NFREE];
      c.fq_head = s[S_FQ_HEAD];
      c.fq_count = s[S_FQ_COUNT];
      c.gcs = s[S_GCS];
      c.bad = s[S_BAD];
      c.c_hr = s[S_C_HR];
      c.c_hw = s[S_C_HW];
      c.c_gw = s[S_C_GW];
      c.c_ge = s[S_C_GE];
      c.rd_seq = s[S_RD_SEQ];
      c.er_seq = s[S_ER_SEQ];
      c.c_rr = s[S_C_RR];
      c.c_rb = s[S_C_RB];
    };
    auto save_flash = [&](int f) {
      long long* s = fscal + f * kNumScalars;
      s[S_WPB] = c.wpb;
      s[S_WPP] = c.wpp;
      s[S_NFREE] = c.nfree;
      s[S_FQ_HEAD] = c.fq_head;
      s[S_FQ_COUNT] = c.fq_count;
      s[S_GCS] = c.gcs;
      s[S_BAD] = c.bad;
      s[S_C_HR] = c.c_hr;
      s[S_C_HW] = c.c_hw;
      s[S_C_GW] = c.c_gw;
      s[S_C_GE] = c.c_ge;
      s[S_RD_SEQ] = c.rd_seq;
      s[S_ER_SEQ] = c.er_seq;
      s[S_C_RR] = c.c_rr;
      s[S_C_RB] = c.c_rb;
    };

    int cm = -1, cf = -1;       // the chain's media and flash lanes
    if constexpr (CLUSTER) {
      // the sharded walk: each step an election over the cluster, the
      // replicated route walk, and the owner's media step
      for (long long s = 0; s < n; ++s) {
        // 1. the host race: the earliest candidate, the lowest host on ties
        int i = 0;
        long long issue = h_cand[0];
        for (int h = 1; h < NH; ++h) {
          const long long v = h_cand[h];
          if (v < issue) {
            issue = v;
            i = h;
          }
        }
        // the election: the CTAs' slots, the least tick, the lowest rank on
        // ties; the winner's slot brings its row and retries
        long long* slot = elect + kElect * (s & 1);
        slot[0] = issue;
        slot[1] = i;
        slot[2] = x_aux[i];
        slot[3] = x_rt[i];
        cluster_sync();
        int owner = 0;
        longlong2 best = make_longlong2(kBig + 1, 0), rec = best;
        for (int r = 0; r < shards; ++r) {
          const longlong2* q =
              reinterpret_cast<const longlong2*>(cluster_map(slot, r));
          const longlong2 v = q[0], x = q[1];
          if (v.x < best.x) {
            best = v;
            rec = x;
            owner = r;
          }
        }
        issue = best.x;
        i = static_cast<int>(best.y);
        const int aux = static_cast<int>(rec.x);
        const unsigned long long rtp = static_cast<unsigned long long>(rec.y);
        const bool own = owner == rank;
        const int gi = owner * NH + i;                 // the host's index
        // 2. the owner: its tree, its access, its next access loads now
        long long addr = 0, j = 0, n_addr = 0, n_aux = 0, n_rt = 0;
        bool more = false;
        if (own) {
          c.tree = trees + i * 2 * leaves;
          c.win = c.tree[1];
          addr = x_addr[i];
          j = h_idx[i] + 1;
          more = j < lens[i];
          // the next access, from the host's window: one that lies past it
          // is taken at the next launch, which this one's last step precedes
          // (a launch replays at most `stride` steps)
          const long long jw = j - h_base[i];
          if (more && jw < stride) {
            n_addr = ptrs.addrs[i * stride + jw];
            n_aux = ptrs.aux[i * stride + jw];
            if (FAULTED) n_rt = ptrs.rt[i * stride + jw];
          }
        }
        const bool wr = (aux & 1) != 0;
        const long long row = aux >> 1;
        // 3. the route over the shared ports, with the QoS mirror.  A
        // sharded replay's row lies in the owner's table: its hops come over
        // in one round trip into this CTA's row buffer
        long long* hp = elect + 2 * kElect;
        long long* ho = hp + kMaxHops;
        long long* ha = ho + kMaxHops;
        {
          const long long* rp = cluster_map(hop_port + row * FH, owner);
          const long long* ro = cluster_map(hop_occ + row * FH, owner);
          const long long* ra = cluster_map(hop_after + row * FH, owner);
          long long v[3][kMaxHops];
#pragma unroll
          for (int h = 0; h < kMaxHops; ++h) {
            v[0][h] = h < FH ? rp[h] : -1;
            v[1][h] = h < FH ? ro[h] : 0;
            v[2][h] = h < FH ? ra[h] : 0;
          }
#pragma unroll
          for (int h = 0; h < kMaxHops; ++h) {
            hp[h] = v[0][h];
            ho[h] = v[1][h];
            ha[h] = v[2][h];
          }
        }
        long long t = issue, floor = 0;
        for (int h = 0; h < FH; ++h) {
          const long long pi = hp[h];
          if (pi < 0) continue;
          const long long occ_c = ho[h];
          const long long after_h = ha[h];
          const long long occ_h =
              FAULTED ? occ_c * (1 + static_cast<long long>(
                                         (rtp >> (8 * h)) & 0xffull))
                      : occ_c;
          if (qos && qos_on[pi]) {
            const long long* last_p = last + pi * NA;
            const long long prev = vft[pi * NA + gi];
            const long long win = occ_c * window;
            double w_active = 0.0;
            for (int o = 0; o < NA; ++o) {
              const long long j_ = host_order[o];
              if (j_ == gi || last_p[j_] + win > t)
                w_active = __dadd_rn(w_active, qos_w[pi * NA + j_]);
            }
            const long long pace = static_cast<long long>(__dmul_rn(
                static_cast<double>(occ_c),
                __ddiv_rn(w_active, qos_w[pi * NA + gi])));
            if (prev > t) {
              floor = max64(floor, prev + pace);
              qthr[pi] += 1;
            }
            vft[pi * NA + gi] = max64(prev, t) + pace;
            last[pi * NA + gi] = t;
          }
          const long long st = max64(t, pb[pi]);
          qacc[pi] += st - t;
          pb[pi] = st + occ_h;
          t = st + occ_h + after_h;
        }
        t += c.rt_extra;
        if (!own) continue;
        // 4. the target's media lane and its flash lane
        const int d = static_cast<int>(row_dev[row]);
        if (d != cm) {
          if (cm >= 0) save_media(cm);
          load_media(d);
          cm = d;
        }
        if (kFlash) {
          const int f = static_cast<int>(flash_of[d]);
          if (f != cf) {
            if (cf >= 0) save_flash(cf);
            load_flash(f);
            cf = f;
          }
        }
        const bool posted = wr && c.posted_writes;
        const long long ctr = seen + s + 1;          // stamp counter: 1, 2, ...
        int flags = 0;
        long long done;
        if (KIND == kDram) {
          done = c.dram_step(t, posted);
        } else if (KIND == kPmem) {
          done = c.pmem_step(t, addr / row_bytes, wr, posted, &flags);
        } else {
          const long long page = addr / page_bytes;
          const long long early_ppn = c.l2p[page];
          if (KIND == kSsdBuf) {
            done = c.buf_step(t, page, wr, ctr, early_ppn, &flags);
          } else {
            const int set = static_cast<int>(assoc ? 0 : page % cap);
            done = c.cache_step(t, page, set, wr, posted, ctr, early_ppn,
                                &flags);
          }
        }
        if (qos) done = max64(done, floor);   // the ack floor alone
        // 5. the step's outputs; the host's commit and next candidate
        ptrs.who[s] = gi;
        ptrs.issues[s] = issue;
        ptrs.dones[s] = done;
        ptrs.flags[s] = flags;
        c.lfb_commit(done);
        const long long now_i = issue + c.issue_ov;
        h_now[i] = now_i;
        h_idx[i] = j;
        h_cand[i] = more ? max64(now_i, c.win.x) : kBig;
        if (more) {
          x_addr[i] = n_addr;
          x_aux[i] = n_aux;
          x_rt[i] = n_rt;
        }
      }
    } else {
      for (long long s = 0; s < n; ++s) {
        // 1. the host race: the earliest candidate, the lowest host on ties
        int i = 0;
        long long issue = h_cand[0];
        for (int h = 1; h < NH; ++h) {
          const long long v = h_cand[h];
          if (v < issue) {
            issue = v;
            i = h;
          }
        }
        // 2. its staged access and its tree; its next access loads now
        c.tree = trees + i * 2 * leaves;
        c.win = c.tree[1];
        const long long addr = x_addr[i];
        const int aux = static_cast<int>(x_aux[i]);
        const unsigned long long rtp = static_cast<unsigned long long>(x_rt[i]);
        const long long j = h_idx[i] + 1;
        const bool more = j < lens[i];
        // the next access, from the host's window: one that lies past it is
        // taken at the next launch, which this one's last step precedes (a
        // launch replays at most `stride` steps)
        const long long jw = j - h_base[i];
        long long n_addr = 0, n_aux = 0, n_rt = 0;
        if (more && jw < stride) {
          n_addr = ptrs.addrs[i * stride + jw];
          n_aux = ptrs.aux[i * stride + jw];
          if (FAULTED) n_rt = ptrs.rt[i * stride + jw];
        }
        const bool wr = (aux & 1) != 0;
        const long long row = aux >> 1;
        // 3. the route over the shared ports, with the QoS mirror
        long long t = issue, floor = 0;
        for (int h = 0; h < FH; ++h) {
          const long long pi = hop_port[row * FH + h];
          if (pi < 0) continue;
          const long long occ_c = hop_occ[row * FH + h];
          const long long after_h = hop_after[row * FH + h];
          const long long occ_h =
              FAULTED ? occ_c * (1 + static_cast<long long>(
                                         (rtp >> (8 * h)) & 0xffull))
                      : occ_c;
          if (qos && qos_on[pi]) {
            const long long* last_p = last + pi * NH;
            const long long prev = vft[pi * NH + i];
            const long long win = occ_c * window;
            double w_active = 0.0;
            for (int o = 0; o < NH; ++o) {
              const long long j_ = host_order[o];
              if (j_ == i || last_p[j_] + win > t)
                w_active = __dadd_rn(w_active, qos_w[pi * NH + j_]);
            }
            const long long pace = static_cast<long long>(__dmul_rn(
                static_cast<double>(occ_c),
                __ddiv_rn(w_active, qos_w[pi * NH + i])));
            if (prev > t) {
              floor = max64(floor, prev + pace);
              qthr[pi] += 1;
            }
            vft[pi * NH + i] = max64(prev, t) + pace;
            last[pi * NH + i] = t;
          }
          const long long st = max64(t, pb[pi]);
          qacc[pi] += st - t;
          pb[pi] = st + occ_h;
          t = st + occ_h + after_h;
        }
        t += c.rt_extra;
        // 4. the target's media lane and its flash lane
        const int d = static_cast<int>(row_dev[row]);
        if (d != cm) {
          if (cm >= 0) save_media(cm);
          load_media(d);
          cm = d;
        }
        if (kFlash) {
          const int f = static_cast<int>(flash_of[d]);
          if (f != cf) {
            if (cf >= 0) save_flash(cf);
            load_flash(f);
            cf = f;
          }
        }
        const bool posted = wr && c.posted_writes;
        const long long ctr = seen + s + 1;          // stamp counter: 1, 2, ...
        int flags = 0;
        long long done;
        if (KIND == kDram) {
          done = c.dram_step(t, posted);
        } else if (KIND == kPmem) {
          done = c.pmem_step(t, addr / row_bytes, wr, posted, &flags);
        } else {
          const long long page = addr / page_bytes;
          const long long early_ppn = c.l2p[page];
          if (KIND == kSsdBuf) {
            done = c.buf_step(t, page, wr, ctr, early_ppn, &flags);
          } else {
            const int set = static_cast<int>(assoc ? 0 : page % cap);
            done = c.cache_step(t, page, set, wr, posted, ctr, early_ppn,
                                &flags);
          }
        }
        if (qos) done = max64(done, floor);   // the ack floor alone
        // 5. the step's outputs; the host's commit and next candidate
        ptrs.who[s] = i;
        ptrs.issues[s] = issue;
        ptrs.dones[s] = done;
        ptrs.flags[s] = flags;
        c.lfb_commit(done);
        const long long now_i = issue + c.issue_ov;
        h_now[i] = now_i;
        h_idx[i] = j;
        h_cand[i] = more ? max64(now_i, c.win.x) : kBig;
        if (more) {
          x_addr[i] = n_addr;
          x_aux[i] = n_aux;
          x_rt[i] = n_rt;
        }
      }
    }
    if (cm >= 0) save_media(cm);
    if (kFlash && cf >= 0) save_flash(cf);
    if constexpr (CLUSTER) cluster_sync();   // no CTA leaves while read
  } else if constexpr (CLUSTER) {
    // the rest of the cluster's threads: the walk's barriers, and the last
    for (long long s = 0; s <= n; ++s) cluster_sync();
  }
  block_sync();

  // epilogue: the totals (rank 0's replica), the lanes' shared-memory
  // state and scalars out
  for (int i = tid; i < P && rank == 0; i += kThreads) {
    ptrs.totals[i] = qacc[i];
    ptrs.totals[P + i] = qthr[i];
  }
  for (int i = tid; i < ND * nm; i += kThreads) {
    const int d = i / nm, e = i % nm;
    ptrs.mpage[i] = mpage_b[d * nm8 + e];
    ptrs.mready[i] = mready_b[d * nm8 + e];
  }
  for (int i = tid; i < ND * nw; i += kThreads) {
    const int d = i / nw, e = i % nw;
    ptrs.wtick[i] = wtick_b[d * nw8 + e];
  }
  for (int i = tid; i < NF * dies; i += kThreads) {
    ptrs.die_busy[i] = die_busy_b[i];
    ptrs.die_prog[i] = die_prog_b[i];
  }
  for (int i = tid; i < NF * chans; i += kThreads)
    ptrs.chan_busy[i] = chan_busy_b[i];
  if (KIND == kSsdCache || assoc) {
    if (L[LM_FRAMES] >= 0)
      for (long long i = tid; i < static_cast<long long>(ND) * nf;
           i += kThreads)
        ptrs.frames[i] = frames_b[i];
  }
  if (kFlash) {
    if (L[LM_L2P] >= 0)
      for (long long i = tid; i < NF * num_pages; i += kThreads)
        ptrs.l2p[i] = l2p_b[i];
  }
  if (gc) {
    if (L[LM_VALID] >= 0)
      for (int i = tid; i < NF * nb; i += kThreads) ptrs.valid[i] = valid_b[i];
    if (L[LM_FREE_MASK] >= 0)
      for (int i = tid; i < NF * nb; i += kThreads)
        ptrs.free_mask[i] = free_mask_b[i];
    if (L[LM_FREE_Q] >= 0)
      for (int i = tid; i < NF * nb; i += kThreads)
        ptrs.free_q[i] = free_q_b[i];
    if (L[LM_P2L] >= 0)
      for (long long i = tid; i < NF * nb * ppb; i += kThreads)
        ptrs.p2l[i] = p2l_b[i];
    if (nand)
      for (int i = tid; i < NF * nb; i += kThreads) {
        const int f = i / nb, b = i % nb;
        ptrs.rtr_mask[i] = (retired_b[f * rwords + (b >> 5)] >> (b & 31)) & 1u;
      }
  }
  for (int d = tid; d < ND; d += kThreads) {
    long long* s = ptrs.scal + d * kNumScalars;
    const long long* m = mscal + d * kMScal;
    s[S_BUSY] = m[MS_BUSY];
    s[S_ROW] = m[MS_ROW];
    s[S_DRAM_BUSY] = m[MS_DRAM_BUSY];
  }
  for (int i = tid; i < NF * kNumScalars; i += kThreads)
    ptrs.scal[ND * kNumScalars + i] = fscal[i];
  if (carry) {
    // the carry out: the hosts' clocks, cursors and slots (their trees'
    // leaves), the ports, the QoS tables, the lanes' victim order, maps
    // and links
    for (int h = tid; h < NH; h += kThreads) {
      cw.now[h] = h_now[h];
      cw.idx[h] = h_idx[h];
    }
    for (long long i = tid; i < static_cast<long long>(NH) * K;
         i += kThreads)
      cw.slots[i] = trees[(i / K) * 2 * leaves + leaves + i % K].x;
    for (int i = tid; i < P; i += kThreads) {
      cw.pb[i] = pb[i];
      cw.qacc[i] = qacc[i];
      cw.qthr[i] = qthr[i];
    }
    if (qos)
      for (long long i = tid; i < static_cast<long long>(P) * NH;
           i += kThreads) {
        cw.vft[i] = vft[i];
        cw.last[i] = last[i];
      }
    for (int d = tid; d < ND; d += kThreads) {
      const long long* m = mscal + d * kMScal;
      cw.lanes[3 * d] = m[MS_FILL];
      cw.lanes[3 * d + 1] = m[MS_HEAD];
      cw.lanes[3 * d + 2] = m[MS_TAIL];
    }
    if (assoc && L[LM_WHERE] >= 0)
      for (long long i = tid; i < ND * num_pages; i += kThreads)
        home_where[i] = where_b[i];
    if (lru_links && L[LM_LINKS] >= 0)
      for (long long i = tid; i < static_cast<long long>(ND) * nf;
           i += kThreads)
        home_links[i] = links_b[i];
    if (tid == 0) carry[0] = seen + n;
  }
}

// ------------------------------------------------------------ the sweeps
// The JAX package's design-space sweeps (src/repro/core/replay/sweep.py:
// `cache_design_sweep` :96, `host_count_sweep` :178, `fault_seed_sweep`
// :262, each a jax.vmap of the replay over a batch of configurations).
// Their lanes are independent, so here they are a grid axis: one block a
// lane, every lane in one launch, each block running the replay above on
// its own lane (a kernel of its own, so that a one-launch replay runs
// exactly the code it ran before).  Lane b's argument block is row b of a
// (lanes, kNumArgs) table in device memory (the multi-host lane's table
// `mtab` likewise, a row a lane), and every pointer moves by b lane
// strides (`Strides`, in elements of its type; a stride of 0 shares the
// array among the lanes, as a trace shared by every lane is).  One layout
// serves every lane: the wrapper computes it over their union.  No lane
// carries: the reference's sweeps do not stream.  At Table I's ~217 KB of
// shared memory a block, an SM holds one lane, so up to 132 lanes run in
// one wave on an H100 and more run in waves.
//
// A capacity lane of the cache sweep keeps the cache's whole frame array:
// its first `cap` frames start free and the rest hold the reference's
// DISABLED word ((1 << 62) | the page field), which never matches a page
// and is never a victim; the victim order runs over the first `cap`
// frames (A_CAP, in the sweep's own instance of `replay`).  A multi-host
// lane's caches are the targets' own, every frame enabled.

constexpr int kNumPtrs = 26;        // the fields of Ptrs, and of MultiPtrs

struct Strides {
  long long v[kNumPtrs];
};

template <typename T>
__device__ __forceinline__ T* lane_at(T* p, long long stride, long long b) {
  return p ? p + stride * b : p;
}

// Lane b's pointers of a single-host sweep, field for field Ptrs (no
// carry, no home of the maps).
__device__ __forceinline__ Ptrs lane_ptrs(const Ptrs& p, const Strides& st,
                                          long long b) {
  const long long* s = st.v;
  return Ptrs{lane_at(p.addrs, s[0], b),      lane_at(p.writes, s[1], b),
              lane_at(p.routes, s[2], b),     lane_at(p.retries, s[3], b),
              lane_at(p.tables, s[4], b),     lane_at(p.issues, s[5], b),
              lane_at(p.dones, s[6], b),      lane_at(p.flags, s[7], b),
              lane_at(p.totals, s[8], b),     lane_at(p.scal, s[9], b),
              lane_at(p.frames, s[10], b),    lane_at(p.mpage, s[11], b),
              lane_at(p.mready, s[12], b),    lane_at(p.wtick, s[13], b),
              lane_at(p.l2p, s[14], b),       lane_at(p.p2l, s[15], b),
              lane_at(p.valid, s[16], b),     lane_at(p.free_q, s[17], b),
              lane_at(p.free_mask, s[18], b), lane_at(p.rtr_mask, s[19], b),
              lane_at(p.die_busy, s[20], b),  lane_at(p.die_prog, s[21], b),
              lane_at(p.chan_busy, s[22], b), lane_at(p.scratch, s[23], b),
              nullptr,                        nullptr};
}

// Lane b's pointers of a multi-host sweep, field for field MultiPtrs.
__device__ __forceinline__ MultiPtrs lane_multi_ptrs(const MultiPtrs& p,
                                                     const Strides& st,
                                                     long long b) {
  const long long* s = st.v;
  return MultiPtrs{
      lane_at(p.addrs, s[0], b),      lane_at(p.aux, s[1], b),
      lane_at(p.rt, s[2], b),         lane_at(p.mtab, s[3], b),
      lane_at(p.who, s[4], b),        lane_at(p.issues, s[5], b),
      lane_at(p.dones, s[6], b),      lane_at(p.flags, s[7], b),
      lane_at(p.totals, s[8], b),     lane_at(p.scal, s[9], b),
      lane_at(p.frames, s[10], b),    lane_at(p.mpage, s[11], b),
      lane_at(p.mready, s[12], b),    lane_at(p.wtick, s[13], b),
      lane_at(p.l2p, s[14], b),       lane_at(p.p2l, s[15], b),
      lane_at(p.valid, s[16], b),     lane_at(p.free_q, s[17], b),
      lane_at(p.free_mask, s[18], b), lane_at(p.rtr_mask, s[19], b),
      lane_at(p.die_busy, s[20], b),  lane_at(p.die_prog, s[21], b),
      lane_at(p.chan_busy, s[22], b), lane_at(p.scratch, s[23], b),
      nullptr,                        nullptr};
}

// Lane b of a single-host sweep: the cached CXL-SSD (with or without NAND
// statics; the reference's cache sweep takes no route column, so no ECMP
// and no transport faults).
template <bool NAND>
__device__ void sweep_lane(const long long* args, const Layout& lay,
                           const Ptrs& ptrs, const Strides& st, long long b,
                           char* sm) {
  const Args& a = *reinterpret_cast<const Args*>(args + b * kNumArgs);
  replay<kSsdCache, NAND, false, false, true>(a, lay, lane_ptrs(ptrs, st, b),
                                             sm);
}

// Lane b of a multi-host sweep.
template <int KIND, bool NAND, bool FAULTED>
__device__ void multi_sweep_lane(const long long* args, const MArgs& m,
                                 const LayoutM& lay, const MultiPtrs& ptrs,
                                 const Strides& st, long long b, char* sm) {
  const Args& a = *reinterpret_cast<const Args*>(args + b * kNumArgs);
  replay_multi<KIND, NAND, FAULTED>(a, m, lay, lane_multi_ptrs(ptrs, st, b),
                                    sm);
}

// CTA `cluster_rank()` of a sharded replay: the sharded instance of the
// multi-host replay on its shard's pointers (every pointer moved by rank
// shard strides; the step outputs and the totals are the cluster's, stride
// 0).
template <int KIND, bool NAND, bool FAULTED>
__device__ void shard_cta(const Args& a, const MArgs& m, const LayoutM& lay,
                          const MultiPtrs& ptrs, const Strides& st,
                          char* sm) {
  replay_multi<KIND, NAND, FAULTED, true>(
      a, m, lay, lane_multi_ptrs(ptrs, st, cluster_rank()), sm);
}

#ifndef REPLAY_SCAN_EMULATE
// One block of four warps an SM: the minimum of 1 lets ptxas give the
// walking thread the registers it wants.
template <int KIND, bool NAND, bool FAULTED, bool CARRY>
__global__ void __launch_bounds__(kThreads, 1)
replay_scan_kernel(const __grid_constant__ Args args,
                   const __grid_constant__ Layout lay, const Ptrs ptrs) {
  extern __shared__ __align__(16) char smem[];
  replay<KIND, NAND, FAULTED, CARRY>(args, lay, ptrs, smem);
}

template <int KIND, bool NAND, bool FAULTED, bool CARRY>
int launch(const Args& a, const Layout& lay, const Ptrs& p, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      replay_scan_kernel<KIND, NAND, FAULTED, CARRY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  replay_scan_kernel<KIND, NAND, FAULTED, CARRY>
      <<<1, kThreads, smem_bytes, stream>>>(a, lay, p);
  return static_cast<int>(cudaGetLastError());
}

// The instance of the stack's kind (NAND statics only on the flash kinds).
template <bool FAULTED, bool CARRY>
int launch_kind(const Args& a, const Layout& lay, const Ptrs& p,
                int smem_bytes, cudaStream_t s) {
  const bool nand = a.v[A_NAND] != 0;
  switch (a.v[A_KIND]) {
    case kDram:
      return launch<kDram, false, FAULTED, CARRY>(a, lay, p, smem_bytes, s);
    case kPmem:
      return launch<kPmem, false, FAULTED, CARRY>(a, lay, p, smem_bytes, s);
    case kSsdBuf:
      return nand ? launch<kSsdBuf, true, FAULTED, CARRY>(a, lay, p,
                                                          smem_bytes, s)
                  : launch<kSsdBuf, false, FAULTED, CARRY>(a, lay, p,
                                                           smem_bytes, s);
    default:
      return nand ? launch<kSsdCache, true, FAULTED, CARRY>(a, lay, p,
                                                            smem_bytes, s)
                  : launch<kSsdCache, false, FAULTED, CARRY>(a, lay, p,
                                                             smem_bytes, s);
  }
}

// The multi-host instances: a kernel of their own, so that a single-host
// replay runs exactly the code it ran before.
template <int KIND, bool NAND, bool FAULTED>
__global__ void __launch_bounds__(kThreads, 1)
replay_multi_kernel(const __grid_constant__ Args args,
                    const __grid_constant__ MArgs margs,
                    const __grid_constant__ LayoutM lay,
                    const MultiPtrs ptrs) {
  extern __shared__ __align__(16) char smem[];
  replay_multi<KIND, NAND, FAULTED>(args, margs, lay, ptrs, smem);
}

template <int KIND, bool NAND, bool FAULTED>
int launch_multi(const Args& a, const MArgs& m, const LayoutM& lay,
                 const MultiPtrs& p, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      replay_multi_kernel<KIND, NAND, FAULTED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  replay_multi_kernel<KIND, NAND, FAULTED>
      <<<1, kThreads, smem_bytes, stream>>>(a, m, lay, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAULTED>
int launch_multi_kind(const Args& a, const MArgs& m, const LayoutM& lay,
                      const MultiPtrs& p, int smem_bytes, cudaStream_t s) {
  const bool nand = a.v[A_NAND] != 0;
  switch (a.v[A_KIND]) {
    case kDram:
      return launch_multi<kDram, false, FAULTED>(a, m, lay, p, smem_bytes, s);
    case kPmem:
      return launch_multi<kPmem, false, FAULTED>(a, m, lay, p, smem_bytes, s);
    case kSsdBuf:
      return nand ? launch_multi<kSsdBuf, true, FAULTED>(a, m, lay, p,
                                                          smem_bytes, s)
                  : launch_multi<kSsdBuf, false, FAULTED>(a, m, lay, p,
                                                           smem_bytes, s);
    default:
      return nand ? launch_multi<kSsdCache, true, FAULTED>(a, m, lay, p,
                                                            smem_bytes, s)
                  : launch_multi<kSsdCache, false, FAULTED>(a, m, lay, p,
                                                             smem_bytes, s);
  }
}

// The sweep instances: one block a lane, `lanes` blocks.
template <bool NAND>
__global__ void __launch_bounds__(kThreads, 1)
replay_sweep_kernel(const long long* args,
                    const __grid_constant__ Layout lay,
                    const __grid_constant__ Ptrs ptrs,
                    const __grid_constant__ Strides st) {
  extern __shared__ __align__(16) char smem[];
  sweep_lane<NAND>(args, lay, ptrs, st, blockIdx.x, smem);
}

template <bool NAND>
int launch_sweep(int lanes, const long long* args, const Layout& lay,
                 const Ptrs& p, const Strides& st, int smem_bytes,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      replay_sweep_kernel<NAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  replay_sweep_kernel<NAND>
      <<<lanes, kThreads, smem_bytes, stream>>>(args, lay, p, st);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, bool NAND, bool FAULTED>
__global__ void __launch_bounds__(kThreads, 1)
replay_multi_sweep_kernel(const long long* args,
                          const __grid_constant__ MArgs margs,
                          const __grid_constant__ LayoutM lay,
                          const __grid_constant__ MultiPtrs ptrs,
                          const __grid_constant__ Strides st) {
  extern __shared__ __align__(16) char smem[];
  multi_sweep_lane<KIND, NAND, FAULTED>(args, margs, lay, ptrs, st,
                                        blockIdx.x, smem);
}

template <int KIND, bool NAND, bool FAULTED>
int launch_multi_sweep(int lanes, const long long* args, const MArgs& m,
                       const LayoutM& lay, const MultiPtrs& p,
                       const Strides& st, int smem_bytes,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      replay_multi_sweep_kernel<KIND, NAND, FAULTED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  replay_multi_sweep_kernel<KIND, NAND, FAULTED>
      <<<lanes, kThreads, smem_bytes, stream>>>(args, m, lay, p, st);
  return static_cast<int>(cudaGetLastError());
}

// The multi-host sweep instance of lane 0's kind (`head`, its argument
// block on the host; every lane shares the statics).
template <bool FAULTED>
int launch_multi_sweep_kind(int lanes, const long long* head,
                            const long long* args, const MArgs& m,
                            const LayoutM& lay, const MultiPtrs& p,
                            const Strides& st, int smem_bytes,
                            cudaStream_t s) {
  const bool nand = head[A_NAND] != 0;
  switch (head[A_KIND]) {
    case kDram:
      return launch_multi_sweep<kDram, false, FAULTED>(lanes, args, m, lay, p,
                                                       st, smem_bytes, s);
    case kPmem:
      return launch_multi_sweep<kPmem, false, FAULTED>(lanes, args, m, lay, p,
                                                       st, smem_bytes, s);
    case kSsdBuf:
      return nand ? launch_multi_sweep<kSsdBuf, true, FAULTED>(
                        lanes, args, m, lay, p, st, smem_bytes, s)
                  : launch_multi_sweep<kSsdBuf, false, FAULTED>(
                        lanes, args, m, lay, p, st, smem_bytes, s);
    default:
      return nand ? launch_multi_sweep<kSsdCache, true, FAULTED>(
                        lanes, args, m, lay, p, st, smem_bytes, s)
                  : launch_multi_sweep<kSsdCache, false, FAULTED>(
                        lanes, args, m, lay, p, st, smem_bytes, s);
  }
}

// The sharded instance: one thread-block cluster of `shards` CTAs, a shard
// each.
template <int KIND, bool NAND, bool FAULTED>
__global__ void __launch_bounds__(kThreads, 1)
replay_sharded_kernel(const __grid_constant__ Args args,
                      const __grid_constant__ MArgs margs,
                      const __grid_constant__ LayoutM lay,
                      const __grid_constant__ MultiPtrs ptrs,
                      const __grid_constant__ Strides st) {
  extern __shared__ __align__(16) char smem[];
  shard_cta<KIND, NAND, FAULTED>(args, margs, lay, ptrs, st, smem);
}

// Launch it on `stream` (cudaLaunchKernelEx with the cluster dimension),
// or, with `fit` given, launch nothing and report in fit[0] the clusters of
// `shards` CTAs that can be resident at once and in fit[1] the largest
// cluster the card can launch of this instance at `smem_bytes` a CTA
// (non-portable sizes, up to 16, allowed).
template <int KIND, bool NAND, bool FAULTED>
int launch_sharded(int shards, const Args& a, const MArgs& m,
                   const LayoutM& lay, const MultiPtrs& p, const Strides& st,
                   int smem_bytes, cudaStream_t stream, int* fit) {
  auto* kernel = replay_sharded_kernel<KIND, NAND, FAULTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shards, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shards;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fit) {
    err = cudaOccupancyMaxActiveClusters(&fit[0], kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t any = cfg;
    any.gridDim = dim3(16, 1, 1);
    any.numAttrs = 0;
    return static_cast<int>(
        cudaOccupancyMaxPotentialClusterSize(&fit[1], kernel, &any));
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a, m, lay, p, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAULTED>
int launch_sharded_kind(int shards, const Args& a, const MArgs& m,
                        const LayoutM& lay, const MultiPtrs& p,
                        const Strides& st, int smem_bytes, cudaStream_t s,
                        int* fit) {
  const bool nand = a.v[A_NAND] != 0;
  switch (a.v[A_KIND]) {
    case kDram:
      return launch_sharded<kDram, false, FAULTED>(shards, a, m, lay, p, st,
                                                   smem_bytes, s, fit);
    case kPmem:
      return launch_sharded<kPmem, false, FAULTED>(shards, a, m, lay, p, st,
                                                   smem_bytes, s, fit);
    case kSsdBuf:
      return nand ? launch_sharded<kSsdBuf, true, FAULTED>(
                        shards, a, m, lay, p, st, smem_bytes, s, fit)
                  : launch_sharded<kSsdBuf, false, FAULTED>(
                        shards, a, m, lay, p, st, smem_bytes, s, fit);
    default:
      return nand ? launch_sharded<kSsdCache, true, FAULTED>(
                        shards, a, m, lay, p, st, smem_bytes, s, fit)
                  : launch_sharded<kSsdCache, false, FAULTED>(
                        shards, a, m, lay, p, st, smem_bytes, s, fit);
  }
}
#endif

}  // namespace

#ifndef REPLAY_SCAN_EMULATE
extern "C" {

// Launch the replay of one trace (one block) on `stream`.  `args` and
// `layout` are the host arrays of the kNumArgs fields of the argument
// block and of the kLayoutWords fields of the layout; every other pointer
// is on the card (`carry` and `maps` null for a one-launch replay).  Returns the CUDA error code of the launch (0 on
// success); the kernel itself does not synchronise.
int replay_scan_launch(const long long* args, const long long* layout,
                       const long long* tables, const long long* addrs,
                       const uint8_t* writes, const int32_t* routes,
                       const uint8_t* retries, long long* issues,
                       long long* dones, int32_t* flags,
                       long long* totals, long long* scal, long long* frames,
                       long long* mpage, long long* mready, long long* wtick,
                       int32_t* l2p, int32_t* p2l, int32_t* valid,
                       int32_t* free_q, uint8_t* free_mask,
                       uint8_t* rtr_mask, long long* die_busy,
                       long long* die_prog, long long* chan_busy,
                       char* scratch, long long* carry, char* maps,
                       int smem_bytes, void* stream) {
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  Layout lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  const Ptrs p{addrs, writes, routes, retries, tables, issues, dones, flags,
               totals, scal, frames, mpage, mready, wtick, l2p, p2l, valid,
               free_q, free_mask, rtr_mask, die_busy, die_prog, chan_busy,
               scratch, carry, maps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (carry)
    return a.v[A_FAULT_HOPS] ? launch_kind<true, true>(a, lay, p, smem_bytes, s)
                             : launch_kind<false, true>(a, lay, p, smem_bytes,
                                                        s);
  return a.v[A_FAULT_HOPS] ? launch_kind<true, false>(a, lay, p, smem_bytes, s)
                           : launch_kind<false, false>(a, lay, p, smem_bytes,
                                                       s);
}

// Launch a multi-host replay (one block) on `stream`: `args`, `margs` and
// `layout` are host arrays (kNumArgs, kNumMArgs and kLayoutMultiWords
// fields); every other pointer is on the card (MultiPtrs, field for field).
int replay_scan_launch_multi(
    const long long* args, const long long* margs, const long long* layout,
    const long long* mtab, const long long* addrs, const int32_t* aux,
    const long long* rt, int32_t* who, long long* issues, long long* dones,
    int32_t* flags, long long* totals, long long* scal, long long* frames,
    long long* mpage, long long* mready, long long* wtick, int32_t* l2p,
    int32_t* p2l, int32_t* valid, int32_t* free_q, uint8_t* free_mask,
    uint8_t* rtr_mask, long long* die_busy, long long* die_prog,
    long long* chan_busy, char* scratch, long long* carry, char* maps,
    int smem_bytes, void* stream) {
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  MArgs m;
  memcpy(m.v, margs, sizeof(m.v));
  LayoutM lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  const MultiPtrs p{addrs, aux, rt, mtab, who, issues, dones, flags, totals,
                    scal, frames, mpage, mready, wtick, l2p, p2l, valid,
                    free_q, free_mask, rtr_mask, die_busy, die_prog,
                    chan_busy, scratch, carry, maps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.v[A_FAULT_HOPS] ? launch_multi_kind<true>(a, m, lay, p, smem_bytes,
                                                     s)
                           : launch_multi_kind<false>(a, m, lay, p,
                                                      smem_bytes, s);
}

// Launch a single-host sweep on `stream`: `lanes` blocks, lane b's
// argument block row b of `args` (on the card), `head` lane 0's (on the
// host, for the dispatch), `layout` and `strides` host arrays (kLayoutWords
// and kNumPtrs fields); every other pointer is on the card, Ptrs's fields
// but the route and retry columns, the carry and the maps (a sweep has
// none).  Only the cached CXL-SSD sweeps; any other kind returns
// cudaErrorInvalidValue.
int replay_scan_launch_sweep(
    int lanes, const long long* head, const long long* args,
    const long long* layout, const long long* strides,
    const long long* tables, const long long* addrs, const uint8_t* writes,
    long long* issues, long long* dones, int32_t* flags, long long* totals,
    long long* scal, long long* frames, long long* mpage, long long* mready,
    long long* wtick, int32_t* l2p, int32_t* p2l, int32_t* valid,
    int32_t* free_q, uint8_t* free_mask, uint8_t* rtr_mask,
    long long* die_busy, long long* die_prog, long long* chan_busy,
    char* scratch, int smem_bytes, void* stream) {
  if (head[A_KIND] != kSsdCache || head[A_FAULT_HOPS] || lanes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  Strides st;
  memcpy(st.v, strides, sizeof(st.v));
  const Ptrs p{addrs, writes, nullptr, nullptr, tables, issues, dones,
               flags, totals, scal, frames, mpage, mready, wtick, l2p, p2l,
               valid, free_q, free_mask, rtr_mask, die_busy, die_prog,
               chan_busy, scratch, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head[A_NAND] ? launch_sweep<true>(lanes, args, lay, p, st,
                                           smem_bytes, s)
                      : launch_sweep<false>(lanes, args, lay, p, st,
                                            smem_bytes, s);
}

// Launch a multi-host sweep on `stream`: `lanes` blocks, lane b's argument
// block and table rows b of `args` and `mtab` (on the card), `head` lane
// 0's argument block, `margs`, `layout` and `strides` host arrays; every
// other pointer is on the card, MultiPtrs's fields but the carry and the
// maps.
int replay_scan_launch_multi_sweep(
    int lanes, const long long* head, const long long* args,
    const long long* margs, const long long* layout, const long long* strides,
    const long long* mtab, const long long* addrs, const int32_t* aux,
    const long long* rt, int32_t* who, long long* issues, long long* dones,
    int32_t* flags, long long* totals, long long* scal, long long* frames,
    long long* mpage, long long* mready, long long* wtick, int32_t* l2p,
    int32_t* p2l, int32_t* valid, int32_t* free_q, uint8_t* free_mask,
    uint8_t* rtr_mask, long long* die_busy, long long* die_prog,
    long long* chan_busy, char* scratch, int smem_bytes, void* stream) {
  if (lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  MArgs m;
  memcpy(m.v, margs, sizeof(m.v));
  LayoutM lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  Strides st;
  memcpy(st.v, strides, sizeof(st.v));
  const MultiPtrs p{addrs, aux, rt, mtab, who, issues, dones, flags, totals,
                    scal, frames, mpage, mready, wtick, l2p, p2l, valid,
                    free_q, free_mask, rtr_mask, die_busy, die_prog,
                    chan_busy, scratch, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head[A_FAULT_HOPS]
             ? launch_multi_sweep_kind<true>(lanes, head, args, m, lay, p, st,
                                             smem_bytes, s)
             : launch_multi_sweep_kind<false>(lanes, head, args, m, lay, p,
                                              st, smem_bytes, s);
}

// Launch a sharded replay on `stream`: one cluster of `shards` CTAs, CTA r
// on shard r (every pointer moved by r `strides`).  `args`, `margs`,
// `layout` and `strides` are host arrays; every other pointer is on the
// card, MultiPtrs's fields but the carry and the maps (the sharded replay
// does not stream).
int replay_scan_launch_sharded(
    int shards, const long long* args, const long long* margs,
    const long long* layout, const long long* strides, const long long* mtab,
    const long long* addrs, const int32_t* aux, const long long* rt,
    int32_t* who, long long* issues, long long* dones, int32_t* flags,
    long long* totals, long long* scal, long long* frames, long long* mpage,
    long long* mready, long long* wtick, int32_t* l2p, int32_t* p2l,
    int32_t* valid, int32_t* free_q, uint8_t* free_mask, uint8_t* rtr_mask,
    long long* die_busy, long long* die_prog, long long* chan_busy,
    char* scratch, int smem_bytes, void* stream) {
  if (shards < 1 || shards > 16) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  MArgs m;
  memcpy(m.v, margs, sizeof(m.v));
  LayoutM lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  Strides st;
  memcpy(st.v, strides, sizeof(st.v));
  const MultiPtrs p{addrs, aux, rt, mtab, who, issues, dones, flags, totals,
                    scal, frames, mpage, mready, wtick, l2p, p2l, valid,
                    free_q, free_mask, rtr_mask, die_busy, die_prog,
                    chan_busy, scratch, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.v[A_FAULT_HOPS]
             ? launch_sharded_kind<true>(shards, a, m, lay, p, st, smem_bytes,
                                         s, nullptr)
             : launch_sharded_kind<false>(shards, a, m, lay, p, st,
                                          smem_bytes, s, nullptr);
}

// The sharded instance of `args`' kind at `smem_bytes` a CTA: the clusters
// of `shards` CTAs the card holds at once (*active) and its largest
// launchable cluster (*largest).
int replay_scan_sharded_fit(int shards, const long long* args,
                            int smem_bytes, int* active, int* largest) {
  if (shards < 1 || shards > 16) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  int fit[2] = {0, 0};
  const MArgs m{};
  const LayoutM lay{};
  const MultiPtrs p{};
  const Strides st{};
  const int err =
      a.v[A_FAULT_HOPS]
          ? launch_sharded_kind<true>(shards, a, m, lay, p, st, smem_bytes,
                                      nullptr, fit)
          : launch_sharded_kind<false>(shards, a, m, lay, p, st, smem_bytes,
                                       nullptr, fit);
  *active = fit[0];
  *largest = fit[1];
  return err;
}

// The argument blocks' and the layouts' lengths, for the wrapper to check.
int replay_scan_num_args() { return kNumArgs; }
int replay_scan_layout_words() { return kLayoutWords; }
int replay_scan_num_margs() { return kNumMArgs; }
int replay_scan_layout_multi_words() { return kLayoutMultiWords; }
int replay_scan_num_ptrs() { return kNumPtrs; }

// Largest dynamic shared memory a block may opt in to on `device`.
int replay_scan_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* replay_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif
