// The scan lane's stack replay on Hopper (sm_90a): one persistent warp walks
// a whole trace through the device stack, one access after another.
//
// Replaces the JAX package's per-access lax.scan, which is not a Pallas
// kernel: src/repro/core/replay/engine.py::_scan_chunk (:441, its step: LFB
// slot recycle, `_transport` :100 / `_transport_ecmp` :174 with the qacc /
// qthr accumulators) over src/repro/core/replay/stack.py::step (:611) and
// `media_step` (:578): `_dram_step`, `_pmem_step`, `_buf_step`,
// `_cache_step`, and under them `_hil_read` / `_hil_write`, `_alloc_ppn`,
// `_ftl_invalidate`, greedy GC `_collect`, the free-block FIFO and
// `_pal_read` / `_pal_prog` / `_pal_erase`.  Its plain twin, line for line
// the same arithmetic, is repro_torch/core/replay/stack.py::step under the
// loop of repro_torch/kernels/replay_scan.py::replay_scan_plain.
//
// What bounds it on this card: the serial chain.  Every access starts from
// the state the previous one left (LFB slots, port busy-untils, frames,
// flash busy-untils), so one trace is one chain on one SM; device memory
// moves ~29 bytes an access (address, write flag and route in; issue,
// done and flags out).  An access waits on a handful of dependent
// shared-memory round trips (the LFB argmin, the port hops, the frame
// scan's reduction, the commit), the warp's shuffle trees and, on a cache
// miss, on device-memory round trips into the flash state.
//
// What the design does about it: it keeps the chain on one warp.  All 32
// lanes run the scalar tick chain redundantly in registers (every branch
// is taken by the whole warp, so no lane waits on another to learn a
// decision) and share only the scans: the LFB argmin, the residency match
// and the victim argmin over the packed frames (one pass computes both),
// the MSHR and writeback reductions and the GC victim argmin are spread
// over the lanes and closed by a shuffle tree, with no block barrier.  The
// state's arrays are written by lane 0 between two __syncwarp()s, so that
// every lane has read the old value before it changes and reads the new
// one after.  LFB slots,
// port busy-untils and the qacc / qthr totals, the MSHR and writeback
// tables and the frames live in dynamic shared memory (Table I's 4096
// packed frames take 32 KB); frames that do not fit stay in the state
// tensor in device memory.  The flash state (l2p, p2l, valid counts, the
// free-block FIFO and mask, die and channel busy-untils) is the state
// tensors themselves, in device memory.
//
// Where the JAX reference's semantics need care:
//   * Ties.  jnp.argmin / argmax return the lowest index among ties: the
//     LFB slot (engine.py:461), the victim over packed frames (invalid
//     frames are -1, stack.py:358 and :434), the MSHR slot argmin(mpage)
//     (:459), the writeback slot argmin(wtick) (:449), the GC victim
//     (:189) and the first match of every residency / MSHR lookup.  Each
//     lane scans its indices in ascending order keeping the first winner,
//     and the shuffle tree keeps the lower index on equal values
//     (warp_argmin, warp_first).
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr long long kBig = 1LL << 62;
constexpr long long kFree = -1;
constexpr int kStampShift = 39;
constexpr long long kPageField = ((1LL << 38) - 1) << 1;
constexpr long long kStampField = -(1LL << kStampShift);
constexpr long long kInt32Max = 2147483647LL;

enum Kind { kDram = 0, kPmem = 1, kSsdBuf = 2, kSsdCache = 3 };

// The argument block, field for field `ARGS` in kernels/replay_scan.py.
enum Arg {
  A_KIND, A_N, A_START, A_OUTSTANDING, A_POSTED, A_HOPS, A_PORTS, A_ROUTES,
  A_PAGE_BYTES, A_FRAMES, A_ASSOC, A_MSHR, A_WB, A_CHANNELS, A_DIES, A_PPB,
  A_BUF, A_GC, A_NUM_BLOCKS, A_WATERMARK,
  A_ISSUE_OV, A_RT_EXTRA, A_OCC, A_LOAD, A_PACK, A_ROW_BYTES,
  A_LAT_R_MISS, A_LAT_R_HIT, A_LAT_W_MISS, A_LAT_W_HIT,
  A_HIL_OV, A_XFER_PAGE, A_READ_T, A_PROG_T, A_SUS_T, A_ERASE_T, A_INTERNAL,
  A_HIT_LAT, A_LINE_XFER, A_PAGE_XFER, A_PACK10, A_IS_LRU, A_CAP,
  A_FRAMES_IN_SMEM,
  kNumArgs
};

// The state's scalars, in and out, in the order of `SCALARS` in
// kernels/replay_scan.py.
enum Scalar {
  S_BUSY, S_ROW, S_DRAM_BUSY, S_WPB, S_WPP, S_NFREE, S_FQ_HEAD, S_FQ_COUNT,
  S_GCS, S_BAD, S_C_HR, S_C_HW, S_C_GW, S_C_GE, kNumScalars
};

struct Args {
  long long v[kNumArgs];
};

// Device pointers of one replay.  The trace and the per-access outputs;
// `tables` holds hop_port, hop_occ and hop_after (routes x hops each) and
// the per-port QoS mask; `totals` receives qacc then qthr (ports each);
// `scal` the state's scalars.  The rest are the state's arrays.
struct Ptrs {
  const long long* addrs;
  const uint8_t* writes;
  const int32_t* routes;
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
  long long* die_busy;
  long long* die_prog;
  long long* chan_busy;
};

// Defining REPLAY_SCAN_EMULATE leaves these four warp primitives, and the
// CUDA keywords, to the file that includes this one: a host compiler then
// builds the replay for a thread-per-lane emulation of the warp
// (tests/torch_replay_scan_emulate.cpp, run by
// tests/test_torch_scan_emulate.py under AddressSanitizer).
#ifndef REPLAY_SCAN_EMULATE
__device__ __forceinline__ int lane_id() { return threadIdx.x & (kLanes - 1); }
__device__ __forceinline__ void warp_sync() { __syncwarp(kFull); }
__device__ __forceinline__ long long shfl_xor(long long v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}
__device__ __forceinline__ int shfl_xor(int v, int m) {
  return __shfl_xor_sync(kFull, v, m);
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

// Lane 0 stores, once every lane has read what it needed (the value to
// store included); the warp then agrees on memory before anyone reads it.
template <typename T>
__device__ __forceinline__ void put(T* at, T v) {
  warp_sync();
  if (lane_id() == 0) *at = v;
  warp_sync();
}

struct MinIdx {
  long long v;
  int i;          // -1: this lane saw no element
};

// The warp's (min, lowest index of the min) from per-lane candidates, each
// lane's the first minimum of its ascending indices.
__device__ __forceinline__ MinIdx warp_min_idx(MinIdx m) {
  for (int off = kLanes / 2; off; off >>= 1) {
    const long long ov = shfl_xor(m.v, off);
    const int oi = shfl_xor(m.i, off);
    if (oi >= 0 && (m.i < 0 || ov < m.v || (ov == m.v && oi < m.i))) {
      m.v = ov;
      m.i = oi;
    }
  }
  return m;
}

// jnp.argmin over a[0, n): lowest index among ties.
__device__ __forceinline__ MinIdx warp_argmin(const long long* a, int n) {
  MinIdx m{0, -1};
  for (int i = lane_id(); i < n; i += kLanes) {
    const long long x = a[i];
    if (m.i < 0 || x < m.v) m = MinIdx{x, i};
  }
  return warp_min_idx(m);
}

// Lowest index of a lane candidate (n: none), over the warp.
__device__ __forceinline__ int warp_first(int i) {
  for (int off = kLanes / 2; off; off >>= 1) {
    const int o = shfl_xor(i, off);
    i = o < i ? o : i;
  }
  return i;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = kLanes / 2; off; off >>= 1) v += shfl_xor(v, off);
  return v;
}

// jnp.argmax(a == key) over a[0, n): the first match, or n when none.
__device__ __forceinline__ int warp_find(const long long* a, int n,
                                         long long key) {
  int first = n;
  for (int i = lane_id(); i < n; i += kLanes) {
    if (a[i] == key) { first = i; break; }
  }
  return warp_first(first);
}

// ------------------------------------------------------------ the replay
struct Replay {
  const long long* a;      // the argument block
  Ptrs p;
  // scalars of the state, the same value in every lane
  long long s[kNumScalars];

  __device__ long long arg(int k) const { return a[k]; }

  // ---------------------------------------------------------- PAL
  __device__ void die_of(long long ppn, long long* ch, long long* i) const {
    const long long C = arg(A_CHANNELS), D = arg(A_DIES);
    *ch = ppn % C;
    *i = *ch * D + (ppn / C) % D;
  }

  __device__ long long pal_read(long long t, long long ppn) {
    long long ch, i;
    die_of(ppn, &ch, &i);
    const long long dbi = p.die_busy[i], dpi = p.die_prog[i];
    const long long cbi = p.chan_busy[ch];
    long long ds = max64(t, dbi);
    if (dpi > ds) ds = min64(dpi, ds + arg(A_SUS_T));
    const long long array_done = ds + arg(A_READ_T);
    const long long new_dp = dpi > ds ? dpi + arg(A_READ_T) : dpi;
    const long long done = max64(array_done, cbi) + arg(A_XFER_PAGE);
    put(p.die_busy + i, done);
    put(p.die_prog + i, new_dp);
    put(p.chan_busy + ch, done);
    return done;
  }

  __device__ long long pal_prog(long long t, long long ppn) {
    long long ch, i;
    die_of(ppn, &ch, &i);
    const long long ds = max64(max64(t, p.die_busy[i]), p.die_prog[i]);
    const long long bus_done = max64(ds, p.chan_busy[ch]) + arg(A_XFER_PAGE);
    const long long done = bus_done + arg(A_PROG_T);
    put(p.die_busy + i, bus_done);
    put(p.die_prog + i, done);
    put(p.chan_busy + ch, bus_done);
    return done;
  }

  __device__ long long pal_erase(long long t, long long ppn) {
    long long ch, i;
    die_of(ppn, &ch, &i);
    const long long done =
        max64(max64(t, p.die_busy[i]), p.die_prog[i]) + arg(A_ERASE_T);
    put(p.die_busy + i, done);
    return done;
  }

  // ------------------------------------------------ free-block FIFO
  __device__ long long free_pop(bool en) {
    const long long nb = arg(A_NUM_BLOCKS);
    const long long head = s[S_FQ_HEAD], cnt = s[S_FQ_COUNT];
    const long long v = p.free_q[head];
    if (en) {
      s[S_FQ_HEAD] = (head + 1) % nb;
      s[S_FQ_COUNT] = cnt - 1;
      put(p.free_mask + v, uint8_t(0));
      if (cnt <= 0) s[S_BAD] = 1;
    }
    return v;
  }

  __device__ void free_append(long long v) {
    const long long cnt = s[S_FQ_COUNT];
    put(p.free_q + floor_mod(s[S_FQ_HEAD] + cnt, arg(A_NUM_BLOCKS)),
        int32_t(v));
    s[S_FQ_COUNT] = cnt + 1;
    put(p.free_mask + v, uint8_t(1));
  }

  // ------------------------------------------------------- FTL + GC
  __device__ long long collect(long long now) {
    const long long nb = arg(A_NUM_BLOCKS), ppb = arg(A_PPB);
    // greedy victim: fewest valid pages among blocks that are neither the
    // write block nor free, ties to the lowest block id
    MinIdx m{0, -1};
    int any = 0;
    for (int b = lane_id(); b < nb; b += kLanes) {
      const bool cand = b != s[S_WPB] && !p.free_mask[b];
      any |= cand;
      const long long score = cand ? p.valid[b] : kInt32Max;
      if (m.i < 0 || score < m.v) m = MinIdx{score, b};
    }
    m = warp_min_idx(m);
    const bool any_cand = warp_sum(any) > 0;
    const long long victim = m.i, base = victim * ppb;
    long long t = now;
    for (long long off = 0; off < ppb && any_cand; ++off) {
      const long long ppn = base + off;
      const long long lpn = p.p2l[ppn];
      if (lpn < 0) continue;
      t = pal_read(t, ppn);
      long long wpb = s[S_WPB], wpp = s[S_WPP];
      if (wpp >= ppb) {
        wpb = free_pop(true);
        wpp = 0;
      }
      const long long new_ppn = wpb * ppb + wpp;
      s[S_WPB] = wpb;
      s[S_WPP] = wpp + 1;
      t = pal_prog(t, new_ppn);
      put(p.p2l + ppn, int32_t(kFree));
      put(p.p2l + new_ppn, int32_t(lpn));
      put(p.l2p + lpn, int32_t(new_ppn));
      put(p.valid + new_ppn / ppb, p.valid[new_ppn / ppb] + 1);
      put(p.valid + victim, p.valid[victim] - 1);
      s[S_C_GW] += 1;
    }
    if (any_cand) {
      t = pal_erase(t, base);
      s[S_C_GE] += 1;
      free_append(victim);
    }
    return t;
  }

  __device__ void ftl_invalidate(long long lpn) {
    const long long old = p.l2p[lpn];
    if (old >= 0) {
      const long long b = old / arg(A_PPB);
      put(p.valid + b, p.valid[b] - 1);
      put(p.p2l + old, int32_t(kFree));
    }
  }

  // FTL._next_ppn; returns the ppn and sets *gc_done
  __device__ long long alloc_ppn(long long t, long long* gc_done) {
    const long long ppb = arg(A_PPB);
    const bool need = s[S_WPP] >= ppb;
    *gc_done = t;
    if (!arg(A_GC)) {
      long long wpb = s[S_WPB], wpp = s[S_WPP];
      if (need) {
        wpb = s[S_NFREE];
        wpp = 0;
        s[S_NFREE] += 1;
      }
      s[S_WPB] = wpb;
      s[S_WPP] = wpp + 1;
      return wpb * ppb + wpp;
    }
    if (need && s[S_FQ_COUNT] <= arg(A_WATERMARK)) {
      s[S_GCS] += 1;
      *gc_done = collect(t);
    }
    // `need` as taken before the collection, as in the reference
    const long long v = free_pop(need);
    const long long wpb = need ? v : s[S_WPB];
    const long long wpp = need ? 0 : s[S_WPP];
    s[S_WPB] = wpb;
    s[S_WPP] = wpp + 1;
    return wpb * ppb + wpp;
  }

  __device__ long long hil_write(long long t, long long lpn) {
    s[S_C_HW] += 1;
    if (arg(A_GC)) ftl_invalidate(lpn);
    long long t1;
    const long long ppn = alloc_ppn(t + arg(A_HIL_OV), &t1);
    put(p.l2p + lpn, int32_t(ppn));
    if (arg(A_GC)) {
      const long long b = ppn / arg(A_PPB);
      put(p.p2l + ppn, int32_t(lpn));
      put(p.valid + b, p.valid[b] + 1);
    }
    return pal_prog(t1, ppn);
  }

  __device__ long long hil_read(long long t, long long ppn) {
    s[S_C_HR] += 1;
    return pal_read(t + arg(A_HIL_OV), ppn);
  }

  // ---------------------------------------------------------- media
  // Each returns the completion tick and sets the event bits of `flags`:
  // 0 hit, 1 dirty evict, then FLAG_EVENT_BITS (metrics.py) of its kind.
  __device__ long long dram_step(long long t, bool posted) {
    const long long occ_done = max64(t, s[S_BUSY]) + arg(A_OCC);
    s[S_BUSY] = occ_done;
    return occ_done + (posted ? arg(A_PACK) : arg(A_LOAD));
  }

  __device__ long long pmem_step(long long t, long long addr, bool wr,
                                 bool posted, int* flags) {
    const long long row = addr / arg(A_ROW_BYTES);
    const bool row_hit = row == s[S_ROW];
    const long long occ_done = max64(t, s[S_BUSY]) + arg(A_OCC);
    s[S_BUSY] = occ_done;
    s[S_ROW] = row;
    *flags = row_hit ? 1 : 0;
    const long long lat = arg(A_LAT_R_MISS + 2 * int(wr) + int(row_hit));
    return occ_done + (posted ? arg(A_PACK) : lat);
  }

  // One pass over the packed frames: the first frame holding `pfield`
  // (n if none) and the argmin frame.
  __device__ void scan_frames(const long long* frames, int n, long long pfield,
                              int* fidx, MinIdx* vic) const {
    int first = n;
    MinIdx m{0, -1};
    for (int i = lane_id(); i < n; i += kLanes) {
      const long long x = frames[i];
      if (first == n && x >= 0 && (x & kPageField) == pfield) first = i;
      if (m.i < 0 || x < m.v) m = MinIdx{x, i};
    }
    *fidx = warp_first(first);
    *vic = warp_min_idx(m);
  }

  __device__ long long buf_step(long long* frames, long long t, long long addr,
                                bool wr, long long ctr, int* flags) {
    const int n = int(arg(A_BUF));
    const long long page = addr / arg(A_PAGE_BYTES);
    const long long pfield = page << 1;
    int fidx;
    MinIdx vic;
    scan_frames(frames, n, pfield, &fidx, &vic);
    long long done0 = t;
    if (fidx < n) {                                       // hit
      const long long old = frames[fidx];
      put(frames + fidx,
          (ctr << kStampShift) | pfield | ((old & 1) | (long long)wr));
      *flags = 1;
      return done0 + arg(A_INTERNAL);
    }
    const long long vval = vic.v;
    const bool flushed = vval >= 0 && (vval & 1) > 0;
    const long long ppn = p.l2p[page];
    const bool filled = ppn >= 0;
    if (filled) done0 = hil_read(t, ppn);
    if (flushed) hil_write(done0, (vval & kPageField) >> 1);
    put(frames + vic.i, (ctr << kStampShift) | pfield | (long long)wr);
    *flags = (flushed ? 2 : 0) | (filled ? 4 : 0);
    return done0 + arg(A_INTERNAL);
  }

  __device__ long long cache_step(long long* frames, long long* mpage,
                                  long long* mready, long long* wtick,
                                  long long t, long long addr, bool wr,
                                  bool posted, long long ctr, int* flags) {
    const int nf = int(arg(A_FRAMES)), nm = int(arg(A_MSHR));
    const int nw = int(arg(A_WB));
    const long long page = addr / arg(A_PAGE_BYTES);
    const long long pfield = page << 1;

    // MSHR lookup: an unmatched lookup reads slot 0, as jnp.argmax does
    int m_idx = warp_find(mpage, nm, page);
    const bool m_exists = m_idx < nm;
    if (!m_exists) m_idx = 0;
    const long long m_ready = mready[m_idx];
    const bool coalesce = m_exists && m_ready > t;

    // residency (and, in the same pass, the LRU/FIFO victim)
    int fidx;
    MinIdx vic{0, -1};
    bool resident;
    if (arg(A_ASSOC)) {
      scan_frames(frames, nf, pfield, &fidx, &vic);
      resident = fidx < nf;
      if (!resident) fidx = 0;
    } else {
      fidx = int(page % arg(A_CAP));
      const long long fv = frames[fidx];
      resident = fv >= 0 && (fv & kPageField) == pfield;
      vic = MinIdx{fv, fidx};
    }
    const bool hit = !coalesce && resident;
    const bool miss = !coalesce && !resident;
    const long long old = frames[fidx];
    const long long dram_busy = s[S_DRAM_BUSY];
    const long long xdone = max64(t, dram_busy) + arg(A_LINE_XFER);

    long long start2 = t, fill_done = t;
    bool do_wb = false, stalled = false, evicted = false;
    if (miss) {
      // MSHR allocate (stall if the table is full)
      long long used = 0;
      for (int i = lane_id(); i < nm; i += kLanes) used += mpage[i] >= 0;
      stalled = warp_sum(used) >= nm;
      long long start1 = t;
      if (stalled) {
        const long long vic_ready = warp_argmin(mready, nm).v;
        start1 = max64(t, vic_ready);
        for (int i = lane_id(); i < nm; i += kLanes) {
          if (mready[i] <= vic_ready) {
            mpage[i] = kFree;
            mready[i] = kBig;
          }
        }
        warp_sync();
      }
      const long long vval = vic.v;
      evicted = vval >= 0;
      do_wb = evicted && (vval & 1) > 0;
      long long stall = start1;
      if (do_wb) {
        // writeback queue: reap, stall on the earliest drain if full
        long long alive = 0, wmin = kBig;
        for (int i = lane_id(); i < nw; i += kLanes) {
          const long long w = wtick[i];
          if (w <= start1) {
            wtick[i] = kFree;
          } else {
            alive += 1;
            wmin = min64(wmin, w);
          }
        }
        warp_sync();
        alive = warp_sum(alive);
        for (int off = kLanes / 2; off; off >>= 1)
          wmin = min64(wmin, shfl_xor(wmin, off));
        if (alive >= nw) {
          stall = wmin;
          for (int i = lane_id(); i < nw; i += kLanes) {
            if (wtick[i] <= stall) wtick[i] = kFree;
          }
          warp_sync();
        }
        const long long wdone = hil_write(stall, (vval & kPageField) >> 1);
        put(wtick + warp_argmin(wtick, nw).i, wdone);
        start2 = max64(start1, stall);
      } else {
        start2 = start1;
      }
      // fill from flash (virgin pages skip the read), then cache-DRAM
      const long long ppn = p.l2p[page];
      const long long flash_done = ppn >= 0 ? hil_read(start2, ppn) : start2;
      fill_done = max64(flash_done, dram_busy) + arg(A_PAGE_XFER);
      // MSHR insert (an existing key is overwritten), then expiry
      const int slot = m_exists ? m_idx : warp_argmin(mpage, nm).i;
      put(mpage + slot, page);
      put(mready + slot, fill_done);
      for (int i = lane_id(); i < nm; i += kLanes) {
        if (mready[i] <= t) {
          mpage[i] = kFree;
          mready[i] = kBig;
        }
      }
      warp_sync();
      put(frames + vic.i, (ctr << kStampShift) | pfield | (long long)wr);
    } else if ((coalesce && wr && resident) || hit) {
      // touch: LRU restamps, FIFO keeps the insertion stamp
      const long long stamp =
          arg(A_IS_LRU) ? (ctr << kStampShift) : (old & kStampField);
      put(frames + fidx, stamp | pfield | ((old & 1) | (long long)wr));
    }

    if (hit) s[S_DRAM_BUSY] = xdone;
    else if (miss) s[S_DRAM_BUSY] = fill_done;
    const long long hit_lat = arg(A_HIT_LAT);
    long long ret;
    if (coalesce) {
      ret = wr ? t + hit_lat : m_ready + hit_lat;
    } else if (hit) {
      ret = wr ? (posted ? t + arg(A_PACK10) : t + hit_lat)
               : max64(xdone, t + hit_lat);
    } else {
      ret = wr ? start2 + hit_lat : fill_done + hit_lat;
    }
    *flags = (hit ? 1 : 0) | (do_wb ? 2 : 0) | (miss ? 4 : 0) |
             (coalesce ? 8 : 0) | (stalled ? 16 : 0) | (evicted ? 32 : 0);
    return max64(t, ret);
  }
};

// Shared-memory layout (int64 words): LFB slots, port busy-untils, qacc,
// qthr, then the MSHR pages and ready ticks and the writeback ticks, then
// the frames when they fit.
__device__ void replay(const Args& args, const Ptrs& ptrs, long long* sm) {
  Replay r;
  r.a = args.v;
  r.p = ptrs;
  const long long* a = args.v;
  const int K = int(a[A_OUTSTANDING]), P = int(a[A_PORTS]);
  const int H = int(a[A_HOPS]);
  const int nm = int(a[A_MSHR]), nw = int(a[A_WB]);
  const int nf = int(a[A_KIND] == kSsdBuf ? a[A_BUF] : a[A_FRAMES]);
  const long long n = a[A_N], start = a[A_START];
  const int kind = int(a[A_KIND]);
  const int lane = lane_id();

  long long* slots = sm;
  long long* pb = slots + K;
  long long* qacc = pb + P;
  long long* qthr = qacc + P;
  long long* mpage = qthr + P;
  long long* mready = mpage + nm;
  long long* wtick = mready + nm;
  long long* frames = ptrs.frames;
  if (a[A_FRAMES_IN_SMEM]) frames = wtick + nw;

  // prologue (engine.py::_init_carry): LFB slots at start, ports idle
  for (int i = lane; i < K; i += kLanes) slots[i] = start;
  for (int i = lane; i < P; i += kLanes) pb[i] = qacc[i] = qthr[i] = 0;
  for (int i = lane; i < nm; i += kLanes) {
    mpage[i] = ptrs.mpage[i];
    mready[i] = ptrs.mready[i];
  }
  for (int i = lane; i < nw; i += kLanes) wtick[i] = ptrs.wtick[i];
  if (a[A_FRAMES_IN_SMEM]) {
    for (int i = lane; i < nf; i += kLanes) frames[i] = ptrs.frames[i];
  }
  for (int k = 0; k < kNumScalars; ++k) r.s[k] = ptrs.scal[k];
  warp_sync();

  const long long* hop_port = ptrs.tables;
  const long long* hop_occ = hop_port + a[A_ROUTES] * H;
  const long long* hop_after = hop_occ + a[A_ROUTES] * H;
  const long long* qos = hop_after + a[A_ROUTES] * H;
  const bool ecmp = a[A_ROUTES] > 1;

  long long now = start;
  for (long long i = 0; i < n; ++i) {
    const long long addr = ptrs.addrs[i];
    const bool wr = ptrs.writes[i] != 0;
    const MinIdx k = warp_argmin(slots, K);
    const long long issue = max64(now, k.v);
    const bool posted = wr && a[A_POSTED];
    // transport: hop h of the route occupies port hop_port[route, h]
    long long t = issue;
    const long long row = ecmp ? (long long)ptrs.routes[i] * H : 0;
    for (int h = 0; h < H; ++h) {
      const long long pi = hop_port[row + h];
      const long long busy = pb[pi];
      if (qos[pi] && busy > t) put(qthr + pi, qthr[pi] + 1);
      const long long st = max64(t, busy);
      put(qacc + pi, qacc[pi] + (st - t));
      const long long done = st + hop_occ[row + h];
      put(pb + pi, done);
      t = done + hop_after[row + h];
    }
    t += a[A_RT_EXTRA];
    const long long ctr = i + 1;          // stamp counter: 1, 2, ...
    int flags = 0;
    long long done;
    switch (kind) {
      case kDram: done = r.dram_step(t, posted); break;
      case kPmem: done = r.pmem_step(t, addr, wr, posted, &flags); break;
      case kSsdBuf:
        done = r.buf_step(frames, t, addr, wr, ctr, &flags);
        break;
      default:
        done = r.cache_step(frames, mpage, mready, wtick, t, addr, wr, posted,
                            ctr, &flags);
        break;
    }
    if (lane == 0) {
      ptrs.issues[i] = issue;
      ptrs.dones[i] = done;
      ptrs.flags[i] = flags;
    }
    put(slots + k.i, done);
    now = issue + a[A_ISSUE_OV];
  }

  // epilogue: totals, scalars and the shared-memory state back out
  for (int i = lane; i < P; i += kLanes) {
    ptrs.totals[i] = qacc[i];
    ptrs.totals[P + i] = qthr[i];
  }
  for (int i = lane; i < nm; i += kLanes) {
    ptrs.mpage[i] = mpage[i];
    ptrs.mready[i] = mready[i];
  }
  for (int i = lane; i < nw; i += kLanes) ptrs.wtick[i] = wtick[i];
  if (a[A_FRAMES_IN_SMEM]) {
    for (int i = lane; i < nf; i += kLanes) ptrs.frames[i] = frames[i];
  }
  if (lane == 0) {
    for (int k = 0; k < kNumScalars; ++k) ptrs.scal[k] = r.s[k];
  }
}

#ifndef REPLAY_SCAN_EMULATE
__global__ void __launch_bounds__(kLanes)
replay_scan_kernel(const __grid_constant__ Args args, const Ptrs ptrs) {
  extern __shared__ long long smem[];
  replay(args, ptrs, smem);
}
#endif

}  // namespace

#ifndef REPLAY_SCAN_EMULATE
extern "C" {

// Launch the replay of one trace (one block of one warp) on `stream`.
// `args` is the host array of the kNumArgs fields of the argument block;
// every other pointer is on the card.  Returns the CUDA error code of the
// launch (0 on success); the kernel itself does not synchronise.
int replay_scan_launch(const long long* args, const long long* tables,
                       const long long* addrs, const uint8_t* writes,
                       const int32_t* routes, long long* issues,
                       long long* dones, int32_t* flags, long long* totals,
                       long long* scal, long long* frames, long long* mpage,
                       long long* mready, long long* wtick, int32_t* l2p,
                       int32_t* p2l, int32_t* valid, int32_t* free_q,
                       uint8_t* free_mask, long long* die_busy,
                       long long* die_prog, long long* chan_busy,
                       int smem_bytes, void* stream) {
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  const Ptrs p{addrs, writes, routes, tables, issues, dones, flags, totals,
               scal, frames, mpage, mready, wtick, l2p, p2l, valid, free_q,
               free_mask, die_busy, die_prog, chan_busy};
  cudaError_t err = cudaFuncSetAttribute(
      replay_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  replay_scan_kernel<<<1, kLanes, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

// The argument block's length (kNumArgs), for the wrapper to check.
int replay_scan_num_args() { return kNumArgs; }

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
