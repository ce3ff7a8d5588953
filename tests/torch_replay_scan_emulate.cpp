// A host build of src/repro_torch/kernels/csrc/replay_scan.cu: the same
// replay() source, its block emulated by kThreads std::threads, one per
// CUDA thread.
//
// REPLAY_SCAN_EMULATE leaves the block primitives (thread_id, block_sync),
// the intrinsics (__popc, __ffs, __umulhi, and the multi-host QoS mirror's
// __dadd_rn, __ddiv_rn, __dmul_rn: the host's IEEE double operations,
// which g++ does not contract without -ffast-math or an FMA target), the
// CUDA keywords and the vector types (int2, int4, longlong2) to this file.
// __syncthreads() becomes a barrier of the kThreads threads, so every
// thread sees the others' shared-memory stores exactly where the card's
// would.  Dynamic shared memory is a host buffer filled with a pattern, so
// a read before the kernel's own initialisation shows.  A thread-block
// cluster (the sharded instance) is its D blocks at once, D x kThreads
// threads: the cluster barrier is a barrier of all of them, a CTA's rank
// a thread-local, and distributed shared memory a pointer into the other
// block's buffer at the same offset.
//
// Built by tests/test_torch_scan_emulate.py with
//   g++ -std=c++20 -fsanitize=address -shared -fPIC -pthread
//       -I src/repro_torch/kernels/csrc
// so that every index the kernel forms is checked against its array.

#include <memory>  // before the keywords below: it spells __noinline__

#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __launch_bounds__(...)
#define __grid_constant__
#define REPLAY_SCAN_EMULATE

#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

struct int2 {
  int x, y;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) longlong2 {
  long long x, y;
};
inline int2 make_int2(int x, int y) { return {x, y}; }
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }

namespace {

thread_local int tl_thread;
thread_local std::barrier<>* tl_block;
thread_local int tl_rank;
thread_local char* tl_smem;
int g_shards = 1;
std::barrier<>* g_cluster;
std::vector<char*> g_smem;

int thread_id() { return tl_thread; }
void block_sync() { tl_block->arrive_and_wait(); }
int cluster_rank() { return tl_rank; }
int cluster_size() { return g_shards; }
void cluster_sync() { g_cluster->arrive_and_wait(); }
template <typename T>
const T* cluster_map(const T* p, int rank) {
  return reinterpret_cast<const T*>(
      g_smem[rank] + (reinterpret_cast<const char*>(p) - tl_smem));
}
int __popc(unsigned x) { return __builtin_popcount(x); }
int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<uint64_t>(a) * b) >> 32);
}
double __dadd_rn(double a, double b) { return a + b; }
double __ddiv_rn(double a, double b) { return a / b; }
double __dmul_rn(double a, double b) { return a * b; }

}  // namespace

#include "replay_scan.cu"

// The instance of replay() that the CUDA library's dispatch launches.
template <bool FAULTED, bool CARRY>
void run(const Args& a, const Layout& lay, const Ptrs& p, char* sm) {
  const bool nand = a.v[A_NAND] != 0;
  switch (a.v[A_KIND]) {
    case kDram: replay<kDram, false, FAULTED, CARRY>(a, lay, p, sm); break;
    case kPmem: replay<kPmem, false, FAULTED, CARRY>(a, lay, p, sm); break;
    case kSsdBuf:
      if (nand) replay<kSsdBuf, true, FAULTED, CARRY>(a, lay, p, sm);
      else replay<kSsdBuf, false, FAULTED, CARRY>(a, lay, p, sm);
      break;
    default:
      if (nand) replay<kSsdCache, true, FAULTED, CARRY>(a, lay, p, sm);
      else replay<kSsdCache, false, FAULTED, CARRY>(a, lay, p, sm);
      break;
  }
}

// The multi-host instance that the CUDA library's dispatch launches.
template <bool FAULTED>
void run_multi(const Args& a, const MArgs& m, const LayoutM& lay,
               const MultiPtrs& p, char* sm) {
  const bool nand = a.v[A_NAND] != 0;
  switch (a.v[A_KIND]) {
    case kDram: replay_multi<kDram, false, FAULTED>(a, m, lay, p, sm); break;
    case kPmem: replay_multi<kPmem, false, FAULTED>(a, m, lay, p, sm); break;
    case kSsdBuf:
      if (nand) replay_multi<kSsdBuf, true, FAULTED>(a, m, lay, p, sm);
      else replay_multi<kSsdBuf, false, FAULTED>(a, m, lay, p, sm);
      break;
    default:
      if (nand) replay_multi<kSsdCache, true, FAULTED>(a, m, lay, p, sm);
      else replay_multi<kSsdCache, false, FAULTED>(a, m, lay, p, sm);
      break;
  }
}

// The multi-host sweep instance that the CUDA library's dispatch launches,
// on lane b.
template <bool FAULTED>
void run_multi_sweep(const long long* head, const long long* args,
                     const MArgs& m, const LayoutM& lay, const MultiPtrs& p,
                     const Strides& st, long long b, char* sm) {
  const bool nand = head[A_NAND] != 0;
  switch (head[A_KIND]) {
    case kDram:
      multi_sweep_lane<kDram, false, FAULTED>(args, m, lay, p, st, b, sm);
      break;
    case kPmem:
      multi_sweep_lane<kPmem, false, FAULTED>(args, m, lay, p, st, b, sm);
      break;
    case kSsdBuf:
      if (nand)
        multi_sweep_lane<kSsdBuf, true, FAULTED>(args, m, lay, p, st, b, sm);
      else
        multi_sweep_lane<kSsdBuf, false, FAULTED>(args, m, lay, p, st, b, sm);
      break;
    default:
      if (nand)
        multi_sweep_lane<kSsdCache, true, FAULTED>(args, m, lay, p, st, b,
                                                   sm);
      else
        multi_sweep_lane<kSsdCache, false, FAULTED>(args, m, lay, p, st, b,
                                                    sm);
      break;
  }
}

// A cluster of `shards` blocks of kThreads threads, each block over a
// patterned host buffer as its shared memory, every thread running `body`.
template <typename F>
void run_cluster(int shards, int smem_bytes, F body) {
  std::vector<std::vector<longlong2>> smem(
      shards, std::vector<longlong2>((smem_bytes + 15) / 16,
                                     longlong2{0x5a5a5a5a5a5aLL,
                                               0x5a5a5a5a5a5aLL}));
  std::vector<std::unique_ptr<std::barrier<>>> blocks;
  g_smem.clear();
  for (int r = 0; r < shards; ++r) {
    blocks.push_back(std::make_unique<std::barrier<>>(kThreads));
    g_smem.push_back(reinterpret_cast<char*>(smem[r].data()));
  }
  std::barrier<> cluster(shards * kThreads);
  g_cluster = &cluster;
  g_shards = shards;
  std::vector<std::thread> threads;
  for (int r = 0; r < shards; ++r)
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([&, r, t] {
        tl_thread = t;
        tl_rank = r;
        tl_block = blocks[r].get();
        tl_smem = g_smem[r];
        body(tl_smem);
      });
  for (auto& t : threads) t.join();
  g_shards = 1;
}

// One block of kThreads threads.
template <typename F>
void run_block(int smem_bytes, F body) {
  run_cluster(1, smem_bytes, body);
}

// The sharded instance that the CUDA library's dispatch launches, on this
// thread's CTA of the cluster.
template <bool FAULTED>
void run_sharded(const Args& a, const MArgs& m, const LayoutM& lay,
                 const MultiPtrs& p, const Strides& st, char* sm) {
  const bool nand = a.v[A_NAND] != 0;
  switch (a.v[A_KIND]) {
    case kDram: shard_cta<kDram, false, FAULTED>(a, m, lay, p, st, sm); break;
    case kPmem: shard_cta<kPmem, false, FAULTED>(a, m, lay, p, st, sm); break;
    case kSsdBuf:
      if (nand) shard_cta<kSsdBuf, true, FAULTED>(a, m, lay, p, st, sm);
      else shard_cta<kSsdBuf, false, FAULTED>(a, m, lay, p, st, sm);
      break;
    default:
      if (nand) shard_cta<kSsdCache, true, FAULTED>(a, m, lay, p, st, sm);
      else shard_cta<kSsdCache, false, FAULTED>(a, m, lay, p, st, sm);
      break;
  }
}

extern "C" {

// The CUDA library's replay_scan_launch, argument for argument, on host
// pointers; `stream` is ignored.  Returns when the replay has ended.
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
  (void)stream;
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  Layout lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  const Ptrs p{addrs, writes, routes, retries, tables, issues, dones, flags,
               totals, scal, frames, mpage, mready, wtick, l2p, p2l, valid,
               free_q, free_mask, rtr_mask, die_busy, die_prog, chan_busy,
               scratch, carry, maps};
  run_block(smem_bytes, [&](char* sm) {
    if (carry) {
      if (a.v[A_FAULT_HOPS]) run<true, true>(a, lay, p, sm);
      else run<false, true>(a, lay, p, sm);
    } else {
      if (a.v[A_FAULT_HOPS]) run<true, false>(a, lay, p, sm);
      else run<false, false>(a, lay, p, sm);
    }
  });
  return 0;
}

// The CUDA library's replay_scan_launch_multi, argument for argument, on
// host pointers; `stream` is ignored.
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
  (void)stream;
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
  run_block(smem_bytes, [&](char* sm) {
    if (a.v[A_FAULT_HOPS]) run_multi<true>(a, m, lay, p, sm);
    else run_multi<false>(a, m, lay, p, sm);
  });
  return 0;
}

// The CUDA library's replay_scan_launch_sweep, argument for argument, on
// host pointers: the grid as its blocks one after another, each with its
// block index.
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
  (void)stream;
  if (head[A_KIND] != kSsdCache || head[A_FAULT_HOPS] || lanes < 1) return 1;
  Layout lay;
  memcpy(lay.v, layout, sizeof(lay.v));
  Strides st;
  memcpy(st.v, strides, sizeof(st.v));
  const Ptrs p{addrs, writes, nullptr, nullptr, tables, issues, dones,
               flags, totals, scal, frames, mpage, mready, wtick, l2p, p2l,
               valid, free_q, free_mask, rtr_mask, die_busy, die_prog,
               chan_busy, scratch, nullptr, nullptr};
  for (long long b = 0; b < lanes; ++b)
    run_block(smem_bytes, [&](char* sm) {
      if (head[A_NAND]) sweep_lane<true>(args, lay, p, st, b, sm);
      else sweep_lane<false>(args, lay, p, st, b, sm);
    });
  return 0;
}

// The CUDA library's replay_scan_launch_multi_sweep, on host pointers,
// block after block.
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
  (void)stream;
  if (lanes < 1) return 1;
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
  for (long long b = 0; b < lanes; ++b)
    run_block(smem_bytes, [&](char* sm) {
      if (head[A_FAULT_HOPS])
        run_multi_sweep<true>(head, args, m, lay, p, st, b, sm);
      else
        run_multi_sweep<false>(head, args, m, lay, p, st, b, sm);
    });
  return 0;
}

// The CUDA library's replay_scan_launch_sharded, argument for argument, on
// host pointers: the cluster's blocks at once.
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
  (void)stream;
  if (shards < 1 || shards > 16) return 1;
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
  run_cluster(shards, smem_bytes, [&](char* sm) {
    if (a.v[A_FAULT_HOPS]) run_sharded<true>(a, m, lay, p, st, sm);
    else run_sharded<false>(a, m, lay, p, st, sm);
  });
  return 0;
}

int replay_scan_num_args() { return kNumArgs; }
int replay_scan_layout_words() { return kLayoutWords; }
int replay_scan_num_margs() { return kNumMArgs; }
int replay_scan_layout_multi_words() { return kLayoutMultiWords; }
int replay_scan_num_ptrs() { return kNumPtrs; }

}  // extern "C"
