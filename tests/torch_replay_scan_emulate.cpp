// A host build of src/repro_torch/kernels/csrc/replay_scan.cu: the same
// replay() source, its warp emulated by 32 std::threads, one per lane.
//
// REPLAY_SCAN_EMULATE leaves the four warp primitives and the CUDA
// keywords to this file.  __syncwarp() becomes a barrier of the 32 threads
// and a shuffle an exchange through a per-lane buffer between two such
// barriers, so every lane sees the values of the others exactly where the
// card's lanes would.  Dynamic shared memory is a host buffer filled with a
// pattern, so a read before the kernel's own initialisation shows.
//
// Built by tests/test_torch_scan_emulate.py with
//   g++ -std=c++20 -fsanitize=address -shared -fPIC -pthread
//       -I src/repro_torch/kernels/csrc
// so that every index the kernel forms is checked against its array.

#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __grid_constant__
#define REPLAY_SCAN_EMULATE

#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

thread_local int tl_lane;
std::barrier<>* warp;
long long x64[32];
int x32[32];

int lane_id() { return tl_lane; }
void warp_sync() { warp->arrive_and_wait(); }
long long shfl_xor(long long v, int m) {
  x64[tl_lane] = v;
  warp->arrive_and_wait();
  const long long r = x64[tl_lane ^ m];
  warp->arrive_and_wait();
  return r;
}
int shfl_xor(int v, int m) {
  x32[tl_lane] = v;
  warp->arrive_and_wait();
  const int r = x32[tl_lane ^ m];
  warp->arrive_and_wait();
  return r;
}

}  // namespace

#include "replay_scan.cu"

extern "C" {

// The CUDA library's replay_scan_launch, argument for argument, on host
// pointers; `stream` is ignored.  Returns when the replay has ended.
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
  (void)stream;
  Args a;
  memcpy(a.v, args, sizeof(a.v));
  const Ptrs p{addrs, writes, routes, tables, issues, dones, flags, totals,
               scal, frames, mpage, mready, wtick, l2p, p2l, valid, free_q,
               free_mask, die_busy, die_prog, chan_busy};
  std::vector<long long> smem(smem_bytes / 8, 0x5a5a5a5a5a5aLL);
  std::barrier<> b(kLanes);
  warp = &b;
  std::vector<std::thread> lanes;
  for (int l = 0; l < kLanes; ++l)
    lanes.emplace_back([&, l] {
      tl_lane = l;
      replay(a, p, smem.data());
    });
  for (auto& t : lanes) t.join();
  return 0;
}

int replay_scan_num_args() { return kNumArgs; }

}  // extern "C"
