// Rate of TF32 mma.sync (m16n8k8) on the card, alone and inside the inner
// loops a split-TF32 attention kernel can be built from.
//
// `tools/time_attention.py --mma` builds this and times each mode over a
// grid of 1 or 2 blocks of 8 warps an SM.  Every warp runs `iters` passes
// of 16 k-steps x 8 n-tiles of 8 over a 64 x 128 float tile in shared
// memory (row stride 132 floats), as Q.K^T does at hd 128 with 64-key
// tiles:
//   mode 0: one mma an n-tile, operands in registers: the instruction's
//           own rate;
//   mode 1: split at use: the A fragment read from shared memory and split
//           each k-step, each B value read (2 loads) and split (cvt, sub,
//           cvt) before the three products small.big, big.small, big.big;
//   mode 2: operands split beforehand: big and small tiles in shared
//           memory, read with ldmatrix.x4 (two n-tiles' B fragments a
//           load), then the three products;
//   mode 3: mode 1 with the rounding done as two integer operations,
//           (bits + 0x1000) & ~0x1fff, instead of cvt.rna.tf32.f32.
// Each warp's accumulators are summed into `out` so nothing is dropped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kST = 132;                 // tile row stride, floats
constexpr int kTile = 64 * kST;          // one 64 x 128 tile

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <bool INT>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = INT ? tf32_int(x) : tf32(x);
  small = INT ? tf32_int(x - __uint_as_float(big))
              : tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

template <int MODE>
__global__ void __launch_bounds__(256) mma_rate_kernel(int iters,
                                                       float* out) {
  extern __shared__ __align__(16) float tile[];   // big, then small
  for (int i = threadIdx.x; i < 2 * kTile; i += 256)
    tile[i] = __uint_as_float(tf32(1.f + 1e-3f * (i % 97)));
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (MODE == 0) {
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = tf32(1.f + lane * 1e-2f + i);
    const uint32_t b0 = tf32(0.5f + lane * 1e-3f), b1 = tf32(0.25f);
    for (int it = 0; it < iters; ++it)
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(acc[j], a, b0, b1);
  } else {
    // A fragment rows (gr, gr + 8) x columns (8 kk + tq, + 4) of the tile
    const float* qa = tile + gr * kST + tq;
    const float* kb = tile + gr * kST + tq;                  // mode 1
    const int mrow = 8 * (lane >> 4) + (lane & 7);           // mode 2
    const float* lm = tile + mrow * kST + 4 * ((lane >> 3) & 1);
    for (int it = 0; it < iters; ++it) {
      const int off = (it & 1) * 4;   // no load is loop-invariant
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        uint32_t ab[4], as[4];
        split<MODE == 3>(qa[off + kk * 8], ab[0], as[0]);
        split<MODE == 3>(qa[off + 8 * kST + kk * 8], ab[1], as[1]);
        split<MODE == 3>(qa[off + kk * 8 + 4], ab[2], as[2]);
        split<MODE == 3>(qa[off + 8 * kST + kk * 8 + 4], ab[3], as[3]);
        if (MODE != 2) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t bb0, bs0, bb1, bs1;
            split<MODE == 3>(kb[off + j * 8 * kST + kk * 8], bb0, bs0);
            split<MODE == 3>(kb[off + j * 8 * kST + kk * 8 + 4], bb1, bs1);
            mma(acc[j], as, bb0, bb1);
            mma(acc[j], ab, bs0, bs1);
            mma(acc[j], ab, bb0, bb1);
          }
        } else {
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t big[4], small[4];
            ldmatrix4(big, lm + off + jp * 16 * kST + kk * 8);
            ldmatrix4(small, lm + off + kTile + jp * 16 * kST + kk * 8);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma(acc[2 * jp + h], as, big[2 * h], big[2 * h + 1]);
              mma(acc[2 * jp + h], ab, small[2 * h], small[2 * h + 1]);
              mma(acc[2 * jp + h], ab, big[2 * h], big[2 * h + 1]);
            }
          }
        }
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += acc[j][e];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

template <int MODE>
int launch(int iters, int blocks, float* out, cudaStream_t s) {
  const int smem = 2 * kTile * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mma_rate_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_rate_kernel<MODE><<<blocks, 256, smem, s>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch `blocks` blocks of 8 warps running mode `mode` for `iters` passes;
// `out` holds blocks * 256 floats.  Returns the CUDA error code.
extern "C" int mma_rate(int mode, int iters, int blocks, float* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(iters, blocks, out, s);
    case 1: return launch<1>(iters, blocks, out, s);
    case 2: return launch<2>(iters, blocks, out, s);
    case 3: return launch<3>(iters, blocks, out, s);
    default: return -1;
  }
}
