// How TF32 mma.sync (m16n8k8, float32 accumulator) rounds: one product a
// warp on fragments given per lane, d = a . b + c, for
// `tools/time_attention.py --mma-rounding` to hold against models of the
// rounding.  Warp w reads lane l's registers a[w][l][0..3], b[w][l][0..1],
// c[w][l][0..3] and writes d[w][l][0..3].

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void mma_rounding_kernel(const uint32_t* a, const uint32_t* b,
                                    const float* c, float* d, int warps) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= warps) return;
  const long long o = static_cast<long long>(w) * 32 + (threadIdx.x & 31);
  float d0 = c[o * 4], d1 = c[o * 4 + 1], d2 = c[o * 4 + 2], d3 = c[o * 4 + 3];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[o * 4]), "r"(a[o * 4 + 1]), "r"(a[o * 4 + 2]),
        "r"(a[o * 4 + 3]), "r"(b[o * 2]), "r"(b[o * 2 + 1]));
  d[o * 4] = d0;
  d[o * 4 + 1] = d1;
  d[o * 4 + 2] = d2;
  d[o * 4 + 3] = d3;
}

}  // namespace

extern "C" int mma_rounding(const uint32_t* a, const uint32_t* b,
                            const float* c, float* d, int warps) {
  mma_rounding_kernel<<<(warps * 32 + 127) / 128, 128>>>(a, b, c, d, warps);
  return static_cast<int>(cudaDeviceSynchronize());
}
