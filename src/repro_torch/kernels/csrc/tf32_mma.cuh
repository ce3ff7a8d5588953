// Split-TF32 products on the tensor cores and the copies and barriers
// around them, shared by flash_attention.cu (the forward) and
// flash_attention_bwd.cu (its backward).  _build.py hashes every .cuh of
// this directory into each library's name, so an edit here rebuilds both.
//
// Numerics.  Plain TF32 keeps 10 mantissa bits and misses the 2e-5
// tolerance the port is held to.  Each operand x is split into big =
// tf32(x) and small = tf32(x - big), tf32 being cvt.rna.tf32.f32 (round to
// nearest, ties away from zero), and every product a . b is taken as
// small_a . big_b + big_a . small_b + big_a . big_b, in that order, into
// one float32 accumulator (for a long sum a fresh one a k-step, then added
// to the running sum: see mma3_add).  The dropped small . small term is
// ~2^-22 relative, so the result keeps float32's accuracy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 16-byte copy from device memory to shared memory, bypassing L1; with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Four 8 x 4 float matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8 and gets, of matrix i, register r[i] = the
// element (row l / 4, column l % 4).
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// cvt.rna.tf32.f32 (10 mantissa bits, round to nearest, ties away from
// zero), bit for bit for finite x, as two integer operations: with the
// conversion instruction the forward ran 10% slower (tools/mma_rate.cu,
// modes 1 and 3, shows the same in the bare inner loop)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ ~2^-22 |x|), both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a . b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in split TF32 for the B fragment h of a pair read by
// ldmatrix4 (big in bb, small in bs): the small terms first, then big . big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[4],
                                     const uint32_t (&bs)[4], int h) {
  mma(d, as, bb[2 * h], bb[2 * h + 1]);
  mma(d, ab, bs[2 * h], bs[2 * h + 1]);
  mma(d, ab, bb[2 * h], bb[2 * h + 1]);
}

// d += a . b as mma3, through an accumulator that starts at zero and is
// added to d by one float32 add.  Straight onto the forward's O (l times
// out), each of a band's 3 x Skv / 8 products lost low bits the same way:
// out was 1.8e-4 from float64 at a trained layer of minicpm-2b (scores up
// to 80), 1.4x the tolerance, where the split's own rounding gives 3e-6.
// Here the add rounds to nearest once a k-step: 1.5e-5 (chip_smoke.py).
__device__ __forceinline__ void mma3_add(float (&d)[4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const uint32_t (&bb)[4],
                                         const uint32_t (&bs)[4], int h) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ab, as, bb, bs, h);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// named barrier `id` over n threads: wait for all, or arrive and go on
// (after this thread's shared-memory accesses are made visible)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The column of a transposed tile that holds row (key or query) r of a
// k-step of 8: 8j + 2t -> 8j + t, 8j + 2t + 1 -> 8j + t + 4.  The m16n8k8
// accumulator gives a thread the columns (2t, 2t + 1) of its rows, the A
// operand wants (t, t + 4): stored in this order, the B operand of a
// product summed over those rows takes an accumulator as its A operand
// unchanged, as (d0, d2, d1, d3).
__host__ __device__ constexpr int permuted(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

}  // namespace
