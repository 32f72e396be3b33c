// f32-accurate matrix products on the tensor cores of sm_80 and later:
// mma.sync m16n8k8 with TF32 operands and f32 accumulators, each operand
// split in two TF32 parts ("3xTF32"). Shared by geom_bias_bwd.cu and
// bias_attention.cu.
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32 product
// is off by about 2^-11 of its size. Split x = hi + lo, hi = x rounded to
// TF32 (as cvt.rna rounds: to nearest, ties away from zero) and lo = x - hi
// (exact in f32) rounded to TF32 again; then
//
//   a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi
//
// drops only a_lo b_lo (about 2^-22 of a b) and the TF32 rounding of the lo
// parts (the same size): f32 accuracy at three products. mma3 adds the two
// small products first, then the large one.
//
// Fragment layout of m16n8k8 (PTX ISA, "Matrix Fragments for mma.m16n8k8"),
// lane = 4 * gid + tig:
//   A [16 x 8]: a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
//               a3 (gid + 8, tig + 4)
//   B [8 x 8]:  b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
//   C [16 x 8]: c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig),
//               c3 (gid + 8, 2 tig + 1)
// The k index of a step is a free label as long as A and B agree on it, so
// a caller may map it to its data in any order.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// the value of cvt.rna.tf32.f32 by an integer add and mask (a few percent
// faster in both kernels on an H100); finite x, as every operand here is
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// d += a b, one m16n8k8 product
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to f32 accuracy from split operands: lo hi, hi lo, then hi hi
__device__ __forceinline__ void mma3(float d[4], const uint32_t ah[4],
                                     const uint32_t al[4], const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

}  // namespace tf32
