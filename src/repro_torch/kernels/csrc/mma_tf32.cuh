// 3xTF32 tensor-core products shared by the port's f32 kernels
// (spectral_hadamard.cu, flash_attention.cu, fused_spectral_conv.cu).
//
// `mma.sync.aligned.m16n8k8` on TF32 operands with f32 accumulation.  Each
// f32 operand x is split into a TF32 high part hi = rna(x) and the TF32
// rounding of its remainder lo = rna(x - hi) (round to nearest, ties away,
// as `cvt.rna.tf32.f32`; operands are finite), and
// a product is accumulated as lo*hi + hi*lo + hi*hi: three MMAs that keep
// f32 accuracy (the dropped lo*lo is ~2^-22 of a product) where one TF32
// pass keeps ~1e-3.  A complex product is formed from four real products
// (re = Wr Xr - Wi Xi, im = Wr Xi + Wi Xr), never Karatsuba's
// (Wr + Wi)(Xr + Xi) - Wr Xr - Wi Xi, whose cancellation against the larger
// sum plane cost the staged Hadamard 4.7e-6 of max|Y| at M = 512; the minus
// sign is the sign bit of the split parts (`neg`), exact.
//
// Fragment layouts (PTX ISA, m16n8k8 .tf32), lane = 4 gq + tq:
//   A (16 x 8, row):  a0 (gq, tq)  a1 (gq + 8, tq)  a2 (gq, tq + 4)
//                     a3 (gq + 8, tq + 4)
//   B (8 x 8, col):   b0 (tq, gq)  b1 (tq + 4, gq)
//   C (16 x 8):       c0 (gq, 2 tq)  c1 (gq, 2 tq + 1)  c2 (gq + 8, 2 tq)
//                     c3 (gq + 8, 2 tq + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// x rounded to TF32 as `cvt.rna.tf32.f32` rounds a finite value (to the
// nearest 10-bit mantissa, ties away from zero; a carry into the exponent
// is the right result), by two integer operations on the full-rate ALU
// pipe instead of a conversion.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32 (hi the rounding of x, lo of the remainder).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// -x of a split part: its sign bit flipped (exact).
__device__ __forceinline__ uint32_t neg(uint32_t x) { return x ^ 0x80000000u; }

// d += a b, one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B in 3xTF32 from split fragments: lo*hi + hi*lo + hi*hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// d += A B in 3xTF32, the hi*hi products and the two correction terms
// each summed in a fresh accumulator and both added to d in f32.  The
// tensor cores truncate the low bits of what they add to a larger
// accumulator, so corrections summed onto the hi*hi sum lose a one-sided
// part, which compounds through a network (the fused conv's VGG16 logits
// read 2.8e-6 of einsum that way, 1.2e-6 kept apart, as with f32 FMAs).
__device__ __forceinline__ void mma3_f32(float (&d)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float c[4] = {0.f, 0.f, 0.f, 0.f}, m[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(m, ah, bh);
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] += m[r] + c[r];
}

// d += t on the CUDA cores (round to nearest): a fresh accumulator's
// k steps added to a running sum.  The tensor cores' own f32 accumulation
// truncates the low bits of what it adds to a larger accumulator, so a
// long sum kept in one MMA accumulator loses several times f32's error.
__device__ __forceinline__ void add4(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] += t[r];
}

// x = hi + lo with lo the raw f32 remainder: the tensor cores read a TF32
// operand's 10 leading mantissa bits and drop the rest, a truncation of
// lo (< 2^-21 of x) that costs nothing to form.  B9 f32 measured the same
// error with it as with a rounded lo, and ran 7 % faster.
__device__ __forceinline__ void split_raw_lo(float x, uint32_t& hi,
                                             uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int R>
__device__ __forceinline__ void split_frag_raw_lo(const float (&x)[R],
                                                  uint32_t (&hi)[R],
                                                  uint32_t (&lo)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) split_raw_lo(x[r], hi[r], lo[r]);
}

// Split fragments of f32 values.
template <int R>
__device__ __forceinline__ void split_frag(const float (&x)[R],
                                           uint32_t (&hi)[R],
                                           uint32_t (&lo)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) split(x[r], hi[r], lo[r]);
}

// The negated split fragment (-A from A's parts).
template <int R>
__device__ __forceinline__ void neg_frag(const uint32_t (&x)[R],
                                         uint32_t (&y)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = neg(x[r]);
}

}  // namespace repro_torch
