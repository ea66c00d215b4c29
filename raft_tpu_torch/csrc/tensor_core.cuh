// Tensor-core pieces shared by the port's kernels (sep_conv_gru.cu,
// corr_lookup.cu, and through corr_common.cuh the other lookups): the
// cp.async helpers, the exact operand splits and the mma.sync wrappers.
//
// Products keep float32 accuracy on the tensor cores by splitting each
// float32 operand into pieces whose products the tensor cores form exactly:
//  * 3xTF32 (float32 x float32): hi = tf32(x), lo = tf32(x - hi), both
//    rounded to nearest with ties away from zero (cvt.rna's rounding, done
//    on the bits for hi and by cvt.rna for lo, which keeps a NaN);
//    x*y ~ lo*hi' + hi*lo' + hi*hi' on three m16n8k8 TF32 MMAs.  A
//    product of two tf32 values (11 significant bits each) is exact in the
//    FP32 accumulator; what is dropped (lo*lo', lo's rounding) is about
//    2^-22 of |x*y| at worst.
//  * three bfloat16 pieces (float32 x bfloat16): hi = bf16(x),
//    mid = bf16(x - hi), lo = bf16(x - hi - mid) reconstruct a normal float32
//    exactly (8 + 8 + 8 significant bits); a product of a piece with a
//    bfloat16 weight is exact in FP32, so x*w takes three m16n8k16 BF16 MMAs
//    and loses nothing but the accumulator's rounding.
// A bfloat16 x bfloat16 product is one BF16 MMA.  The tensor cores' FP32
// accumulation does not round to nearest, so the kernels sum each short
// k-block into a fresh accumulator and add it to an FP32 register sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace raft_tc {

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x rounded to tf32 (10 mantissa bits), nearest, ties away from zero: the
// low 13 bits of the result are zero
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi rounded on the bits, lo = x - hi (exact) rounded by the hardware's
// cvt.rna (the same rounding, its low bits ignored by the MMA), which keeps
// a NaN: a NaN or infinite x makes x - hi a NaN, so its products stay
// non-finite.  Rounding lo on the bits, as hi is, would carry CUDA's own
// NaN (0x7fffffff) into the sign and give -0 (hi is -0 for that NaN too).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// the three bfloat16 pieces of x, as floats (each exactly a bfloat16)
__device__ __forceinline__ void split_bf16x3(float x, float& hi, float& mid,
                                             float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - hi;                      // exact
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = __bfloat162float(__float2bfloat16_rn(r - mid));
}

// two bfloat16-exact floats as one 32-bit MMA word, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A (16x8 tf32, row) * B (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace raft_tc
