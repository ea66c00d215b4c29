// Pieces of the correlation lookup kernel (corr_lookup.cu): the level
// table, the operand types (float32, or bfloat16 under
// corr_precision='default') read as floats, and the cp.async helpers (from
// tensor_core.cuh).  A product of two bfloat16
// values is exact in FP32, so a bfloat16 lookup differs from the float32
// lookup of the same rounded operands only by the order of its sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace raft_corr {

constexpr int kMaxLevels = 8;

struct Levels {
  const void* f2[kMaxLevels];   // [B, H_l, W_l, C] each, of the operand type
  int h[kMaxLevels];
  int w[kMaxLevels];
};

inline Levels make_levels(const void* const* f2_ptrs, const int* level_hw,
                          int num_levels) {
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.f2[l] = f2_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  return lv;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of operands as floats: 4 float32 values or 8 bfloat16 values (a
// bfloat16 is the upper half of the float32 with the same value, so the
// widening is a shift, exact).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* o) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // little endian: low half first
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// floor(c) as an int, clamped first: a huge or NaN coordinate lands far
// outside the map (fminf/fmaxf return the non-NaN operand)
__device__ __forceinline__ int clamped_floor(float c) {
  return (int)fmaxf(fminf(floorf(c), 1e8f), -1e8f);
}

// One output of the bilinear window: y taps first, then x taps, the order
// of the one-hot contractions of the plain version.
__device__ __forceinline__ float bilinear(float v00, float v01, float v10,
                                          float v11, float fx, float fy) {
  return (1.0f - fx) * ((1.0f - fy) * v00 + fy * v10)
       + fx * ((1.0f - fy) * v01 + fy * v11);
}

// the cp.async helpers of tensor_core.cuh
using raft_tc::cp16;
using raft_tc::cp_commit;
using raft_tc::cp_wait;

}  // namespace raft_corr
