// Pieces shared by the correlation lookup kernels (corr_lookup.cu,
// corr_window.cu): the level table, the operand types
// (float32, or bfloat16 under corr_precision='default') read as floats, and
// the cp.async helpers (from tensor_core.cuh).  A product of two bfloat16
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

// Staged rows: 64 bytes of channels (16 float32 or 32 bfloat16) per stage,
// laid out 80 bytes apart to spread the shared-memory banks.
constexpr int kStageBytes = 64;
constexpr int kStageVecs = kStageBytes / 16;
constexpr int kRowBytes = kStageBytes + 16;

// acc[j][c] += the dot product of one staged f1 row with the staged f2
// positions rowp[j] + c (c in colmask), over one stage of channels, the
// channels summed in order (so a split of the positions into sub-boxes
// leaves every sum's order unchanged).  The f1 row is loaded once; each
// position's vectors are loaded and summed in turn.
template <typename T, int WIN>
__device__ __forceinline__ void stage_dots(const char* arow,
                                           const char* const (&rowp)[2],
                                           const bool (&rowok)[2],
                                           unsigned colmask,
                                           float (&acc)[2][WIN]) {
  constexpr int kN = Vec16<T>::kN;
  uint4 a_raw[kStageVecs];
#pragma unroll
  for (int m = 0; m < kStageVecs; ++m)
    a_raw[m] = *reinterpret_cast<const uint4*>(arow + 16 * m);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!rowok[j]) continue;
#pragma unroll
    for (int c = 0; c < WIN; ++c) {
      if (!((colmask >> c) & 1u)) continue;
      const char* pos = rowp[j] + c * kRowBytes;
      float t = acc[j][c];
#pragma unroll
      for (int m = 0; m < kStageVecs; ++m) {
        float a[kN], v[kN];
        Vec16<T>::unpack(a_raw[m], a);
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(pos + 16 * m), v);
#pragma unroll
        for (int e = 0; e < kN; ++e) t = fmaf(a[e], v[e], t);
      }
      acc[j][c] = t;
    }
  }
}

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
