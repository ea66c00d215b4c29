// Correlation window lookup for RAFT, for Hopper (sm_90a).
//
// Replaces raft_tpu/ops/corr_pallas.py::_lookup_level (p_select='all',
// _level_kernel + _window_body), reached through fused_lookup and
// make_fused_lookup.  Same values: for each (batch, query, level) the
// correlation <f1[q], f2_l[p]> / sqrt(C) is sampled bilinearly on a
// (2r+1)^2 window centred at coords / 2^l, zeros outside the map, written
// x-offset-major at out[b, q, l*(2r+1)^2 + ix*(2r+1) + iy].
//
// Design: the TPU kernel computed a whole [T, P] correlation tile per
// program to keep the work on the matrix unit and avoid gathers.  Here a
// gather is cheap, so one warp serves one (query, level): it holds the
// query's feature vector in registers (lane i owns channels i, i+32, ...),
// computes the correlation only at the (2r+2)^2 integer positions of its
// window that lie inside the map (a partial dot product per lane and a
// shuffle reduction), keeps them in shared memory, and combines the four
// bilinear taps of each output.  One launch covers every level:
// grid (query tiles, level, batch).  Operands are
// float32 (corr_lookup_f32) or bfloat16 (corr_lookup_bf16, the
// corr_precision='default' operands); all arithmetic is FP32 FMA (no
// TF32), the output float32.

#include "corr_common.cuh"

namespace {

using raft_corr::Levels;

constexpr int kWarps = 4;          // warps (queries) per block
constexpr int kMaxWin = 32;        // (2r+2) <= 32, i.e. radius <= 15

template <typename T, int KPL>     // channels per lane: C <= 32 * KPL
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_kernel(const T* __restrict__ f1,          // [B, Q, C]
                   const float* __restrict__ coords,  // [B, Q, 2] (x, y)
                   float* __restrict__ out,           // [B, Q, L*(2r+1)^2]
                   Levels lv, int L, int Q, int C, int r, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  if (q >= Q) return;                      // whole warp leaves together

  const int win = 2 * r + 2;
  const int n = 2 * r + 1;
  float* v = smem + warp * win * win;
  const size_t qi = (size_t)b * Q + q;

  const float level_scale = 1.0f / (float)(1 << l);   // exact power of 2
  const float cx = coords[qi * 2] * level_scale;
  const float cy = coords[qi * 2 + 1] * level_scale;
  const float fx = cx - floorf(cx);
  const float fy = cy - floorf(cy);
  const int ix0 = raft_corr::clamped_floor(cx) - r;
  const int iy0 = raft_corr::clamped_floor(cy) - r;
  const int H2 = lv.h[l];
  const int W2 = lv.w[l];

  float a[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int c = lane + 32 * k;
    a[k] = c < C ? raft_corr::to_float(f1[qi * C + c]) : 0.0f;
  }

  const T* f2 = static_cast<const T*>(lv.f2[l]) + (size_t)b * H2 * W2 * C;
  for (int p = 0; p < win * win; ++p) {
    const int y = iy0 + p / win;
    const int x = ix0 + p % win;
    float s = 0.0f;
    if (y >= 0 && y < H2 && x >= 0 && x < W2) {      // uniform over the warp
      const T* row = f2 + ((size_t)y * W2 + x) * C;
      // every load issued before the first FMA, so they overlap
      float b2[KPL];
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int c = lane + 32 * k;
        b2[k] = c < C ? raft_corr::to_float(row[c]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < KPL; ++k)
        if (lane + 32 * k < C) s = fmaf(a[k], b2[k], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (lane == 0) v[p] = s * scale;
  }
  __syncwarp();

  float* o = out + qi * (size_t)(L * n * n) + (size_t)l * n * n;
  for (int t = lane; t < n * n; t += 32) {
    const int i = t / n;                   // x offset
    const int j = t % n;                   // y offset
    o[t] = raft_corr::bilinear(v[j * win + i], v[j * win + i + 1],
                               v[(j + 1) * win + i], v[(j + 1) * win + i + 1],
                               fx, fy);
  }
}

template <typename T, int KPL>
cudaError_t launch(const T* f1, const float* coords, float* out,
                   const Levels& lv, int L, int B, int Q, int C, int r,
                   float scale, cudaStream_t stream) {
  const int win = 2 * r + 2;
  const size_t smem = (size_t)kWarps * win * win * sizeof(float);
  dim3 grid((Q + kWarps - 1) / kWarps, L, B);
  corr_lookup_kernel<T, KPL><<<grid, kWarps * 32, smem, stream>>>(
      f1, coords, out, lv, L, Q, C, r, scale);
  return cudaGetLastError();
}

template <typename T>
int run(const void* f1v, const float* coords, float* out,
        const void* const* f2_ptrs, const int* level_hw, int num_levels,
        int B, int Q, int C, int radius, float scale, void* stream) {
  if (num_levels < 1 || num_levels > raft_corr::kMaxLevels || radius < 0 ||
      2 * radius + 2 > kMaxWin || C < 1 || C > 512 || B < 1 || Q < 1)
    return (int)cudaErrorInvalidValue;
  const Levels lv = raft_corr::make_levels(f2_ptrs, level_hw, num_levels);
  const T* f1 = static_cast<const T*>(f1v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 128)
    err = launch<T, 4>(f1, coords, out, lv, num_levels, B, Q, C, radius, scale, s);
  else if (C <= 256)
    err = launch<T, 8>(f1, coords, out, lv, num_levels, B, Q, C, radius, scale, s);
  else
    err = launch<T, 16>(f1, coords, out, lv, num_levels, B, Q, C, radius, scale, s);
  return (int)err;
}

}  // namespace

// f2_ptrs / level_hw are HOST arrays: num_levels device pointers and (h, w)
// pairs.  Returns a cudaError_t (0 on success); launches on `stream`, never
// syncs.
extern "C" int corr_lookup_f32(const void* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, int num_levels, int B,
                               int Q, int C, int radius, float scale,
                               void* stream) {
  return run<float>(f1, coords, out, f2_ptrs, level_hw, num_levels, B, Q, C,
                    radius, scale, stream);
}

extern "C" int corr_lookup_bf16(const void* f1, const float* coords,
                                float* out, const void* const* f2_ptrs,
                                const int* level_hw, int num_levels, int B,
                                int Q, int C, int radius, float scale,
                                void* stream) {
  return run<__nv_bfloat16>(f1, coords, out, f2_ptrs, level_hw, num_levels, B,
                            Q, C, radius, scale, stream);
}
