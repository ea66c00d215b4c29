// Window-scheduled correlation lookup for RAFT, for Hopper (sm_90a).
//
// corr_window_{f32,bf16} replace _lookup_level with p_select='window' in
// raft_tpu/ops/corr_pallas.py (_window_kernel, schedule _window_schedule,
// :342), reached through make_window_lookup (the ragged and the packed
// lookups run corr_lookup.cu's tile body).  Same values as corr_lookup.cu:
// for each (item, query, level) the correlation <f1[q], f2_l[p]> / sqrt(C)
// is sampled bilinearly on a (2r+1)^2 window centred at coords / 2^l,
// zeros outside the map, written x-offset-major at
// out[b, q, l*(2r+1)^2 + ix*(2r+1) + iy].
// Operands are float32 (*_f32) or bfloat16 (*_bf16, the
// corr_precision='default' operands); all arithmetic is FP32 FMA (no
// TF32), the output float32.
//
// Design.  One CTA serves an 8x8 tile of neighbouring queries at one level
// of one item: grid (query tiles, level, item).  It first computes its
// schedule on the device: the bounding box of the tile's windows (the rows
// of the TPU schedule, plus the columns), clipped to the map.  It then
// stages that f2 box, with the tile's f1, through shared memory in stages
// of 64 bytes of channels (16 float32 or 32 bfloat16; cp.async, two
// buffers: the next stage loads while this one is used), so the tile's
// overlapping windows share each f2 read.  A box larger than a buffer is
// walked in sub-boxes; each window position belongs to exactly one, so the
// channel sums run in the same order whatever the split.  Each query has
// r+1 threads, each owning two rows of its (2r+2)^2 window, whose dot
// products accumulate in registers.  When the tile's windows are
// incoherent (the box holds more than half the positions its windows read
// in all, as random-weight flows of hundreds of pixels give) staging would
// buy little, and the CTA computes the dot products one warp per query
// instead, lanes over channels, a shuffle reduction per position.  Either
// way the (2r+2)^2 values go through shared memory into the bilinear
// combine.
//
// Bound: the FP32 FMAs of the in-map window positions; the inner loop does
// 4 FMAs per 16-byte shared-memory load for float32 operands (8 for
// bfloat16), so it can reach about a quarter of the FP32 rate at best.

#include <limits.h>

#include "corr_common.cuh"

namespace {

using raft_corr::kRowBytes;
using raft_corr::kStageBytes;
using raft_corr::kStageVecs;
using raft_corr::Levels;

constexpr int kMaxDevices = 64;
constexpr int kMaxChannels = 512;
constexpr int kTileH = 8, kTileW = 8;
constexpr int kTile = kTileH * kTileW;     // queries per CTA
constexpr int kMaxPos = 448;               // f2 positions per staged sub-box
constexpr int kBufBytes = (kMaxPos + kTile) * kRowBytes;

template <int R>
struct Shape {
  static constexpr int kThreads = kTile * (R + 1);
  static constexpr int kMinCtas = R <= 4 ? 2 : 1;   // two CTAs per SM while
                                                    // the register file allows
};

// R: the window radius; each query has R+1 threads, thread `slot` owning
// window rows 2*slot and 2*slot+1.
template <typename T, int R>
__global__ void __launch_bounds__(Shape<R>::kThreads, Shape<R>::kMinCtas)
corr_window_kernel(const T* __restrict__ f1,          // [B, H*W, C]
                   const float* __restrict__ coords,  // [B, H*W, 2] (x, y)
                   float* __restrict__ out,           // [B, H*W, L*(2r+1)^2]
                   Levels lv, int L, int H, int W, int C, float scale) {
  constexpr int kThreads = Shape<R>::kThreads;
  constexpr int kChunk = kStageBytes / (int)sizeof(T);   // channels per stage
  constexpr int kN = raft_corr::Vec16<T>::kN;            // channels per vector
  constexpr int WIN = 2 * R + 2;
  constexpr int NWIN = WIN * WIN;
  constexpr int N = 2 * R + 1;
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  __shared__ int s_ix0[kTile], s_iy0[kTile], s_state[kTile];
  __shared__ float s_fx[kTile], s_fy[kTile];
  __shared__ int s_box[5];                 // y lo, y hi, x lo, x hi (inclusive),
                                           // queries whose windows meet the map

  const int tid = threadIdx.x;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int qy0 = (blockIdx.x / tiles_w) * kTileH;
  const int qx0 = (blockIdx.x % tiles_w) * kTileW;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int Q = H * W;
  const int H2 = lv.h[l];
  const int W2 = lv.w[l];

  if (tid == 0) {
    s_box[0] = INT_MAX; s_box[1] = INT_MIN;
    s_box[2] = INT_MAX; s_box[3] = INT_MIN;
    s_box[4] = 0;
  }
  __syncthreads();
  if (tid < kTile) {
    const int qy = qy0 + tid / kTileW;
    const int qx = qx0 + tid % kTileW;
    // 0: outside the grid, 2: a query (its window may miss the map)
    const int state = (qy < H && qx < W) ? 2 : 0;
    if (state == 2) {
      const size_t qi = (size_t)b * Q + (size_t)qy * W + qx;
      const float level_scale = 1.0f / (float)(1 << l);   // exact power of 2
      const float cx = coords[qi * 2] * level_scale;
      const float cy = coords[qi * 2 + 1] * level_scale;
      const int ix0 = raft_corr::clamped_floor(cx) - R;
      const int iy0 = raft_corr::clamped_floor(cy) - R;
      s_ix0[tid] = ix0;
      s_iy0[tid] = iy0;
      s_fx[tid] = cx - floorf(cx);
      s_fy[tid] = cy - floorf(cy);
      if (iy0 < H2 && iy0 + WIN > 0 && ix0 < W2 && ix0 + WIN > 0) {
        atomicMin(&s_box[0], iy0);
        atomicMax(&s_box[1], iy0 + WIN - 1);
        atomicMin(&s_box[2], ix0);
        atomicMax(&s_box[3], ix0 + WIN - 1);
        atomicAdd(&s_box[4], 1);
      }
    }
    s_state[tid] = state;
  }
  __syncthreads();

  const int by0 = max(s_box[0], 0), by1 = min(s_box[1], H2 - 1);
  const int bx0 = max(s_box[2], 0), bx1 = min(s_box[3], W2 - 1);
  const int i = tid % kTile;               // this thread's query
  const int slot = tid / kTile;            // and its two window rows
  const bool live = s_state[i] == 2;
  const int ix0 = live ? s_ix0[i] : 0;
  const int iy0 = live ? s_iy0[i] : 0;
  const T* f2b = static_cast<const T*>(lv.f2[l]) + (size_t)b * H2 * W2 * C;

  // Incoherent windows (a box much larger than the windows inside it)
  // share little: then, as in corr_lookup.cu, each warp takes one query at
  // a time, the lanes splitting its channels (coalesced reads) and a
  // shuffle reduction giving each in-map position's dot product.
  const long long box_area =
      (by0 <= by1 && bx0 <= bx1) ? (long long)(by1 - by0 + 1) * (bx1 - bx0 + 1) : 0;
  const bool direct = 2 * box_area > (long long)s_box[4] * NWIN;
  float* v = reinterpret_cast<float*>(smem);   // v[query][(2r+2)^2], scaled

  if (direct) {                            // uniform over the CTA
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int q = warp; q < kTile; q += kThreads / 32) {
      if (s_state[q] != 2) continue;       // uniform over the warp
      const T* f1q = f1 + ((size_t)b * Q + (size_t)(qy0 + q / kTileW) * W
                           + (qx0 + q % kTileW)) * C;
      float a[kMaxChannels / 32];          // lane owns channels lane + 32k
#pragma unroll
      for (int k = 0; k < kMaxChannels / 32; ++k)
        a[k] = lane + 32 * k < C ? raft_corr::to_float(f1q[lane + 32 * k]) : 0.0f;
      const int qx = s_ix0[q];
      const int qy = s_iy0[q];
      for (int p = 0; p < NWIN; ++p) {
        const int y = qy + p / WIN;
        const int x = qx + p % WIN;
        float t = 0.0f;
        if (y >= 0 && y < H2 && x >= 0 && x < W2) {   // uniform
          const T* row = f2b + ((size_t)y * W2 + x) * C;
#pragma unroll
          for (int k = 0; k < kMaxChannels / 32; ++k)
            if (lane + 32 * k < C)
              t = fmaf(a[k], raft_corr::to_float(row[lane + 32 * k]), t);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            t += __shfl_xor_sync(0xffffffffu, t, o);
        }
        if (lane == 0) v[q * NWIN + p] = t * scale;
      }
    }
  } else {
    float acc[2][WIN];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < WIN; ++c) acc[j][c] = 0.0f;

    if (box_area > 0) {                      // uniform over the CTA
      const int sw = min(bx1 - bx0 + 1, kMaxPos);
      const int sh = min(by1 - by0 + 1, kMaxPos / sw);
      const int nchunks = (C + kChunk - 1) / kChunk;
      for (int sx0 = bx0; sx0 <= bx1; sx0 += sw) {
        const int cw = min(sw, bx1 - sx0 + 1);
        for (int sy0 = by0; sy0 <= by1; sy0 += sh) {
          const int ch = min(sh, by1 - sy0 + 1);
          const int npos = ch * cw;
          // where this thread's two window rows start in the staged box, and
          // which of their columns lie in it
          int rowoff[2];
          bool rowok[2];
          unsigned colmask = 0;
          const int xr = ix0 - sx0;
#pragma unroll
          for (int c = 0; c < WIN; ++c)
            if (xr + c >= 0 && xr + c < cw) colmask |= 1u << c;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int yr = iy0 + 2 * slot + j - sy0;
            rowok[j] = live && colmask != 0 && yr >= 0 && yr < ch;
            rowoff[j] = (yr * cw + xr) * kRowBytes;
          }

          // stage chunk k of the sub-box and of the tile's f1 into buffer k&1
          auto stage = [&](int k) {
            char* buf = smem + (k & 1) * kBufBytes;
            const int c0 = k * kChunk;
            for (int e = tid; e < (npos + kTile) * kStageVecs; e += kThreads) {
              const int row = e / kStageVecs;
              const int c = c0 + kN * (e % kStageVecs);
              const T* src = f2b;
              int bytes = 0;
              if (row < npos) {
                const int y = sy0 + row / cw;
                const int x = sx0 + row % cw;
                if (c < C) {
                  src = f2b + ((size_t)y * W2 + x) * C + c;
                  bytes = 16;
                }
              } else {
                const int q = row - npos;
                if (s_state[q] == 2 && c < C) {
                  src = f1 + ((size_t)b * Q + (size_t)(qy0 + q / kTileW) * W
                              + (qx0 + q % kTileW)) * C + c;
                  bytes = 16;
                }
              }
              raft_corr::cp16(buf + row * kRowBytes + (e % kStageVecs) * 16,
                              src, bytes);
            }
            raft_corr::cp_commit();
          };

          stage(0);
          for (int k = 0; k < nchunks; ++k) {
            if (k + 1 < nchunks) {
              stage(k + 1);
              raft_corr::cp_wait<1>();
            } else {
              raft_corr::cp_wait<0>();
            }
            __syncthreads();                 // chunk k is in buffer k&1
            const char* buf = smem + (k & 1) * kBufBytes;
            if (rowok[0] || rowok[1]) {
              const char* const rowp[2] = {buf + rowoff[0], buf + rowoff[1]};
              raft_corr::stage_dots<T, WIN>(buf + (npos + i) * kRowBytes, rowp,
                                            rowok, colmask, acc);
            }
            __syncthreads();                 // buffer k&1 is free for k+2
          }
        }
      }
    }

    // after the last barrier above, the staging buffers hold v
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < WIN; ++c)
        v[i * NWIN + (2 * slot + j) * WIN + c] = acc[j][c] * scale;
  }
  __syncthreads();

  constexpr int NN = N * N;
  for (int e = tid; e < kTile * NN; e += kThreads) {
    const int qi = e / NN;
    const int t = e % NN;
    if (s_state[qi] == 0) continue;
    const int qy = qy0 + qi / kTileW;
    const int qx = qx0 + qi % kTileW;
    const int ox = t / N;                  // x offset
    const int oy = t % N;                  // y offset
    const float* vq = v + qi * NWIN;
    out[((size_t)b * Q + (size_t)qy * W + qx) * (size_t)(L * NN)
        + (size_t)l * NN + t] =
        raft_corr::bilinear(vq[oy * WIN + ox], vq[oy * WIN + ox + 1],
                            vq[(oy + 1) * WIN + ox],
                            vq[(oy + 1) * WIN + ox + 1], s_fx[qi], s_fy[qi]);
  }
}

template <typename T, int R>
cudaError_t launch(const T* f1, const float* coords, float* out,
                   const Levels& lv, int L, int B, int H, int W, int C,
                   float scale, cudaStream_t stream) {
  constexpr int NWIN = (2 * R + 2) * (2 * R + 2);
  static_assert(kTile * NWIN * (int)sizeof(float) <= 2 * kBufBytes,
                "window values fit the buffers");
  const int smem = 2 * kBufBytes;
  // above 48 KB dynamic shared memory needs an opt-in, once per device (the
  // call is too slow for every launch)
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(corr_window_kernel<T, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  const int tiles = ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  dim3 grid(tiles, L, B);
  corr_window_kernel<T, R><<<grid, Shape<R>::kThreads, smem, stream>>>(
      f1, coords, out, lv, L, H, W, C, scale);
  return cudaGetLastError();
}

template <typename T>
int run(const void* f1v, const float* coords, float* out,
        const void* const* f2_ptrs, const int* level_hw, int num_levels,
        int B, int H, int W, int C, int radius, float scale, void* stream) {
  constexpr int kN = raft_corr::Vec16<T>::kN;
  if (num_levels < 1 || num_levels > raft_corr::kMaxLevels || radius < 0 ||
      radius > 7 || C < kN || C % kN != 0 || C > kMaxChannels || B < 1 ||
      H < 1 || W < 1 || B > 65535 || (long long)H * W > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const Levels lv = raft_corr::make_levels(f2_ptrs, level_hw, num_levels);
  const T* f1 = static_cast<const T*>(f1v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAFT_WINDOW_CASE(RR)                                                  \
  case RR: return (int)launch<T, RR>(f1, coords, out, lv, num_levels, B, H,   \
                                     W, C, scale, s);
  switch (radius) {
    RAFT_WINDOW_CASE(0) RAFT_WINDOW_CASE(1) RAFT_WINDOW_CASE(2)
    RAFT_WINDOW_CASE(3) RAFT_WINDOW_CASE(4) RAFT_WINDOW_CASE(5)
    RAFT_WINDOW_CASE(6) RAFT_WINDOW_CASE(7)
  }
#undef RAFT_WINDOW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f2_ptrs / level_hw are HOST arrays: num_levels device pointers and (h, w)
// pairs.  Each entry returns a cudaError_t (0 on success); it launches on
// `stream` and never syncs.
extern "C" int corr_window_f32(const void* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, int num_levels, int B,
                               int H, int W, int C, int radius, float scale,
                               void* stream) {
  return run<float>(f1, coords, out, f2_ptrs, level_hw, num_levels, B, H, W,
                    C, radius, scale, stream);
}

extern "C" int corr_window_bf16(const void* f1, const float* coords,
                                float* out, const void* const* f2_ptrs,
                                const int* level_hw, int num_levels, int B,
                                int H, int W, int C, int radius, float scale,
                                void* stream) {
  return run<__nv_bfloat16>(f1, coords, out, f2_ptrs, level_hw, num_levels,
                            B, H, W, C, radius, scale, stream);
}
