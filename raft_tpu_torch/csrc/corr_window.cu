// Window-scheduled correlation lookup for RAFT, FP32, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of raft_tpu/ops/corr_pallas.py:
//  * corr_window_f32 — _lookup_level with p_select='window' (_window_kernel,
//    schedule _window_schedule), reached through make_fused_lookup;
//  * corr_ragged_f32 — _ragged_lookup_level (_ragged_window_kernel,
//    schedule _ragged_schedule), reached through ragged_fused_lookup and
//    make_ragged_fused_lookup: items are corner-anchored crops of one
//    shared max box, f1 and the f2 pyramid masked to zero outside them.
// Same values as corr_lookup.cu: for each (item, query, level) the
// correlation <f1[q], f2_l[p]> / sqrt(C) is sampled bilinearly on a
// (2r+1)^2 window centred at coords / 2^l, zeros outside the map, written
// x-offset-major at out[b, q, l*(2r+1)^2 + ix*(2r+1) + iy].  The ragged
// entry writes exact zeros for dead queries (outside the item's live
// sizes8 extent) without reading f2.
//
// Design.  One CTA serves an 8x8 tile of neighbouring queries at one level
// of one item: grid (query tiles, level, item).  It first computes its
// schedule on the device: the bounding box of the tile's windows (the
// rows of the TPU schedule, plus the columns), clipped to the map — for a
// ragged item to its live rows and columns at that level, so dead pages
// are never read.  It then stages that f2 box, with the tile's f1, through
// shared memory in chunks of 16 channels (cp.async, two buffers: the next
// chunk loads while this one is used), so the tile's overlapping windows
// share each f2 read (corr_lookup.cu re-reads f2 per query from global
// memory).  A box larger than a buffer is walked in sub-boxes; each window
// position belongs to exactly one, so the channel sums run in the same
// order whatever the split.  Each query has r+1 threads, each owning two
// rows of its (2r+2)^2 window, whose dot products accumulate in registers.
// When the tile's windows are incoherent (the box holds more than half the
// positions its windows read in all, as random-weight flows of hundreds of
// pixels give) staging would buy little, and the CTA computes the dot
// products as corr_lookup.cu does instead: one warp per query, lanes over
// channels, a shuffle reduction per position.  Either way the (2r+2)^2
// values go through shared memory into the bilinear combine.  All
// arithmetic is FP32 FMA (no TF32).
//
// Bound: the FP32 FMAs of the in-map window positions, as corr_lookup.cu;
// the inner loop does 4 FMAs per 16-byte shared-memory load, so it can
// reach about a quarter of the FP32 rate at best.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxDevices = 64;
constexpr int kMaxChannels = 512;
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTile = kTileH * kTileW;     // queries per CTA
constexpr int kChunk = 16;                 // channels staged at a time
constexpr int kVec = kChunk / 4;           // float4s per staged row
constexpr int kStride = kChunk + 4;        // floats per staged row (bank spread)
constexpr int kMaxPos = 448;               // f2 positions per staged sub-box
constexpr int kBuf = (kMaxPos + kTile) * kStride;   // floats per buffer

struct Levels {
  const float* f2[kMaxLevels];             // [B, H_l, W_l, C] each
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp16(float* dst, const float* src,
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

template <int R>
struct Shape {
  static constexpr int kThreads = kTile * (R + 1);
  // two CTAs per SM while the register file allows it (radius <= 4)
  static constexpr int kMinCtas = R <= 4 ? 2 : 1;
};

// R: the window radius; each query has R+1 threads, thread `slot` owning
// window rows 2*slot and 2*slot+1.
template <int R>
__global__ void __launch_bounds__(Shape<R>::kThreads, Shape<R>::kMinCtas)
corr_window_kernel(const float* __restrict__ f1,      // [B, H*W, C]
                   const float* __restrict__ coords,  // [B, H*W, 2] (x, y)
                   float* __restrict__ out,           // [B, H*W, L*(2r+1)^2]
                   Levels lv, const int* __restrict__ sizes8,  // [B, 2] or null
                   int L, int H, int W, int C, float scale) {
  constexpr int kThreads = Shape<R>::kThreads;
  constexpr int WIN = 2 * R + 2;
  constexpr int NWIN = WIN * WIN;
  constexpr int N = 2 * R + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int s_ix0[kTile], s_iy0[kTile], s_state[kTile];
  __shared__ float s_fx[kTile], s_fy[kTile];
  __shared__ int s_box[5];                 // y lo, y hi, x lo, x hi (inclusive),
                                           // queries whose windows meet the region

  const int tid = threadIdx.x;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int qy0 = (blockIdx.x / tiles_w) * kTileH;
  const int qx0 = (blockIdx.x % tiles_w) * kTileW;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int Q = H * W;
  const int H2 = lv.h[l];
  const int W2 = lv.w[l];

  // the region windows may read: the map, or the item's live crop
  int live_h = H, live_w = W, clip_h = H2, clip_w = W2;
  if (sizes8 != nullptr) {
    live_h = max(sizes8[2 * b], 0);
    live_w = max(sizes8[2 * b + 1], 0);
    clip_h = min(H2, live_h >> l);
    clip_w = min(W2, live_w >> l);
  }

  if (tid == 0) {
    s_box[0] = INT_MAX; s_box[1] = INT_MIN;
    s_box[2] = INT_MAX; s_box[3] = INT_MIN;
    s_box[4] = 0;
  }
  __syncthreads();
  if (tid < kTile) {
    const int qy = qy0 + tid / kTileW;
    const int qx = qx0 + tid % kTileW;
    // 0: outside the grid, 1: dead (exact zeros), 2: live
    int state = 0;
    if (qy < H && qx < W) state = (qy < live_h && qx < live_w) ? 2 : 1;
    if (state == 2) {
      const size_t qi = (size_t)b * Q + (size_t)qy * W + qx;
      const float level_scale = 1.0f / (float)(1 << l);   // exact power of 2
      const float cx = coords[qi * 2] * level_scale;
      const float cy = coords[qi * 2 + 1] * level_scale;
      // clamp before the int conversion: a huge or NaN coordinate lands far
      // outside the map (fminf/fmaxf return the non-NaN operand)
      const int ix0 = (int)fmaxf(fminf(floorf(cx), 1e8f), -1e8f) - R;
      const int iy0 = (int)fmaxf(fminf(floorf(cy), 1e8f), -1e8f) - R;
      s_ix0[tid] = ix0;
      s_iy0[tid] = iy0;
      s_fx[tid] = cx - floorf(cx);
      s_fy[tid] = cy - floorf(cy);
      if (iy0 < clip_h && iy0 + WIN > 0 && ix0 < clip_w && ix0 + WIN > 0) {
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

  const int by0 = max(s_box[0], 0), by1 = min(s_box[1], clip_h - 1);
  const int bx0 = max(s_box[2], 0), bx1 = min(s_box[3], clip_w - 1);
  const int i = tid % kTile;               // this thread's query
  const int slot = tid / kTile;            // and its two window rows
  const bool live = s_state[i] == 2;
  const int ix0 = live ? s_ix0[i] : 0;
  const int iy0 = live ? s_iy0[i] : 0;
  const float* f2b = lv.f2[l] + (size_t)b * H2 * W2 * C;

  // Incoherent windows (a box much larger than the windows inside it)
  // share little: then, as in corr_lookup.cu, each warp takes one query at
  // a time, the lanes splitting its channels (coalesced reads) and a
  // shuffle reduction giving each in-region position's dot product.
  const long long box_area =
      (by0 <= by1 && bx0 <= bx1) ? (long long)(by1 - by0 + 1) * (bx1 - bx0 + 1) : 0;
  const bool direct = 2 * box_area > (long long)s_box[4] * NWIN;
  float* v = smem;                         // v[query][(2r+2)^2], scaled

  if (direct) {                            // uniform over the CTA
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int q = warp; q < kTile; q += kThreads / 32) {
      if (s_state[q] != 2) continue;       // uniform over the warp
      const float* f1q = f1 + ((size_t)b * Q + (size_t)(qy0 + q / kTileW) * W
                               + (qx0 + q % kTileW)) * C;
      float a[kMaxChannels / 32];          // lane owns channels lane + 32k
#pragma unroll
      for (int k = 0; k < kMaxChannels / 32; ++k)
        a[k] = lane + 32 * k < C ? __ldg(f1q + lane + 32 * k) : 0.0f;
      const int qx = s_ix0[q];
      const int qy = s_iy0[q];
      for (int p = 0; p < NWIN; ++p) {
        const int y = qy + p / WIN;
        const int x = qx + p % WIN;
        float t = 0.0f;
        if (y >= 0 && y < clip_h && x >= 0 && x < clip_w) {   // uniform
          const float* row = f2b + ((size_t)y * W2 + x) * C;
#pragma unroll
          for (int k = 0; k < kMaxChannels / 32; ++k)
            if (lane + 32 * k < C) t = fmaf(a[k], __ldg(row + lane + 32 * k), t);
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
            rowoff[j] = (yr * cw + xr) * kStride;
          }

          // stage chunk k of the sub-box and of the tile's f1 into buffer k&1
          auto stage = [&](int k) {
            float* buf = smem + (k & 1) * kBuf;
            const int c0 = k * kChunk;
            for (int e = tid; e < (npos + kTile) * kVec; e += kThreads) {
              const int row = e / kVec;
              const int c = c0 + 4 * (e % kVec);
              const float* src = f2b;
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
              cp16(buf + row * kStride + (e % kVec) * 4, src, bytes);
            }
            cp_commit();
          };

          stage(0);
          for (int k = 0; k < nchunks; ++k) {
            if (k + 1 < nchunks) {
              stage(k + 1);
              cp_wait<1>();
            } else {
              cp_wait<0>();
            }
            __syncthreads();                 // chunk k is in buffer k&1
            const float* buf = smem + (k & 1) * kBuf;
            if (rowok[0] || rowok[1]) {
              const float4* fa = reinterpret_cast<const float4*>(
                  buf + (npos + i) * kStride);
              float4 a[kVec];
#pragma unroll
              for (int m = 0; m < kVec; ++m) a[m] = fa[m];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (!rowok[j]) continue;
                const float* rowp = buf + rowoff[j];
#pragma unroll
                for (int c = 0; c < WIN; ++c) {
                  if (!((colmask >> c) & 1u)) continue;
                  const float4* s = reinterpret_cast<const float4*>(
                      rowp + c * kStride);
                  float t = acc[j][c];
#pragma unroll
                  for (int m = 0; m < kVec; ++m) {
                    const float4 v = s[m];
                    t = fmaf(a[m].x, v.x, t);
                    t = fmaf(a[m].y, v.y, t);
                    t = fmaf(a[m].z, v.z, t);
                    t = fmaf(a[m].w, v.w, t);
                  }
                  acc[j][c] = t;
                }
              }
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
    const int st = s_state[qi];
    if (st == 0) continue;
    const int qy = qy0 + qi / kTileW;
    const int qx = qx0 + qi % kTileW;
    float o = 0.0f;
    if (st == 2) {
      const int ox = t / N;                // x offset
      const int oy = t % N;                // y offset
      const float* vq = v + qi * NWIN;
      const float v00 = vq[oy * WIN + ox];
      const float v01 = vq[oy * WIN + ox + 1];
      const float v10 = vq[(oy + 1) * WIN + ox];
      const float v11 = vq[(oy + 1) * WIN + ox + 1];
      const float fx = s_fx[qi];
      const float fy = s_fy[qi];
      // y taps first, then x taps: the order of the one-hot contractions
      o = (1.0f - fx) * ((1.0f - fy) * v00 + fy * v10)
        + fx * ((1.0f - fy) * v01 + fy * v11);
    }
    out[((size_t)b * Q + (size_t)qy * W + qx) * (size_t)(L * NN)
        + (size_t)l * NN + t] = o;
  }
}

template <int R>
cudaError_t launch(const float* f1, const float* coords, float* out,
                   const Levels& lv, const int* sizes8, int L, int B, int H,
                   int W, int C, float scale, cudaStream_t stream) {
  constexpr int NWIN = (2 * R + 2) * (2 * R + 2);
  static_assert(kTile * NWIN <= 2 * kBuf, "window values fit the buffers");
  const int smem = 2 * kBuf * (int)sizeof(float);
  // above 48 KB dynamic shared memory needs an opt-in, once per device (the
  // call is too slow for every launch)
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(corr_window_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  const int tiles = ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  dim3 grid(tiles, L, B);
  corr_window_kernel<R><<<grid, Shape<R>::kThreads, smem, stream>>>(
      f1, coords, out, lv, sizes8, L, H, W, C, scale);
  return cudaGetLastError();
}

int run(const float* f1, const float* coords, float* out,
        const void* const* f2_ptrs, const int* level_hw, const int* sizes8,
        int num_levels, int B, int H, int W, int C, int radius, float scale,
        void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 || radius > 7 ||
      C < 4 || C % 4 != 0 || C > kMaxChannels || B < 1 || H < 1 || W < 1 ||
      B > 65535 || (long long)H * W > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.f2[l] = static_cast<const float*>(f2_ptrs[l]);
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAFT_WINDOW_CASE(RR) \
  case RR: return (int)launch<RR>(f1, coords, out, lv, sizes8, num_levels, \
                                  B, H, W, C, scale, s);
  switch (radius) {
    RAFT_WINDOW_CASE(0) RAFT_WINDOW_CASE(1) RAFT_WINDOW_CASE(2)
    RAFT_WINDOW_CASE(3) RAFT_WINDOW_CASE(4) RAFT_WINDOW_CASE(5)
    RAFT_WINDOW_CASE(6) RAFT_WINDOW_CASE(7)
  }
#undef RAFT_WINDOW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f2_ptrs / level_hw are HOST arrays: L device pointers and (h, w) pairs.
// Returns a cudaError_t (0 on success); launches on `stream`, never syncs.
extern "C" int corr_window_f32(const float* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, int num_levels, int B,
                               int H, int W, int C, int radius, float scale,
                               void* stream) {
  return run(f1, coords, out, f2_ptrs, level_hw, nullptr, num_levels, B, H, W,
             C, radius, scale, stream);
}

// sizes8: DEVICE array [B, 2] int32, each item's live (h, w) on the query
// grid; f1 and the f2 levels are expected masked outside it.
extern "C" int corr_ragged_f32(const float* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, const int* sizes8,
                               int num_levels, int B, int H, int W, int C,
                               int radius, float scale, void* stream) {
  if (sizes8 == nullptr) return (int)cudaErrorInvalidValue;
  return run(f1, coords, out, f2_ptrs, level_hw, sizes8, num_levels, B, H, W,
             C, radius, scale, stream);
}
