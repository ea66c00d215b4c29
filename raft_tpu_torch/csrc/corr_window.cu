// Window-scheduled and narrow-level correlation lookups for RAFT, for
// Hopper (sm_90a).
//
// One kernel, three entries, replacing three Pallas kernels of
// raft_tpu/ops/corr_pallas.py:
//  * corr_window_{f32,bf16} — _lookup_level with p_select='window'
//    (_window_kernel, schedule _window_schedule, :342), reached through
//    make_window_lookup;
//  * corr_ragged_{f32,bf16} — _ragged_lookup_level (_ragged_window_kernel,
//    schedule _ragged_schedule, :604), reached through
//    make_ragged_fused_lookup: items are corner-anchored crops of one
//    shared max box, f1 and the f2 pyramid masked to zero outside them;
//  * corr_packed_{f32,bf16} — _packed_body (:125), the body both
//    pallas_calls of _lookup_level (:342, :349) run under pallas_pack=True
//    for every level whose width leaves at least half of the TPU's 128
//    lanes empty (W_l <= 64), reached through make_fused_lookup and
//    make_window_lookup with pack=True.  One launch covers every level: the
//    narrow ones (from packed_from on) in whole rows, the wide ones as the
//    window entry does.
// Same values as corr_lookup.cu: for each (item, query, level) the
// correlation <f1[q], f2_l[p]> / sqrt(C) is sampled bilinearly on a
// (2r+1)^2 window centred at coords / 2^l, zeros outside the map, written
// x-offset-major at out[b, q, l*(2r+1)^2 + ix*(2r+1) + iy].  The ragged
// entry writes exact zeros for dead queries (outside the item's live
// sizes8 extent) without reading f2.  Operands are float32 (*_f32) or
// bfloat16 (*_bf16, the corr_precision='default' operands); all arithmetic
// is FP32 FMA (no TF32), the output float32.
//
// Design.  One CTA serves a tile of neighbouring queries at one level of
// one item: grid (query tiles, level, item).  It first computes its
// schedule on the device: the bounding box of the tile's windows (the rows
// of the TPU schedule, plus the columns), clipped to the map — for a
// ragged item to its live rows and columns at that level, so dead pages are
// never read.  It then stages that f2 box, with the tile's f1, through
// shared memory in stages of 64 bytes of channels (16 float32 or 32
// bfloat16; cp.async, two buffers: the next stage loads while this one is
// used), so the tile's overlapping windows share each f2 read
// (corr_lookup.cu re-reads f2 per query from global memory).  A box larger
// than a buffer is walked in sub-boxes; each window position belongs to
// exactly one, so the channel sums run in the same order whatever the
// split.  Each query has r+1 threads, each owning two rows of its
// (2r+2)^2 window, whose dot products accumulate in registers.  When the
// tile's windows are incoherent (the box holds more than half the
// positions its windows read in all, as random-weight flows of hundreds of
// pixels give) staging would buy little, and the CTA computes the dot
// products as corr_lookup.cu does instead: one warp per query, lanes over
// channels, a shuffle reduction per position.  Either way the (2r+2)^2
// values go through shared memory into the bilinear combine.
//
// The narrow levels.  The TPU packs `pack` rows of a narrow level side by
// side so that one 128-lane tile covers pack x more of the map, with a
// parity-aware x one-hot that keeps windows in their own sub-row.  The
// H100 has no lane tile to fill, so nothing is packed here: what packing
// bought on the TPU — one block covers a narrow level — is what the packed
// entry does with shared memory.  A narrow level is small (at 432x1024,
// levels 1-3 are 27x64, 13x32 and 6x16: 1.8, 0.4 and 0.1 MB of float32 f2,
// all in L2), so its box is made of FULL-WIDTH rows (contiguous in memory):
// every row under p_select='all', the rows the tile's windows touch under
// 'window' (the counterpart of _window_schedule with pack), and it is
// always staged.  The packed entry's tile is 4x32 queries (twice the
// window entry's 8x8), so each staged row is read by more queries; a warp
// is one row of 32 neighbouring queries, whose windows on a coarse level
// mostly start at the same column, so their shared-memory reads
// broadcast.  The tile is capped by the threads a CTA may have (r+1 per
// query: 1024 at radius 7), not by the TPU's pack factor.  A 0-sized level
// gives zeros and reads nothing.
//
// Bound: the FP32 FMAs of the in-map window positions, as corr_lookup.cu;
// the inner loop does 4 FMAs per 16-byte shared-memory load for float32
// operands (8 for bfloat16), so it can reach about a quarter of the FP32
// rate at best.

#include <limits.h>

#include "corr_common.cuh"

namespace {

using raft_corr::kRowBytes;
using raft_corr::kStageBytes;
using raft_corr::kStageVecs;
using raft_corr::Levels;

constexpr int kMaxDevices = 64;
constexpr int kMaxChannels = 512;
constexpr int kMaxPackedWidth = 64;        // 128 // W_l >= 2

// The two tilings of the kernel: the window and ragged entries give an 8x8
// tile of queries a CTA (two CTAs per SM while the register file allows
// it), the packed entry a 4x32 tile (one CTA per SM, larger sub-boxes).
struct WindowTile {
  static constexpr int kH = 8, kW = 8;
  static constexpr int kMaxPos = 448;      // f2 positions per staged sub-box
  static constexpr int kCtas = 2;
};
struct PackedTile {
  static constexpr int kH = 4, kW = 32;
  static constexpr int kMaxPos = 1152;
  static constexpr int kCtas = 1;
};

template <class Tile, int R>
struct Shape {
  static constexpr int kTile = Tile::kH * Tile::kW;   // queries per CTA
  static constexpr int kThreads = kTile * (R + 1);
  static constexpr int kMinCtas = R <= 4 ? Tile::kCtas : 1;
  static constexpr int kBufBytes = (Tile::kMaxPos + kTile) * kRowBytes;
};

// R: the window radius; each query has R+1 threads, thread `slot` owning
// window rows 2*slot and 2*slot+1.  Levels from packed_from on are staged
// in whole rows, all of them if all_rows.
template <typename T, int R, class Tile>
__global__ void __launch_bounds__(Shape<Tile, R>::kThreads,
                                  Shape<Tile, R>::kMinCtas)
corr_window_kernel(const T* __restrict__ f1,          // [B, H*W, C]
                   const float* __restrict__ coords,  // [B, H*W, 2] (x, y)
                   float* __restrict__ out,           // [B, H*W, L*(2r+1)^2]
                   Levels lv, const int* __restrict__ sizes8,  // [B, 2] or null
                   int L, int H, int W, int C, float scale, int packed_from,
                   int all_rows) {
  using S = Shape<Tile, R>;
  constexpr int kThreads = S::kThreads;
  constexpr int kTile = S::kTile;
  constexpr int kTileH = Tile::kH;
  constexpr int kTileW = Tile::kW;
  constexpr int kMaxPos = Tile::kMaxPos;
  constexpr int kBufBytes = S::kBufBytes;
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
      const int ix0 = raft_corr::clamped_floor(cx) - R;
      const int iy0 = raft_corr::clamped_floor(cy) - R;
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

  int by0 = max(s_box[0], 0), by1 = min(s_box[1], clip_h - 1);
  int bx0 = max(s_box[2], 0), bx1 = min(s_box[3], clip_w - 1);
  const bool packed = l >= packed_from;    // a narrow level: whole rows
  if (packed) {
    bx0 = 0;
    bx1 = clip_w - 1;
    if (all_rows) {
      by0 = 0;
      by1 = clip_h - 1;
    }
  }
  const int i = tid % kTile;               // this thread's query
  const int slot = tid / kTile;            // and its two window rows
  const bool live = s_state[i] == 2;
  const int ix0 = live ? s_ix0[i] : 0;
  const int iy0 = live ? s_iy0[i] : 0;
  const T* f2b = static_cast<const T*>(lv.f2[l]) + (size_t)b * H2 * W2 * C;

  // Incoherent windows (a box much larger than the windows inside it)
  // share little: then, as in corr_lookup.cu, each warp takes one query at
  // a time, the lanes splitting its channels (coalesced reads) and a
  // shuffle reduction giving each in-region position's dot product.  A
  // narrow level is always staged.
  const long long box_area =
      (by0 <= by1 && bx0 <= bx1) ? (long long)(by1 - by0 + 1) * (bx1 - bx0 + 1) : 0;
  const bool direct = !packed && 2 * box_area > (long long)s_box[4] * NWIN;
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
        if (y >= 0 && y < clip_h && x >= 0 && x < clip_w) {   // uniform
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
    const int st = s_state[qi];
    if (st == 0) continue;
    const int qy = qy0 + qi / kTileW;
    const int qx = qx0 + qi % kTileW;
    float o = 0.0f;
    if (st == 2) {
      const int ox = t / N;                // x offset
      const int oy = t % N;                // y offset
      const float* vq = v + qi * NWIN;
      o = raft_corr::bilinear(vq[oy * WIN + ox], vq[oy * WIN + ox + 1],
                              vq[(oy + 1) * WIN + ox],
                              vq[(oy + 1) * WIN + ox + 1], s_fx[qi], s_fy[qi]);
    }
    out[((size_t)b * Q + (size_t)qy * W + qx) * (size_t)(L * NN)
        + (size_t)l * NN + t] = o;
  }
}

template <typename T, int R, class Tile>
cudaError_t launch(const T* f1, const float* coords, float* out,
                   const Levels& lv, const int* sizes8, int L, int B, int H,
                   int W, int C, float scale, int packed_from, int all_rows,
                   cudaStream_t stream) {
  using S = Shape<Tile, R>;
  constexpr int NWIN = (2 * R + 2) * (2 * R + 2);
  static_assert(S::kTile * NWIN * (int)sizeof(float) <= 2 * S::kBufBytes,
                "window values fit the buffers");
  const int smem = 2 * S::kBufBytes;
  // above 48 KB dynamic shared memory needs an opt-in, once per device (the
  // call is too slow for every launch)
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(corr_window_kernel<T, R, Tile>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  const int tiles =
      ((H + Tile::kH - 1) / Tile::kH) * ((W + Tile::kW - 1) / Tile::kW);
  dim3 grid(tiles, L, B);
  corr_window_kernel<T, R, Tile><<<grid, S::kThreads, smem, stream>>>(
      f1, coords, out, lv, sizes8, L, H, W, C, scale, packed_from, all_rows);
  return cudaGetLastError();
}

template <typename T, class Tile>
int run(const void* f1v, const float* coords, float* out,
        const void* const* f2_ptrs, const int* level_hw, const int* sizes8,
        int num_levels, int B, int H, int W, int C, int radius, float scale,
        int packed_from, int all_rows, void* stream) {
  constexpr int kN = raft_corr::Vec16<T>::kN;
  if (num_levels < 1 || num_levels > raft_corr::kMaxLevels || radius < 0 ||
      radius > 7 || C < kN || C % kN != 0 || C > kMaxChannels || B < 1 ||
      H < 1 || W < 1 || B > 65535 || (long long)H * W > INT_MAX / 2 ||
      packed_from < 0 || packed_from > num_levels)
    return (int)cudaErrorInvalidValue;
  for (int l = packed_from; l < num_levels; ++l)
    if (level_hw[2 * l + 1] > kMaxPackedWidth || level_hw[2 * l] < 0 ||
        level_hw[2 * l + 1] < 0)
      return (int)cudaErrorInvalidValue;   // not a narrow level
  const Levels lv = raft_corr::make_levels(f2_ptrs, level_hw, num_levels);
  const T* f1 = static_cast<const T*>(f1v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAFT_WINDOW_CASE(RR)                                                  \
  case RR: return (int)launch<T, RR, Tile>(f1, coords, out, lv, sizes8,       \
                                           num_levels, B, H, W, C, scale,     \
                                           packed_from, all_rows, s);
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
  return run<float, WindowTile>(f1, coords, out, f2_ptrs, level_hw, nullptr,
                                num_levels, B, H, W, C, radius, scale,
                                num_levels, 0, stream);
}

extern "C" int corr_window_bf16(const void* f1, const float* coords,
                                float* out, const void* const* f2_ptrs,
                                const int* level_hw, int num_levels, int B,
                                int H, int W, int C, int radius, float scale,
                                void* stream) {
  return run<__nv_bfloat16, WindowTile>(f1, coords, out, f2_ptrs, level_hw,
                                        nullptr, num_levels, B, H, W, C,
                                        radius, scale, num_levels, 0, stream);
}

// sizes8: DEVICE array [B, 2] int32, each item's live (h, w) on the query
// grid; f1 and the f2 levels are expected masked outside it.
extern "C" int corr_ragged_f32(const void* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, const int* sizes8,
                               int num_levels, int B, int H, int W, int C,
                               int radius, float scale, void* stream) {
  if (sizes8 == nullptr) return (int)cudaErrorInvalidValue;
  return run<float, WindowTile>(f1, coords, out, f2_ptrs, level_hw, sizes8,
                                num_levels, B, H, W, C, radius, scale,
                                num_levels, 0, stream);
}

extern "C" int corr_ragged_bf16(const void* f1, const float* coords,
                                float* out, const void* const* f2_ptrs,
                                const int* level_hw, const int* sizes8,
                                int num_levels, int B, int H, int W, int C,
                                int radius, float scale, void* stream) {
  if (sizes8 == nullptr) return (int)cudaErrorInvalidValue;
  return run<__nv_bfloat16, WindowTile>(f1, coords, out, f2_ptrs, level_hw,
                                        sizes8, num_levels, B, H, W, C,
                                        radius, scale, num_levels, 0, stream);
}

// The levels from packed_from on must be at most 64 wide (the narrow
// levels); all_rows = 1 stages every row of them (p_select='all'), 0 only
// the rows the windows touch ('window').
extern "C" int corr_packed_f32(const void* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, int num_levels,
                               int packed_from, int B, int H, int W, int C,
                               int radius, float scale, int all_rows,
                               void* stream) {
  return run<float, PackedTile>(f1, coords, out, f2_ptrs, level_hw, nullptr,
                                num_levels, B, H, W, C, radius, scale,
                                packed_from, all_rows, stream);
}

extern "C" int corr_packed_bf16(const void* f1, const float* coords,
                                float* out, const void* const* f2_ptrs,
                                const int* level_hw, int num_levels,
                                int packed_from, int B, int H, int W, int C,
                                int radius, float scale, int all_rows,
                                void* stream) {
  return run<__nv_bfloat16, PackedTile>(f1, coords, out, f2_ptrs, level_hw,
                                        nullptr, num_levels, B, H, W, C,
                                        radius, scale, packed_from, all_rows,
                                        stream);
}
