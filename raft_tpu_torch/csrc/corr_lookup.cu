// Correlation window lookups for RAFT on Hopper (sm_90a): one tile body,
// four kernels of the TPU package.
//
// Replaces four Pallas kernels of raft_tpu/ops/corr_pallas.py:
//  * corr_lookup_{f32,bf16} — _lookup_level with p_select='all'
//    (_level_kernel + _window_body, :349), reached through fused_lookup and
//    make_fused_lookup;
//  * corr_window_{f32,bf16} — _lookup_level with p_select='window'
//    (_window_kernel, which runs _window_body only on the f2 row blocks
//    that _window_schedule names, :342), reached through window_lookup and
//    make_window_lookup;
//  * corr_ragged_{f32,bf16} — _ragged_lookup_level (_ragged_window_kernel,
//    schedule _ragged_schedule, :604), reached through
//    make_ragged_fused_lookup: items are corner-anchored crops of one
//    shared max box, f1 and the f2 pyramid masked to zero outside them;
//  * corr_packed_{f32,bf16} — _packed_body (:125), the body both
//    pallas_calls of _lookup_level (:342, :349) run under pallas_pack=True
//    for the levels whose width leaves at least half of the TPU's 128 lanes
//    empty (W_l <= 64), reached through make_fused_lookup and
//    make_window_lookup with pack=True.
// Same values for all: for each (item, query, level) the correlation
// <f1[q], f2_l[p]> / sqrt(C) is sampled bilinearly on a (2r+1)^2 window
// centred at coords / 2^l, zeros outside the map, written x-offset-major
// at out[b, q, l*(2r+1)^2 + ix*(2r+1) + iy].  The ragged entry writes exact
// zeros for dead queries (outside the item's live sizes8 extent).
//
// What bounds it: a call reads f1 and the pyramid once and writes the
// output (about 25 MB in float32 at 432x1024), and its dot products are
// 2*C FLOPs per in-map window position; on the tensor cores (3xTF32 at
// 165 TFLOP/s for float32 operands, one BF16 MMA at 989 for bfloat16) the
// bytes bound it.  Neighbouring queries' windows overlap almost entirely
// on coherent flow, so re-reading f2 per query (what a gather does) costs
// many times the bytes; on incoherent flow nothing is shared.
//
// Design.  A CTA takes a tile of neighbouring queries (8x8) at one level
// of one item (grid: query tiles, level, item) and first computes, on the
// device, the bounding box of the tile's windows within the region they
// may read: the map or, for a ragged item, its live crop at that level
// (min(H_l, live_h >> l) x min(W_l, live_w >> l), the extents
// ragged_pyramid keeps).  Dead queries and windows that miss the region
// are written as exact zeros and read nothing.  Then, uniform over the CTA:
//  * Coherent tile (the box holds at most mma_ratio times the in-region
//    window positions of the tile's queries): the TPU kernel's [T, P] tile,
//    on the tensor cores.  The box is walked in chunks of 128
//    positions; for each, S = F1_tile . F2_chunk^T is
//    formed by mma.sync over slabs of 128 bytes of channels staged through
//    shared memory (cp.async, two buffers: the next slab loads while this
//    one is multiplied; channels past C zero-filled): 3xTF32 for float32
//    operands, one BF16 MMA for bfloat16 (tensor_core.cuh).  Each of the 8
//    warps computes a 32 x 32 block of the 64 x 128 S.  Each slab's
//    products go to a fresh accumulator added to an FP32 register sum.
//    Each accumulator element whose position lies in its query's (2r+2)^2
//    window is written, scaled, to that query's window buffer; the rest is
//    discarded.
//  * Incoherent tile: a gather.  One warp per query, over the in-region
//    part of its window only; each lane owns whole
//    16-byte vectors of channels (4 float32 or 8 bfloat16; a warp load is a
//    512-byte row), a group of 4 or 8 window positions is loaded at once,
//    and the group's per-lane partial sums are reduced together by a
//    transposed butterfly (log2 of the group's shuffles per position
//    instead of 5).  C not a multiple of the vector, or unaligned maps, take
//    a scalar form of the gather (lane i owns channels i, i+32, ...), and so
//    every tile of such an input.
// Either way the window values go through shared memory into the bilinear
// combine.  Radius above 7 takes the gather only.  The MMA path's first
// iteration on the main path (flow 0) is perfectly coherent; the seeded
// random weights' flows of hundreds of pixels make later iterations
// incoherent.  Operands are float32 (*_f32) or bfloat16 (*_bf16, the
// corr_precision='default' operands); sums and the output are float32.
//
// The narrow levels (corr_packed_*).  The TPU packs `pack` rows of a
// narrow level side by side so that one 128-lane tile covers pack x more of
// the map.  The H100 has no lane tile to fill; what packing bought there,
// a narrow level covered by one matrix tile, is here a box clipped to a
// small level (13x32 and 6x16 at 432x1024), which the box test sends to
// the tensor cores where the windows in it are coherent.  So the packed
// entries run corr_lookup_*'s kernel as it is, every level on the 8x8 tile
// (wider query tiles on the narrow levels, 8x16 and 16x16, were slower on
// every kind of coords measured: PERF.md).  p_select='all' and 'window'
// take the same route: every tile's box is its windows' box (the rows
// 'window' schedules); 'all' reads more on the TPU for the same values.

#include <limits.h>

#include "corr_common.cuh"

namespace {

using raft_corr::Levels;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileH = 8, kTileW = 8;
constexpr int kTile = kTileH * kTileW;   // queries per CTA (the MMA's M)
constexpr int kChunk = 128;              // box positions per MMA chunk (N)
constexpr int kRowWords = 40;            // staged row: 128 bytes + 32 of pad
constexpr int kStageWords = (kTile + kChunk) * kRowWords;
constexpr int kStagingBytes = 2 * kStageWords * 4;
constexpr int kMaxWin = 32;              // (2r+2) <= 32, i.e. radius <= 15
constexpr int kMmaMaxWin = 16;           // the MMA path: radius <= 7
constexpr int kMaxDevices = 64;
constexpr int kFar = 1 << 29;            // a window origin nothing reaches

// 3xTF32 (float32) or one BF16 MMA (bfloat16) over one staged slab: four
// k-steps of 8 words (8 float32 or 16 bfloat16 channels).  Within a k-step
// the channels are taken in the order that makes each fragment one 8-byte
// load: MMA k-index t <-> word 2t, t+4 <-> word 2t+1, for A and B alike.
template <typename T>
__device__ __forceinline__ void slab_mma(const uint32_t* F1s,
                                         const uint32_t* F2s, int arow,
                                         int brow, int tq,
                                         float (&part)[2][4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int col = 8 * ks + 2 * tq;
    if constexpr (sizeof(T) == 4) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 x = *reinterpret_cast<const float2*>(
              F1s + (arow + 16 * i + 8 * e) * kRowWords + col);
          raft_tc::split_tf32(x.x, ah[i][e], al[i][e]);
          raft_tc::split_tf32(x.y, ah[i][2 + e], al[i][2 + e]);
        }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            F2s + (brow + 8 * j) * kRowWords + col);
        raft_tc::split_tf32(y.x, bh[j][0], bl[j][0]);
        raft_tc::split_tf32(y.y, bh[j][1], bl[j][1]);
      }
      // small products first; each pass runs over all 8 accumulators so no
      // MMA waits on the one before it
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          raft_tc::mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          raft_tc::mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          raft_tc::mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
    } else {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint2 u = *reinterpret_cast<const uint2*>(
              F1s + (arow + 16 * i + 8 * e) * kRowWords + col);
          a[i][e] = u.x;
          a[i][2 + e] = u.y;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            F2s + (brow + 8 * j) * kRowWords + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) raft_tc::mma_bf16(part[i][j], a[i], b.x, b.y);
      }
    }
  }
}

// G partial sums per lane (one per position of a group) -> lane holds the
// full sum of position (lane >> (5 - log2 G)) & (G-1): each step sends half
// of the list to the partner lane and keeps the other half, then the lanes
// that hold one position sum up.
template <int G>
__device__ __forceinline__ float butterfly(float (&v)[G], int lane) {
  int h = G / 2;
#pragma unroll
  for (int off = 16; off >= 32 / G; off >>= 1, h >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < G / 2; ++i) {
      if (i < h) {
        const float send = upper ? v[i] : v[i + h];
        const float keep = upper ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }
#pragma unroll
  for (int off = 16 / G; off >= 1; off >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

// The gather of one query's (2r+2)^2 window into vq (scaled): the window's
// part inside the region [0, Hc) x [0, Wc) only (the rest of vq is zeroed);
// W2 is the map's row length.  VEC: lanes own 16-byte
// vectors (NV per lane: C <= 32*NV*kN); else lanes own channels lane + 32k
// (NV*4 of them: C <= 128*NV).  G positions per group.
template <typename T, bool VEC, int NV, int G>
__device__ void gather_query(const T* __restrict__ f1q,
                             const T* __restrict__ f2b, int W2, int Hc, int Wc,
                             int C,
                             int ix0, int iy0, int win, float scale,
                             float* vq, int lane) {
  using V = raft_corr::Vec16<T>;
  constexpr int kN = VEC ? V::kN : 1;
  constexpr int kPer = VEC ? NV : 4 * NV;  // loads per lane per position
  const int nvec = VEC ? C / kN : C;       // vectors (or channels) per row
  float a[kPer][kN];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int u = lane + 32 * j;
    if constexpr (VEC) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (u < nvec) raw = *reinterpret_cast<const uint4*>(f1q + u * kN);
      V::unpack(raw, a[j]);
    } else {
      a[j][0] = u < nvec ? raft_corr::to_float(f1q[u]) : 0.0f;
    }
  }
  for (int p = lane; p < win * win; p += 32) vq[p] = 0.0f;
  // the in-region rectangle [y0, y0 + ch) x [x0, x0 + cw) of the window
  const int y0 = max(iy0, 0), x0 = max(ix0, 0);
  const int ch = min(iy0 + win, Hc) - y0, cw = min(ix0 + win, Wc) - x0;
  const int npos = ch * cw;
  const int pos_shift = G == 8 ? 2 : 3;    // lane >> shift: a group position
  const T* base = f2b + ((size_t)y0 * W2 + x0) * C;
  __syncwarp();
  int gy = 0, gx = 0;                      // the group's first position
  for (int p0 = 0; p0 < npos; p0 += G) {
    float part[G];
    int wy = gy, wx = gx;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const bool ok = p0 + k < npos;
      const T* row = base + ((size_t)wy * W2 + wx) * C;
      if (++wx == cw) {
        wx = 0;
        ++wy;
      }
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int u = lane + 32 * j;
        if constexpr (VEC) {
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (ok && u < nvec) raw = __ldg(reinterpret_cast<const uint4*>(row + u * kN));
          float b[kN];
          V::unpack(raw, b);
#pragma unroll
          for (int e = 0; e < kN; ++e) t = fmaf(a[j][e], b[e], t);
        } else {
          const float b = ok && u < nvec ? raft_corr::to_float(row[u]) : 0.0f;
          t = fmaf(a[j][0], b, t);
        }
      }
      part[k] = t;
    }
    gy = wy;
    gx = wx;
    const float s = butterfly<G>(part, lane);
    const int p = p0 + ((lane >> pos_shift) & (G - 1));
    if ((lane & ((1 << pos_shift) - 1)) == 0 && p < npos) {
      const int py = p / cw;
      vq[(y0 - iy0 + py) * win + (x0 - ix0) + (p - py * cw)] = s * scale;
    }
  }
}

// One CTA: an 8x8 tile of queries at one level of one item (the design
// above); grid (query tiles, level, item).  RAGGED: items are crops of the
// box (sizes8), compiled out of the other entries.  The ragged-only forms
// (zeros written for dead queries, whose bilinear weights are never set;
// F1 staged only for the windows kept) stay out of the other entries'
// code: with them there, B1 measured 3% slower on the H100 (PERF.md).
template <typename T, bool VEC, int NV, bool RAGGED>
__global__ void __launch_bounds__(kThreads, 2)
corr_lookup_kernel(const T* __restrict__ f1,          // [B, H*W, C]
                   const float* __restrict__ coords,  // [B, H*W, 2] (x, y)
                   float* __restrict__ out,           // [B, H*W, L*(2r+1)^2]
                   const __grid_constant__ Levels lv,
                   const int* __restrict__ sizes8,    // [B, 2] or null
                   int L, int H, int W, int C, int r, float scale, int mma_ok,
                   float mma_ratio, int* __restrict__ stats) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_ix0[kTile], s_iy0[kTile], s_state[kTile];
  __shared__ float s_fx[kTile], s_fy[kTile];
  __shared__ int s_box[5];                 // y lo, y hi, x lo, x hi (inclusive),
                                           // in-region window positions
  constexpr int G = (VEC ? NV : 4 * NV) >= 4 ? 4 : 8;   // positions per group
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int qy0 = (blockIdx.x / tiles_w) * kTileH;
  const int qx0 = (blockIdx.x % tiles_w) * kTileW;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int Q = H * W;
  const int H2 = lv.h[l];
  const int W2 = lv.w[l];
  const int win = 2 * r + 2;
  const int nwin = win * win;
  const int n = 2 * r + 1;
  // the queries that are live and the region their windows may read: the
  // whole grid and map, or a ragged item's live crop and its extent at
  // this level
  int live_h = H, live_w = W, Hc = H2, Wc = W2;
  if constexpr (RAGGED) {
    live_h = max(sizes8[2 * b], 0);
    live_w = max(sizes8[2 * b + 1], 0);
    Hc = min(H2, live_h >> l);
    Wc = min(W2, live_w >> l);
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
    // 0: outside the grid (nothing written); 1: exact zeros (a dead query,
    // or a window that misses the region); 2: the window meets the region
    int state = 0, ix0 = kFar, iy0 = kFar;
    if (qy < H && qx < W) {
      state = 1;
      if (!RAGGED || (qy < live_h && qx < live_w)) {
        const size_t qi = (size_t)b * Q + (size_t)qy * W + qx;
        const float level_scale = 1.0f / (float)(1 << l);   // exact power of 2
        const float cx = coords[qi * 2] * level_scale;
        const float cy = coords[qi * 2 + 1] * level_scale;
        s_fx[tid] = cx - floorf(cx);
        s_fy[tid] = cy - floorf(cy);
        const int x0 = raft_corr::clamped_floor(cx) - r;
        const int y0 = raft_corr::clamped_floor(cy) - r;
        if (y0 < Hc && y0 + win > 0 && x0 < Wc && x0 + win > 0) {
          state = 2;
          ix0 = x0;
          iy0 = y0;
          atomicMin(&s_box[0], y0);
          atomicMax(&s_box[1], y0 + win - 1);
          atomicMin(&s_box[2], x0);
          atomicMax(&s_box[3], x0 + win - 1);
          // the window's in-region positions: the gather's work
          atomicAdd(&s_box[4], (min(y0 + win, Hc) - max(y0, 0)) *
                                   (min(x0 + win, Wc) - max(x0, 0)));
        }
      }
    }
    s_ix0[tid] = ix0;
    s_iy0[tid] = iy0;
    s_state[tid] = state;
  }
  __syncthreads();

  const int by0 = max(s_box[0], 0), by1 = min(s_box[1], Hc - 1);
  const int bx0 = max(s_box[2], 0), bx1 = min(s_box[3], Wc - 1);
  const int bw = bx1 - bx0 + 1;
  const int box_area = (by0 <= by1 && bx0 <= bx1) ? (by1 - by0 + 1) * bw : 0;
  const bool use_mma = mma_ok && box_area > 0 &&
                       (float)box_area <= mma_ratio * (float)s_box[4];
  if (stats != nullptr && tid == 0)
    atomicAdd(&stats[2 * l + (use_mma ? 0 : 1)], 1);
  const T* f2b = static_cast<const T*>(lv.f2[l]) + (size_t)b * H2 * W2 * C;
  const size_t q_base = (size_t)b * Q;
  const int NN = n * n;

  if (use_mma) {                           // uniform over the CTA
    float* v = reinterpret_cast<float*>(smem) + kStagingBytes / 4;
    for (int e = tid; e < kTile * nwin; e += kThreads) v[e] = 0.0f;
    const int gq = lane >> 2, tq = lane & 3;
    const int wm = warp >> 2, wn = warp & 3; // 2 x 4 warps, 32 x 32 each
    const int arow = wm * 32 + gq;
    const int brow = wn * 32 + gq;
    int qix[4], qiy[4];                    // this thread's 4 queries' windows
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qix[k] = s_ix0[arow + 8 * k];        // rows arow + 16i + 8e, k = 2i + e
      qiy[k] = s_iy0[arow + 8 * k];
    }
    const int row_bytes = C * (int)sizeof(T);
    const int nslab = (row_bytes + 127) / 128;
    const int nchunk = (box_area + kChunk - 1) / kChunk;
    const int nsteps = nchunk * nslab;

    auto stage = [&](int step) {
      uint32_t* buf = smem + (step & 1) * kStageWords;
      const int chunk = step / nslab;
      const int boff = (step - chunk * nslab) * 128;
      for (int e = tid; e < (kTile + kChunk) * 8; e += kThreads) {
        const int row = e >> 3;
        const int off = boff + (e & 7) * 16;
        const char* src = reinterpret_cast<const char*>(f1);
        bool ok = off < row_bytes;
        if (row < kTile) {                 // ragged: only the windows kept
          const int qy = qy0 + row / kTileW, qx = qx0 + row % kTileW;
          ok = ok && (RAGGED ? s_state[row] == 2 : qy < H && qx < W);
          if (ok)
            src = reinterpret_cast<const char*>(
                      f1 + (q_base + (size_t)qy * W + qx) * C) + off;
        } else {
          const int pos = chunk * kChunk + row - kTile;
          ok = ok && pos < box_area;
          if (ok) {
            const int y = by0 + pos / bw, x = bx0 + pos % bw;
            src = reinterpret_cast<const char*>(
                      f2b + ((size_t)y * W2 + x) * C) + off;
          }
        }
        raft_corr::cp16(buf + row * kRowWords + (e & 7) * 4, src, ok ? 16 : 0);
      }
      raft_corr::cp_commit();
    };

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
    stage(0);
    for (int step = 0; step < nsteps; ++step) {
      if (step + 1 < nsteps) {
        stage(step + 1);
        raft_corr::cp_wait<1>();
      } else {
        raft_corr::cp_wait<0>();
      }
      __syncthreads();                     // slab `step` is in buffer step&1
      const uint32_t* buf = smem + (step & 1) * kStageWords;
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[i][j][k] = 0.0f;
      slab_mma<T>(buf, buf + kTile * kRowWords, arow, brow, tq, part);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] += part[i][j][k];
      const int chunk = step / nslab;
      if (step - chunk * nslab == nslab - 1) {
        // keep what lies in its query's window: element (i, j, 2e + u) is
        // query arow + 16i + 8e, chunk position brow - gq + 8j + 2tq + u
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int pos = chunk * kChunk + wn * 32 + 8 * j + 2 * tq + u;
            if (pos >= box_area) continue;
            const int y = by0 + pos / bw, x = bx0 + pos % bw;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int k = 2 * i + e;
                const unsigned dx = (unsigned)(x - qix[k]);
                const unsigned dy = (unsigned)(y - qiy[k]);
                if (dx < (unsigned)win && dy < (unsigned)win)
                  v[(arow + 8 * k) * nwin + dy * win + dx] =
                      acc[i][j][2 * e + u] * scale;
              }
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
      }
      __syncthreads();                     // buffer step&1 is free for step+2
    }
    __syncthreads();                       // every window value is in v

    for (int e = tid; e < kTile * NN; e += kThreads) {
      const int qi = e / NN;
      const int t = e - qi * NN;
      const int st = s_state[qi];
      if (st == 0) continue;
      const int qy = qy0 + qi / kTileW;
      const int qx = qx0 + qi % kTileW;
      const int ox = t / n;                // x offset
      const int oy = t - ox * n;           // y offset
      const float* vq = v + qi * nwin;
      out[(q_base + (size_t)qy * W + qx) * (size_t)(L * NN) + (size_t)l * NN + t] =
          RAGGED && st == 1 ? 0.0f
                  : raft_corr::bilinear(vq[oy * win + ox], vq[oy * win + ox + 1],
                                        vq[(oy + 1) * win + ox],
                                        vq[(oy + 1) * win + ox + 1], s_fx[qi],
                                        s_fy[qi]);
    }
    return;
  }

  // the gather: one warp per query, its window values in a buffer of its own
  float* vq = reinterpret_cast<float*>(smem) + warp * nwin;
  for (int qi = warp; qi < kTile; qi += kWarps) {
    const int st = s_state[qi];
    if (st == 0) continue;                 // uniform over the warp
    const int qy = qy0 + qi / kTileW;
    const int qx = qx0 + qi % kTileW;
    const size_t q = q_base + (size_t)qy * W + qx;
    float* o = out + q * (size_t)(L * NN) + (size_t)l * NN;
    if (RAGGED && st == 1) {
      for (int t = lane; t < NN; t += 32) o[t] = 0.0f;
      continue;
    }
    if (st == 2) {
      gather_query<T, VEC, NV, G>(f1 + q * C, f2b, W2, Hc, Wc, C, s_ix0[qi],
                                  s_iy0[qi], win, scale, vq, lane);
    } else {
      for (int p = lane; p < nwin; p += 32) vq[p] = 0.0f;
    }
    __syncwarp();
    for (int t = lane; t < NN; t += 32) {
      const int ox = t / n;
      const int oy = t - ox * n;
      o[t] = raft_corr::bilinear(vq[oy * win + ox], vq[oy * win + ox + 1],
                                 vq[(oy + 1) * win + ox],
                                 vq[(oy + 1) * win + ox + 1], s_fx[qi], s_fy[qi]);
    }
    __syncwarp();                          // vq is free for the next query
  }
}

struct Args {                              // one launch's arguments
  const void* f1;
  const float* coords;
  float* out;
  Levels lv;
  const int* sizes8;
  int L, B, H, W, C, r;
  float scale, mma_ratio;
  int* stats;
};

template <typename T, bool VEC, int NV, bool RAGGED>
cudaError_t launch(const Args& a, int mma_ok, cudaStream_t stream) {
  const int nwin = (2 * a.r + 2) * (2 * a.r + 2);
  const int smem = mma_ok ? kStagingBytes + kTile * nwin * 4 : kWarps * nwin * 4;
  constexpr int kMaxSmem = kStagingBytes + kTile * kMmaMaxWin * kMmaMaxWin * 4;
  auto kernel = corr_lookup_kernel<T, VEC, NV, RAGGED>;
  // above 48 KB dynamic shared memory needs an opt-in, once per device (the
  // call is too slow for every launch)
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  const int tiles = ((a.H + kTileH - 1) / kTileH) * ((a.W + kTileW - 1) / kTileW);
  dim3 grid(tiles, a.L, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.f1), a.coords, a.out, a.lv, a.sizes8, a.L, a.H,
      a.W, a.C, a.r, a.scale, mma_ok, a.mma_ratio, a.stats);
  return cudaGetLastError();
}

template <typename T, bool RAGGED = false>
int run(const Args& a, void* stream) {
  constexpr int kN = raft_corr::Vec16<T>::kN;
  if (a.L < 1 || a.L > raft_corr::kMaxLevels || a.r < 0 ||
      2 * a.r + 2 > kMaxWin || a.C < 1 || a.C > 512 || a.B < 1 || a.H < 1 ||
      a.W < 1 || a.B > 65535 || (long long)a.H * a.W > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors of channels need C a multiple of the vector and
  // 16-byte aligned maps; the MMA path stages such vectors too
  bool vec = a.C % kN == 0 && reinterpret_cast<uintptr_t>(a.f1) % 16 == 0;
  for (int l = 0; l < a.L; ++l)
    vec = vec && reinterpret_cast<uintptr_t>(a.lv.f2[l]) % 16 == 0;
  const int mma_ok = vec && 2 * a.r + 2 <= kMmaMaxWin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // C not a multiple of the vector gathers by channel: any C <= 512
  if (!vec) return (int)launch<T, false, 4, RAGGED>(a, mma_ok, s);
  if (a.C <= 32 * kN) return (int)launch<T, true, 1, RAGGED>(a, mma_ok, s);
  if (a.C <= 64 * kN) return (int)launch<T, true, 2, RAGGED>(a, mma_ok, s);
  if constexpr (kN == 4)                   // float32, C <= 512
    return (int)launch<T, true, 4, RAGGED>(a, mma_ok, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry: f2_ptrs / level_hw are HOST arrays (num_levels device
// pointers and (h, w) pairs); f1 [B, H*W, C], coords [B, H*W, 2], all
// DEVICE.  A tile takes the MMA path when its window box holds at most
// mma_ratio times its queries' in-region window positions (0: never; the
// gather then takes every tile).  stats: null, or a DEVICE int array of
// 2 * num_levels that counts each level's tiles of each path (MMA,
// gather).  Returns a cudaError_t (0 on success); launches on `stream`,
// never syncs.
#define RAFT_ARGS(SIZES8)                                                     \
  Args{f1, coords, out, raft_corr::make_levels(f2_ptrs, level_hw, num_levels), \
       SIZES8, num_levels, B, H, W, C, radius, scale, mma_ratio, stats}
#define RAFT_LOOKUP_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* f1, const float* coords, float* out,        \
                      const void* const* f2_ptrs, const int* level_hw,        \
                      int num_levels, int B, int H, int W, int C, int radius, \
                      float scale, float mma_ratio, int* stats,               \
                      void* stream) {                                         \
    return run<T>(RAFT_ARGS(nullptr), stream);                                \
  }

RAFT_LOOKUP_ENTRY(corr_lookup_f32, float)
RAFT_LOOKUP_ENTRY(corr_lookup_bf16, __nv_bfloat16)
// the packed lookup: corr_lookup_*'s kernel as it is (the narrow levels
// above), an entry of its own so that its launches are its own
RAFT_LOOKUP_ENTRY(corr_packed_f32, float)
RAFT_LOOKUP_ENTRY(corr_packed_bf16, __nv_bfloat16)
// the window-scheduled lookup: corr_lookup_*'s kernel as it is, since each
// tile's box is the GPU form of the row blocks _window_schedule names; an
// entry of its own so that its launches are its own
RAFT_LOOKUP_ENTRY(corr_window_f32, float)
RAFT_LOOKUP_ENTRY(corr_window_bf16, __nv_bfloat16)

// sizes8: DEVICE array [B, 2] int32, each item's live (h, w) on the query
// grid; f1 and the f2 levels are expected masked outside it.
extern "C" int corr_ragged_f32(const void* f1, const float* coords,
                               float* out, const void* const* f2_ptrs,
                               const int* level_hw, const int* sizes8,
                               int num_levels, int B, int H, int W, int C,
                               int radius, float scale, float mma_ratio,
                               int* stats, void* stream) {
  if (sizes8 == nullptr) return (int)cudaErrorInvalidValue;
  return run<float, true>(RAFT_ARGS(sizes8), stream);
}

extern "C" int corr_ragged_bf16(const void* f1, const float* coords,
                                float* out, const void* const* f2_ptrs,
                                const int* level_hw, const int* sizes8,
                                int num_levels, int B, int H, int W, int C,
                                int radius, float scale, float mma_ratio,
                                int* stats, void* stream) {
  if (sizes8 == nullptr) return (int)cudaErrorInvalidValue;
  return run<__nv_bfloat16, true>(RAFT_ARGS(sizes8), stream);
}

#undef RAFT_LOOKUP_ENTRY
#undef RAFT_ARGS

// The launch envelope an entry gives a configuration (element type, ragged
// or not, channels C, radius), from the expressions run() and launch()
// use, with 16-byte aligned maps: out[0] dynamic shared bytes, out[1]
// threads per block, out[2] the blocks per SM __launch_bounds__ asks for,
// out[3] the largest dynamic shared bytes any configuration opts in to,
// out[4] VEC, out[5] NV, out[6] the MMA path.  With attrs != 0 it also
// reads the instantiation it would launch: out[7] cudaFuncGetAttributes'
// numRegs, out[8] its static shared bytes, out[9] maxThreadsPerBlock,
// out[10] local (spill) bytes per thread, out[11] the blocks per SM
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives at out[0] bytes
// (after the opt-in launch() makes).  Returns a cudaError_t.
namespace {

template <typename T, bool RAGGED>
int envelope(int C, int radius, int attrs, int* out) {
  constexpr int kN = raft_corr::Vec16<T>::kN;
  if (C < 1 || C > 512 || radius < 0 || 2 * radius + 2 > kMaxWin)
    return (int)cudaErrorInvalidValue;
  const bool vec = C % kN == 0;
  const int nv = !vec ? 4 : C <= 32 * kN ? 1 : C <= 64 * kN ? 2 : 4;
  if (vec && nv == 4 && kN != 4) return (int)cudaErrorInvalidValue;
  const int mma_ok = vec && 2 * radius + 2 <= kMmaMaxWin;
  const int nwin = (2 * radius + 2) * (2 * radius + 2);
  out[0] = mma_ok ? kStagingBytes + kTile * nwin * 4 : kWarps * nwin * 4;
  out[1] = kThreads;
  out[2] = 2;
  out[3] = kStagingBytes + kTile * kMmaMaxWin * kMmaMaxWin * 4;
  out[4] = vec;
  out[5] = nv;
  out[6] = mma_ok;
  if (!attrs) return 0;
  const void* k = nullptr;
  if (!vec) k = (const void*)corr_lookup_kernel<T, false, 4, RAGGED>;
  else if (nv == 1) k = (const void*)corr_lookup_kernel<T, true, 1, RAGGED>;
  else if (nv == 2) k = (const void*)corr_lookup_kernel<T, true, 2, RAGGED>;
  if constexpr (kN == 4)
    if (vec && nv == 4) k = (const void*)corr_lookup_kernel<T, true, 4, RAGGED>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, out[3]);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  out[7] = fa.numRegs;
  out[8] = (int)fa.sharedSizeBytes;
  out[9] = fa.maxThreadsPerBlock;
  out[10] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[11], k, kThreads, out[0]);
}

}  // namespace

extern "C" int corr_lookup_envelope(int bf16, int ragged, int C, int radius,
                                    int attrs, int* out) {
  if (bf16)
    return ragged ? envelope<__nv_bfloat16, true>(C, radius, attrs, out)
                  : envelope<__nv_bfloat16, false>(C, radius, attrs, out);
  return ragged ? envelope<float, true>(C, radius, attrs, out)
                : envelope<float, false>(C, radius, attrs, out);
}
