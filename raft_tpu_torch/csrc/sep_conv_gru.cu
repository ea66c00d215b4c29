// One SepConvGRU iteration of RAFT on Hopper's tensor cores (sm_90a).
//
// Replaces raft_tpu/ops/gru_pallas.py::_pallas_gru (_gru_kernel), reached
// through sep_conv_gru_pallas.  Same values: the 1x5 pass, then the 5x1
// pass; each pass computes
//   z, r = sigmoid(conv([h, motion], wzr) + ctx_zr)
//   q    = tanh(conv(r*h, wqh) + conv(motion, wqm) + ctx_q)
//   h    = (1 - z) * h + z * q
// with zero padding at the image edges (r*h is padded with zeros too) and
// the context terms pre-hoisted with the gate biases folded in.
//
// What bounds it: about 1.97 MFLOP of products per pixel per iteration
// against about 5 KB of I/O, so the tensor cores' rate at the products'
// accuracy: 3xTF32 (165 TFLOP/s) for the float32 entry; for the bfloat16
// entry one BF16 MMA (989) for a bfloat16 activation and three (330) for a
// float32 one.
//
// Design.  Each gate conv is an implicit GEMM, M = pixels, N = output
// channels, K = 5 taps x input channels, on mma.sync (m16n8k8 TF32 for the
// float32 entry, m16n8k16 BF16 for the bfloat16 entry; tensor_core.cuh has
// the exact splits).  Pixels are taken in the pass's order (row-major for
// the 1x5 pass, column-major for the 5x1 pass), so a tap is a shift of 2..-2
// rows of the A tile along either axis: a CTA stages its BM pixels plus a
// 2-pixel halo each side once per slab of channels and runs all 5 taps from
// it, masking in registers the taps that cross a row (or column) end.  The
// weights are prepared once per forward (ops/gru_cuda.py::
// prepare_gru_weights): tf32 hi and lo, or bfloat16, laid out per slab in
// the order the MMA fragments read them, so one 16-byte (8-byte) shared
// load gives a thread its B fragment; the channels of a slab are permuted
// inside the k-step the same way for A and B so an A fragment is one 8-byte
// load.  A slab's A rows and B columns go through a ring of three cp.async
// stages (out-of-map rows zero-filled by a 0-byte source), the copies of
// slab s+2 in flight while slab s is multiplied.  A float32 activation is
// split to tf32 hi/lo in registers as its fragment is loaded (the float32
// entry); the bfloat16 entry splits a float32 one (r*h, h1) into its three
// pieces once per slab, into planes in shared memory, since each value
// serves 5 taps and that split is long (measured: a once-per-slab tf32
// split was slower, its pass and barrier costing more than it saved).  Each slab's
// products are summed in a fresh accumulator and added to an FP32 register
// sum (the tensor cores' accumulation does not round to nearest).  CTA
// tiles: 128 pixels x 64 channels for the z/r GEMM (N = 2*hidden), 64 x 64
// for the q GEMM (N = hidden), so at 54x128 both GEMMs launch 216 CTAs, two
// per SM.  The gate nonlinearities and the blend are the GEMMs' epilogues.
// Four launches per iteration:
//   A: zr = conv([h, motion], wzr) + ctx_zr  -> writes z and r*h
//   B: q = tanh(conv(r*h, wqh) + conv(motion, wqm) + ctx_q) -> blend
// I/O: h, motion and the context terms in, and the new h out, are float32
// (sep_conv_gru_f32) or bfloat16 (sep_conv_gru_bf16, compute_dtype=
// 'bfloat16'); the accumulation and the scratch (z, r*h and the h1 between
// the two passes) stay float32, so only the final h is rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using raft_tc::cp16;
using raft_tc::cp_commit;
using raft_tc::cp_wait;

constexpr int kTaps = 5;
constexpr int kHalo = 4;          // 2 pixels either side along the pass axis
constexpr int BN = 64;            // output channels per CTA tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;

// How a GEMM source's activations meet the tensor cores.
enum Kind {
  kTF32 = 0,     // float32 entry: 3xTF32 on m16n8k8
  kBF16 = 1,     // bfloat16 activation, bfloat16 entry: one m16n8k16 MMA
  kBF16x3 = 2,   // float32 activation (r*h, h1), bfloat16 entry: 3 pieces
};

// Per entry: channels per slab (one MMA k-step per tap) and weight words
// per (output channel, thread of a quad): TF32 hi(2t), hi(2t+1), lo(2t),
// lo(2t+1); BF16 the pairs (4t, 4t+1) and (4t+2, 4t+3).
template <bool TF32>
struct Entry {
  static constexpr int kChannels = TF32 ? 8 : 16;
  static constexpr int kWB = TF32 ? 4 : 2;
};
// 32-bit words of a staged A row (one pixel's channels of a slab)
template <int K>
struct ARow {
  static constexpr int kWords = K == kBF16x3 ? 16 : 8;
};

struct Src {
  const void* x;            // activations [pixels, c], NHWC
  const uint32_t* w;        // prepared weights of this source, tap 0 slab 0
  int c;                    // channels
  int tap_stride;           // words from one tap's weights to the next
};

struct GemmArgs {
  Src s[2];                 // (h | r*h, motion)
  int n;                    // output channels of the GEMM
  int b, h, w;              // image geometry; M = b*h*w
  const void* ctx;          // [M, 3*hid]: (z | r | q) context terms
  const void* hcur;         // [M, hid]: h of this pass
  const float* zin;         // [M, hid]: z (mode 1)
  void* out0;               // mode 0: z (float); mode 1: new h
  float* out1;              // mode 0: r*h
  int hid;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);         // round to nearest even, as torch
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The three bfloat16 pieces of a float32 activation (kBF16x3) are split
// once per slab into planes in shared memory (a row's value serves 5 taps,
// and the split is many instructions); the tf32 split of kTF32 (four
// integer operations and a subtraction) is cheaper done in registers per
// tap than the pass and barrier it would need.
template <int K>
struct Pieces {
  static constexpr int kN = K == kBF16x3 ? 3 : 1;
};

// Split the staged float32 A tile (R rows of 16 channels) into bfloat16
// piece planes (hi, mid, lo): plane p holds row r's 8 words at
// P + (p*R + r)*8, words 2t and 2t+1 being the MMA fragment's k-pairs t and
// t+4 (channels 4t..4t+1 and 4t+2..4t+3).
template <int R>
__device__ __forceinline__ void split_slab(const uint32_t* As, uint32_t* P,
                                           int tid) {
  for (int e = tid; e < R * 4; e += kThreads) {
    const int row = e >> 2;
    const int t = e & 3;
    uint32_t* dst = P + row * 8 + 2 * t;
    const float4 x = *reinterpret_cast<const float4*>(As + row * 16 + 4 * t);
    float h[4], m[4], l[4];
    raft_tc::split_bf16x3(x.x, h[0], m[0], l[0]);
    raft_tc::split_bf16x3(x.y, h[1], m[1], l[1]);
    raft_tc::split_bf16x3(x.z, h[2], m[2], l[2]);
    raft_tc::split_bf16x3(x.w, h[3], m[3], l[3]);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(raft_tc::pack_bf16(h[0], h[1]), raft_tc::pack_bf16(h[2], h[3]));
    *reinterpret_cast<uint2*>(dst + R * 8) =
        make_uint2(raft_tc::pack_bf16(m[0], m[1]), raft_tc::pack_bf16(m[2], m[3]));
    *reinterpret_cast<uint2*>(dst + 2 * R * 8) =
        make_uint2(raft_tc::pack_bf16(l[0], l[1]), raft_tc::pack_bf16(l[2], l[3]));
  }
}

// The products of one slab, all 5 taps, into part.  A: R rows of 8 words,
// the staged tile (kTF32: float32, kBF16: bfloat16) or the piece planes
// (kBF16x3); arow: the thread's first A row in the tile (its rows are
// arow + 16i + 8e), bcol its first B column (bcol + 8j); vmask bit
// (2i+e)*5+d: tap d of that row lies inside its row (column) of the image.
template <int K, int NT, int R>
__device__ __forceinline__ void slab_mma(const uint32_t* A, const uint32_t* Bs,
                                         int arow, int bcol, int tq,
                                         unsigned vmask,
                                         float (&part)[2][NT][4]) {
  constexpr int NP = Pieces<K>::kN;
  constexpr int WB = K == kTF32 ? 4 : 2;
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
    // A row r + d holds the source pixel of tap d for output row r
    // a[0] = hi (kTF32: a[1] = lo), or the pieces hi, mid, lo
    uint32_t a[K == kTF32 ? 2 : NP][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = arow + 16 * i + 8 * e + d;
        const bool ok = (vmask >> ((2 * i + e) * kTaps + d)) & 1u;
#pragma unroll
        for (int pc = 0; pc < NP; ++pc) {
          uint2 u = make_uint2(0u, 0u);
          if (ok) u = *reinterpret_cast<const uint2*>(A + (pc * R + r) * 8 + 2 * tq);
          if constexpr (K == kTF32) {      // channels 2t (k = t), 2t+1 (k = t+4)
            raft_tc::split_tf32(__uint_as_float(u.x), a[0][i][e], a[1][i][e]);
            raft_tc::split_tf32(__uint_as_float(u.y), a[0][i][2 + e], a[1][i][2 + e]);
          } else {
            a[pc][i][e] = u.x;             // k = t
            a[pc][i][2 + e] = u.y;         // k = t + 4
          }
        }
      }
    // the products of a k-step, small ones first; each pass runs over all
    // 2*NT accumulators so no MMA waits on the one before it
    if constexpr (K == kTF32) {
      uint4 b[NT];                         // hi(k=t), hi(t+4), lo(t), lo(t+4)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        b[j] = *reinterpret_cast<const uint4*>(
            Bs + d * BN * 4 * WB + ((bcol + 8 * j) * 4 + tq) * WB);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) raft_tc::mma_tf32(part[i][j], a[1][i], b[j].x, b[j].y);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) raft_tc::mma_tf32(part[i][j], a[0][i], b[j].z, b[j].w);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) raft_tc::mma_tf32(part[i][j], a[0][i], b[j].x, b[j].y);
    } else {
      uint2 b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        b[j] = *reinterpret_cast<const uint2*>(
            Bs + d * BN * 4 * WB + ((bcol + 8 * j) * 4 + tq) * WB);
#pragma unroll
      for (int pc = NP - 1; pc >= 0; --pc)   // (lo, mid,) hi
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            raft_tc::mma_bf16(part[i][j], a[pc][i], b[j].x, b[j].y);
    }
  }
}

// MODE 0 = launch A (z/r gates), MODE 1 = launch B (q gate + blend).
// TIO: the I/O type; PASS2: the 5x1 pass, whose h is the float32 h1 and
// whose output is the I/O type (pass 1 writes h1, float32); TF32: the
// float32 entry; BM: pixels per CTA tile.
template <int MODE, bool VERT, typename TIO, bool PASS2, bool TF32, int BM>
struct Gemm {
  using TS0 = typename std::conditional<MODE == 1 || PASS2, float, TIO>::type;
  using TH = typename std::conditional<PASS2, float, TIO>::type;
  using TO = typename std::conditional<PASS2, TIO, float>::type;
  static constexpr int K0 =
      TF32 ? kTF32 : (std::is_same<TS0, float>::value ? kBF16x3 : kBF16);
  static constexpr int K1 = TF32 ? kTF32 : kBF16;
  static constexpr int WM = BM / 32;             // warps along M
  static constexpr int WN = kWarps / WM;         // and along N
  static constexpr int NT = BN / (8 * WN);       // n8 tiles per warp
  static constexpr int CS = Entry<TF32>::kChannels;
  static constexpr int WB = Entry<TF32>::kWB;
  static constexpr int AW = ARow<K0>::kWords > ARow<K1>::kWords
                                ? ARow<K0>::kWords : ARow<K1>::kWords;
  static constexpr int kAWords = (BM + kHalo) * AW;
  static constexpr int kBWords = kTaps * BN * 4 * WB;
  static constexpr int kStageWords = kAWords + kBWords;
  static constexpr int kRows = BM + kHalo;
  // the piece planes of a float32 source, after the stages
  static constexpr int kPlanes =
      Pieces<K0>::kN > 1 ? Pieces<K0>::kN : (Pieces<K1>::kN > 1 ? Pieces<K1>::kN : 0);
  static constexpr int kSmemBytes = (kStages * kStageWords + kPlanes * kRows * 8) * 4;
};

template <int MODE, bool VERT, typename TIO, bool PASS2, bool TF32, int BM>
__global__ void __launch_bounds__(kThreads, 2)
gru_gemm(const __grid_constant__ GemmArgs g) {
  using G = Gemm<MODE, VERT, TIO, PASS2, TF32, BM>;
  using TS0 = typename G::TS0;
  using TH = typename G::TH;
  using TO = typename G::TO;
  constexpr int NT = G::NT;
  constexpr int CS = G::CS;
  constexpr int WB = G::WB;
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;                // MMA group and thread in group
  const int tq = lane & 3;
  const int wm = warp / G::WN;
  const int wn = warp % G::WN;
  const int M = g.b * g.h * g.w;
  const int len = VERT ? g.h : g.w;        // pixels along the pass axis
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ns0 = g.s[0].c / CS;
  const int nslabs = ns0 + g.s[1].c / CS;

  // pass order -> NHWC pixel index (the 5x1 pass runs down the columns)
  auto pixel = [&](int m) -> size_t {
    if (!VERT) return (size_t)m;
    const int y = m % g.h;
    const int t = m / g.h;
    return ((size_t)(t / g.w) * g.h + y) * g.w + (t % g.w);
  };

  const int arow = wm * 32 + gq;
  const int bcol = wn * NT * 8 + gq;
  unsigned vmask = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + arow + 16 * i + 8 * e;
      if (m >= M) continue;
      const int pos = m % len;
#pragma unroll
      for (int d = 0; d < kTaps; ++d)
        if (pos + d - 2 >= 0 && pos + d - 2 < len)
          vmask |= 1u << ((2 * i + e) * kTaps + d);
    }

  // stage slab `slab` (source 0's slabs, then source 1's) into its buffer
  auto stage = [&](int slab) {
    uint32_t* As = smem + (slab % kStages) * G::kStageWords;
    uint32_t* Bs = As + G::kAWords;
    const bool s1 = slab >= ns0;
    const int sl = s1 ? slab - ns0 : slab;
    const char* x = static_cast<const char*>(s1 ? g.s[1].x : g.s[0].x);
    const int c = s1 ? g.s[1].c : g.s[0].c;
    const int esz = s1 ? (int)sizeof(TIO) : (int)sizeof(TS0);
    const int aw = s1 ? ARow<G::K1>::kWords : ARow<G::K0>::kWords;
    const int cpr = aw / 4;                // 16-byte chunks per row
    for (int e = tid; e < (BM + kHalo) * cpr; e += kThreads) {
      const int row = e / cpr;
      const int ch = e - row * cpr;
      const int m = m0 - 2 + row;
      const bool ok = m >= 0 && m < M;
      const char* src = x;
      if (ok) src = x + (pixel(m) * c + (size_t)sl * CS) * esz + ch * 16;
      cp16(As + row * aw + ch * 4, src, ok ? 16 : 0);
    }
    const uint32_t* w = (s1 ? g.s[1].w : g.s[0].w)
                        + ((size_t)sl * g.n + n0) * 4 * WB;
    const int tap_stride = s1 ? g.s[1].tap_stride : g.s[0].tap_stride;
    constexpr int kChunks = BN * WB;       // 16-byte chunks per tap
    for (int e = tid; e < kTaps * kChunks; e += kThreads) {
      const int d = e / kChunks;
      const int off = e - d * kChunks;
      cp16(Bs + d * BN * 4 * WB + off * 4, w + (size_t)d * tap_stride + off * 4, 16);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslabs) stage(s);
    cp_commit();
  }
  for (int s = 0; s < nslabs; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();                       // slab s landed; slab s-1's buffer free
    if (s + kStages - 1 < nslabs) stage(s + kStages - 1);
    cp_commit();
    const uint32_t* As = smem + (s % kStages) * G::kStageWords;
    const uint32_t* Bs = As + G::kAWords;
    uint32_t* P = smem + kStages * G::kStageWords;
    float part[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[i][j][k] = 0.0f;
    // a float32 source of the bfloat16 entry is split into its pieces once
    // per slab (the planes are free: every warp is past this iteration's
    // first barrier)
    if (G::K0 == G::K1 || s < ns0) {
      if constexpr (Pieces<G::K0>::kN > 1) {
        split_slab<G::kRows>(As, P, tid);
        __syncthreads();
        slab_mma<G::K0, NT, G::kRows>(P, Bs, arow, bcol, tq, vmask, part);
      } else {
        slab_mma<G::K0, NT, G::kRows>(As, Bs, arow, bcol, tq, vmask, part);
      }
    } else {
      if constexpr (Pieces<G::K1>::kN > 1) {
        split_slab<G::kRows>(As, P, tid);
        __syncthreads();
        slab_mma<G::K1, NT, G::kRows>(P, Bs, arow, bcol, tq, vmask, part);
      } else {
        slab_mma<G::K1, NT, G::kRows>(As, Bs, arow, bcol, tq, vmask, part);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] += part[i][j][k];
  }

  // epilogue: accumulator (i, j, 2e + u) is output row arow + 16i + 8e,
  // column n0 + bcol - gq + 8j + 2tq + u
  const int hid = g.hid;
  const TIO* ctx = static_cast<const TIO*>(g.ctx);
  const TH* hcur = static_cast<const TH*>(g.hcur);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + arow + 16 * i + 8 * e;
      if (m >= M) continue;
      const size_t p = pixel(m);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = n0 + wn * NT * 8 + 8 * j + 2 * tq + u;
          const float v = acc[i][j][2 * e + u];
          if (MODE == 0) {
            const float gate = sigmoidf(v + ld(ctx + p * 3 * hid + n));
            if (n < hid) {
              static_cast<float*>(g.out0)[p * hid + n] = gate;          // z
            } else {
              const size_t o = p * hid + (n - hid);
              g.out1[o] = gate * ld(hcur + o);                          // r*h
            }
          } else {
            const size_t o = p * hid + n;
            const float q = tanhf(v + ld(ctx + p * 3 * hid + 2 * hid + n));
            const float z = g.zin[o];
            st(static_cast<TO*>(g.out0) + o, (1.0f - z) * ld(hcur + o) + z * q);
          }
        }
    }
}

template <int MODE, bool VERT, typename TIO, bool PASS2, bool TF32, int BM>
cudaError_t launch(const GemmArgs& g, cudaStream_t stream) {
  constexpr int smem = Gemm<MODE, VERT, TIO, PASS2, TF32, BM>::kSmemBytes;
  auto kernel = gru_gemm<MODE, VERT, TIO, PASS2, TF32, BM>;
  // above 48 KB dynamic shared memory needs an opt-in, once per device (the
  // call is too slow for every launch)
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices || !opted_in[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < kMaxDevices) opted_in[device] = true;
  }
  const int M = g.b * g.h * g.w;
  dim3 grid((M + BM - 1) / BM, g.n / BN);
  kernel<<<grid, kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <typename TIO, bool TF32>
int run(const void* h, const void* motion, const void* ctx1, const void* ctx2,
        const void* wzr1, const void* wqh1, const void* wqm1,
        const void* wzr2, const void* wqh2, const void* wqm2, float* z,
        float* rh, float* h1, void* out, int B, int H, int W, int hid,
        int mot, void* stream) {
  constexpr int CS = Entry<TF32>::kChannels;
  constexpr int WB = Entry<TF32>::kWB;
  if (B < 1 || H < 1 || W < 1 || hid < BN || hid % BN || mot < 16 || mot % 16 ||
      (long long)B * H * W > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* wzr[2] = {static_cast<const uint32_t*>(wzr1),
                            static_cast<const uint32_t*>(wzr2)};
  const uint32_t* wqh[2] = {static_cast<const uint32_t*>(wqh1),
                            static_cast<const uint32_t*>(wqh2)};
  const uint32_t* wqm[2] = {static_cast<const uint32_t*>(wqm1),
                            static_cast<const uint32_t*>(wqm2)};
  const void* ctx[2] = {ctx1, ctx2};
  const void* hin[2] = {h, h1};
  void* hout[2] = {h1, out};
  const int zr_slab = 2 * hid * 4 * WB;    // weight words per slab
  const int q_slab = hid * 4 * WB;
  for (int p = 0; p < 2; ++p) {
    const int zr_tap = (hid + mot) / CS * zr_slab;
    GemmArgs a{{{hin[p], wzr[p], hid, zr_tap},
                {motion, wzr[p] + (size_t)(hid / CS) * zr_slab, mot, zr_tap}},
               2 * hid, B, H, W, ctx[p], hin[p], nullptr, z, rh, hid};
    cudaError_t err = p ? launch<0, true, TIO, true, TF32, 128>(a, s)
                        : launch<0, false, TIO, false, TF32, 128>(a, s);
    if (err != cudaSuccess) return (int)err;
    GemmArgs q{{{rh, wqh[p], hid, hid / CS * q_slab},
                {motion, wqm[p], mot, mot / CS * q_slab}},
               hid, B, H, W, ctx[p], hin[p], z, hout[p], nullptr, hid};
    err = p ? launch<1, true, TIO, true, TF32, 64>(q, s)
            : launch<1, false, TIO, false, TF32, 64>(q, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Contiguous NHWC, 16-byte aligned; h, motion, ctx1, ctx2 and out of the
// entry's I/O type, the scratch float32, the weights as
// ops/gru_cuda.py::prepare_gru_weights lays them out for the entry:
//   h, motion [B,H,W,hid|mot]; ctx1, ctx2 [B,H,W,3*hid] (z|r|q, biases in);
//   wzr{s} from [5, hid+mot, 2*hid]; wqh{s} from [5, hid, hid]; wqm{s} from
//   [5, mot, hid]; z, rh, h1 scratch [B,H,W,hid]; out [B,H,W,hid].
// Needs hid % 64 == 0 and mot % 16 == 0.  Four launches on `stream`; the
// first failing launch's cudaError_t is returned (0 on success).
extern "C" int sep_conv_gru_f32(const void* h, const void* motion,
                                const void* ctx1, const void* ctx2,
                                const void* wzr1, const void* wqh1,
                                const void* wqm1, const void* wzr2,
                                const void* wqh2, const void* wqm2,
                                float* z, float* rh, float* h1, void* out,
                                int B, int H, int W, int hid, int mot,
                                void* stream) {
  return run<float, true>(h, motion, ctx1, ctx2, wzr1, wqh1, wqm1, wzr2, wqh2,
                          wqm2, z, rh, h1, out, B, H, W, hid, mot, stream);
}

extern "C" int sep_conv_gru_bf16(const void* h, const void* motion,
                                 const void* ctx1, const void* ctx2,
                                 const void* wzr1, const void* wqh1,
                                 const void* wqm1, const void* wzr2,
                                 const void* wqh2, const void* wqm2,
                                 float* z, float* rh, float* h1, void* out,
                                 int B, int H, int W, int hid, int mot,
                                 void* stream) {
  return run<__nv_bfloat16, false>(h, motion, ctx1, ctx2, wzr1, wqh1, wqm1,
                                   wzr2, wqh2, wqm2, z, rh, h1, out, B, H, W,
                                   hid, mot, stream);
}

// The launch envelope of the entry's launch `which` (0-3, in the order
// run() issues them: the 1x5 pass's z/r and q GEMMs, then the 5x1 pass's),
// from the template launch() instantiates: out[0] dynamic shared bytes
// (Gemm<...>::kSmemBytes), out[1] threads per block, out[2] the blocks per
// SM __launch_bounds__ asks for, out[3] BM (pixels per tile), out[4] BN
// (output channels per tile).  With attrs != 0, as corr_lookup_envelope:
// out[7] numRegs, out[8] static shared bytes, out[9] maxThreadsPerBlock,
// out[10] local bytes per thread, out[11] the occupancy's blocks per SM at
// out[0] bytes.  Returns a cudaError_t.
namespace {

template <int MODE, bool VERT, typename TIO, bool PASS2, bool TF32, int BM>
int gru_envelope(int attrs, int* out) {
  constexpr int smem = Gemm<MODE, VERT, TIO, PASS2, TF32, BM>::kSmemBytes;
  out[0] = smem;
  out[1] = kThreads;
  out[2] = 2;
  out[3] = BM;
  out[4] = BN;
  if (!attrs) return 0;
  const void* k = (const void*)gru_gemm<MODE, VERT, TIO, PASS2, TF32, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  out[7] = fa.numRegs;
  out[8] = (int)fa.sharedSizeBytes;
  out[9] = fa.maxThreadsPerBlock;
  out[10] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[11], k, kThreads, smem);
}

template <typename TIO, bool TF32>
int gru_envelopes(int which, int attrs, int* out) {
  switch (which) {
    case 0: return gru_envelope<0, false, TIO, false, TF32, 128>(attrs, out);
    case 1: return gru_envelope<1, false, TIO, false, TF32, 64>(attrs, out);
    case 2: return gru_envelope<0, true, TIO, true, TF32, 128>(attrs, out);
    case 3: return gru_envelope<1, true, TIO, true, TF32, 64>(attrs, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int sep_conv_gru_envelope(int bf16, int which, int attrs,
                                     int* out) {
  return bf16 ? gru_envelopes<__nv_bfloat16, false>(which, attrs, out)
              : gru_envelopes<float, true>(which, attrs, out);
}
