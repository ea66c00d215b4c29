// One SepConvGRU iteration of RAFT, FP32, for Hopper (sm_90a).
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
// Design: the TPU kernel kept a row block and its 4-row halo in VMEM and
// ran each tap as a matmul on the matrix unit.  Here each conv is an
// implicit GEMM: M = pixels, N = output channels, K = 5 taps x input
// channels, where the A operand is read straight from the shifted NHWC
// activations (out-of-image taps read as zeros) and the B operand is the
// tap-major weight [5, Cin, N].  Tiles of 64 pixels x 64 channels x 16 of K
// are staged in shared memory; each of 256 threads accumulates a 4x4
// micro-tile in registers, in FP32 FMA (no TF32, no tensor cores).  The
// gate nonlinearities and the blend are the GEMM's epilogue.  Two launches
// per pass, four per iteration:
//   A: zr = conv([h, motion], wzr) + ctx_zr  -> writes z and r*h
//   B: q = tanh(conv(r*h, wqh) + conv(motion, wqm) + ctx_q) -> blend
// Bound: about 1.97 MFLOP per pixel per iteration, so operations, not
// bytes, set the least time on this card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // pixels per block tile
constexpr int BN = 64;    // output channels per block tile
constexpr int BK = 16;    // reduction slice (input channels of one tap)
constexpr int kThreads = 256;
constexpr int kTaps = 5;

struct GemmArgs {
  const float* src0; int c0; const float* w0; int ts0;  // w: [5][c][N], tap stride ts
  const float* src1; int c1; const float* w1; int ts1;
  int n;                       // output channels of the GEMM
  int b, h, w;                 // image geometry; M = b*h*w
  const float* ctx;            // [M, 3*hid]: (z | r | q) context terms
  const float* hcur;           // [M, hid]: h of this pass
  const float* zin;            // [M, hid]: z (mode B)
  float* out0;                 // mode A: z; mode B: new h
  float* out1;                 // mode A: r*h
  int hid;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// MODE 0 = launch A (z/r gates), MODE 1 = launch B (q gate + blend).
template <int MODE, bool VERT>
__global__ void __launch_bounds__(kThreads) gru_gemm(GemmArgs g) {
  __shared__ float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int M = g.b * g.h * g.w;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A-tile loader: one float4 (4 channels) of one pixel per thread
  const int a_m = tid >> 2;            // 0..63
  const int a_k4 = tid & 3;            // 0..3
  const int am = m0 + a_m;
  int ab = 0, ay = 0, ax = 0;
  if (am < M) {
    ab = am / (g.h * g.w);
    const int rem = am - ab * g.h * g.w;
    ay = rem / g.w;
    ax = rem - ay * g.w;
  }
  // B-tile loader: one float4 of one weight row per thread
  const int b_k = tid >> 4;            // 0..15
  const int b_n4 = tid & 15;           // 0..15

  // compute layout: 16 x 16 threads, each m = ty + 16i, n = tx + 16j
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int d = 0; d < kTaps; ++d) {
    const int sy = VERT ? ay + d - 2 : ay;
    const int sx = VERT ? ax : ax + d - 2;
    const bool valid = am < M && sy >= 0 && sy < g.h && sx >= 0 && sx < g.w;
    const size_t pix = ((size_t)ab * g.h + (valid ? sy : 0)) * g.w + (valid ? sx : 0);
    for (int s = 0; s < 2; ++s) {
      const float* src = s ? g.src1 : g.src0;
      const int C = s ? g.c1 : g.c0;
      const float* w = (s ? g.w1 : g.w0) + (size_t)d * (s ? g.ts1 : g.ts0);
      for (int c0 = 0; c0 < C; c0 += BK) {
        float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
        if (valid)
          av = *reinterpret_cast<const float4*>(src + pix * C + c0 + 4 * a_k4);
        As[4 * a_k4 + 0][a_m] = av.x;
        As[4 * a_k4 + 1][a_m] = av.y;
        As[4 * a_k4 + 2][a_m] = av.z;
        As[4 * a_k4 + 3][a_m] = av.w;
        const float4 bv = *reinterpret_cast<const float4*>(
            w + (size_t)(c0 + b_k) * g.n + n0 + 4 * b_n4);
        *reinterpret_cast<float4*>(&Bs[b_k][4 * b_n4]) = bv;
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
          float a[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = Bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  const int hid = g.hid;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (MODE == 0) {
        const float gate = sigmoidf(acc[i][j] + g.ctx[(size_t)m * 3 * hid + n]);
        if (n < hid) {
          g.out0[(size_t)m * hid + n] = gate;                        // z
        } else {
          const size_t o = (size_t)m * hid + (n - hid);
          g.out1[o] = gate * g.hcur[o];                              // r*h
        }
      } else {
        const size_t o = (size_t)m * hid + n;
        const float q = tanhf(acc[i][j] + g.ctx[(size_t)m * 3 * hid + 2 * hid + n]);
        const float z = g.zin[o];
        g.out0[o] = (1.0f - z) * g.hcur[o] + z * q;
      }
    }
  }
}

template <int MODE, bool VERT>
cudaError_t launch(const GemmArgs& g, cudaStream_t stream) {
  const int M = g.b * g.h * g.w;
  dim3 grid((M + BM - 1) / BM, g.n / BN);
  gru_gemm<MODE, VERT><<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// All tensors are float32, contiguous NHWC, 16-byte aligned.
//   h, motion [B,H,W,hid|mot]; ctx1, ctx2 [B,H,W,3*hid] (z|r|q, biases in);
//   wzr{s} [5, hid+mot, 2*hid]; wqh{s} [5, hid, hid]; wqm{s} [5, mot, hid];
//   z, rh, h1 scratch [B,H,W,hid]; out [B,H,W,hid].
// Needs hid % 64 == 0 and mot % 16 == 0.  Four launches on `stream`; the
// first failing launch's cudaError_t is returned (0 on success).
extern "C" int sep_conv_gru_f32(const float* h, const float* motion,
                                const float* ctx1, const float* ctx2,
                                const float* wzr1, const float* wqh1,
                                const float* wqm1, const float* wzr2,
                                const float* wqh2, const float* wqm2,
                                float* z, float* rh, float* h1, float* out,
                                int B, int H, int W, int hid, int mot,
                                void* stream) {
  if (B < 1 || H < 1 || W < 1 || hid < BN || hid % BN || mot < BK || mot % BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hm = hid + mot;
  const float* wzr[2] = {wzr1, wzr2};
  const float* wqh[2] = {wqh1, wqh2};
  const float* wqm[2] = {wqm1, wqm2};
  const float* ctx[2] = {ctx1, ctx2};
  const float* hin[2] = {h, h1};
  float* hout[2] = {h1, out};
  for (int p = 0; p < 2; ++p) {
    GemmArgs a{hin[p], hid, wzr[p], hm * 2 * hid,
               motion, mot, wzr[p] + (size_t)hid * 2 * hid, hm * 2 * hid,
               2 * hid, B, H, W, ctx[p], hin[p], nullptr, z, rh, hid};
    cudaError_t err = p ? launch<0, true>(a, s) : launch<0, false>(a, s);
    if (err != cudaSuccess) return (int)err;
    GemmArgs q{rh, hid, wqh[p], hid * hid,
               motion, mot, wqm[p], mot * hid,
               hid, B, H, W, ctx[p], hin[p], z, hout[p], nullptr, hid};
    err = p ? launch<1, true>(q, s) : launch<1, false>(q, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
