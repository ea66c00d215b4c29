// Host-only DIS optical flow of raft_tpu_torch (Kroeger et al., "Fast
// Optical Flow using Dense Inverse Search", ECCV 2016), as OpenCV's
// DISOpticalFlow computes it at PRESET_MEDIUM, with no OpenCV.  Built with
// the host C++ compiler by raft_tpu_torch/_build.py (-O2, no floating-point
// contraction) and bound with ctypes in raft_tpu_torch/utils/frame_utils.py.
//
// Coarse to fine over image pyramids, each scale runs:
//   * patch inverse search: 8x8 patches at a stride, an inverse-compositional
//     Gauss-Newton descent on the mean-normalised SSD, with spatial
//     propagation in a forward and then a backward sweep over 8 fixed
//     stripes of the sparse grid (so the result does not depend on threads);
//   * densification: each pixel's flow is the average of the overlapping
//     patches' flows weighted by 1 / max(1, |photometric error|);
//   * variational refinement: fixed-point iterations of a red-black SOR on
//     the linearised energy with intensity (delta) and gradient (gamma) data
//     terms and a robust smoothness term (alpha).
// The flow is then resized up to the next scale and, from the finest scale,
// to the frame.  Each stage replays OpenCV 5's float arithmetic in its order
// of operations (its 4-lane sums included; the fused multiply-adds of its
// one-channel linear resize and of its remap as std::fma), so the flow is
// bitwise cv2's; OpenCV's results do not depend on its thread count, and
// this file is single-threaded.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

template <typename T>
struct Mat {
  int h = 0, w = 0;
  std::vector<T> d;
  Mat() = default;
  Mat(int rows, int cols, T v = T()) : h(rows), w(cols), d(size_t(rows) * cols, v) {}
  T* row(int y) { return d.data() + size_t(y) * w; }
  const T* row(int y) const { return d.data() + size_t(y) * w; }
  T& at(int y, int x) { return d[size_t(y) * w + x]; }
  const T& at(int y, int x) const { return d[size_t(y) * w + x]; }
};

using MatU8 = Mat<uint8_t>;
using MatS16 = Mat<int16_t>;
using MatF = Mat<float>;

// Four float lanes (SSE on x86, NEON on Arm); lane-wise IEEE arithmetic
// with no contraction, so the sums are those of OpenCV's v_float32x4 code.
typedef float v4 __attribute__((vector_size(16)));

inline v4 load4(const float* p) {
  v4 v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

inline v4 splat(float x) { return v4{x, x, x, x}; }

inline void store4(float* p, v4 v) { std::memcpy(p, &v, sizeof(v)); }

inline v4 sqrt4(v4 v) {
  return v4{std::sqrt(v[0]), std::sqrt(v[1]), std::sqrt(v[2]), std::sqrt(v[3])};
}

inline uint8_t sat_u8(float v) {
  int i = int(std::nearbyint(v));     // cvRound: half to even
  return uint8_t(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// ------------------------------------------------------------- resizes

// cv::resize(INTER_AREA) of uint8 to a smaller size: the 2x2 fast path
// ((a + b + c + d + 2) >> 2) when both ratios are exactly 2, else the
// general area-weighted sum in float (computeResizeAreaTab).
struct AreaTab {
  int di, si;
  float alpha;
};

std::vector<AreaTab> area_tab(int ssize, int dsize, double scale) {
  std::vector<AreaTab> tab;
  for (int dx = 0; dx < dsize; dx++) {
    double fsx1 = dx * scale, fsx2 = fsx1 + scale;
    double cell = std::min(scale, ssize - fsx1);
    int sx1 = int(std::ceil(fsx1)), sx2 = int(std::floor(fsx2));
    sx2 = std::min(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3)
      tab.push_back({dx, sx1 - 1, float((sx1 - fsx1) / cell)});
    for (int sx = sx1; sx < sx2; sx++) tab.push_back({dx, sx, float(1.0 / cell)});
    if (fsx2 - sx2 > 1e-3)
      tab.push_back({dx, sx2, float(std::min(std::min(fsx2 - sx2, 1.), cell) / cell)});
  }
  return tab;
}

MatU8 resize_area(const MatU8& src, int dh, int dw) {
  MatU8 dst(dh, dw);
  double inv_x = double(dw) / src.w, inv_y = double(dh) / src.h;
  double scale_x = 1. / inv_x, scale_y = 1. / inv_y;
  int ix = int(std::nearbyint(scale_x)), iy = int(std::nearbyint(scale_y));
  bool fast = std::fabs(scale_x - ix) < 2.220446049250313e-16 &&
              std::fabs(scale_y - iy) < 2.220446049250313e-16;
  if (fast && ix == 2 && iy == 2) {
    for (int y = 0; y < dh; y++) {
      const uint8_t* s0 = src.row(2 * y);
      const uint8_t* s1 = src.row(2 * y + 1);
      uint8_t* o = dst.row(y);
      for (int x = 0; x < dw; x++)
        o[x] = uint8_t((s0[2 * x] + s0[2 * x + 1] + s1[2 * x] + s1[2 * x + 1] + 2) >> 2);
    }
    return dst;
  }
  if (fast) throw Error{"integer area resize other than 2x2 is not used"};
  std::vector<AreaTab> xt = area_tab(src.w, dw, scale_x);
  std::vector<AreaTab> yt = area_tab(src.h, dh, scale_y);
  std::vector<float> buf(static_cast<size_t>(dw)), sum(static_cast<size_t>(dw), 0.f);
  int prev_dy = yt.empty() ? 0 : yt[0].di;
  for (const AreaTab& ye : yt) {
    const uint8_t* s = src.row(ye.si);
    std::fill(buf.begin(), buf.end(), 0.f);
    for (const AreaTab& xe : xt) buf[xe.di] += float(s[xe.si]) * xe.alpha;
    if (ye.di != prev_dy) {
      uint8_t* o = dst.row(prev_dy);
      for (int x = 0; x < dw; x++) {
        o[x] = sat_u8(sum[x]);
        sum[x] = ye.alpha * buf[x];
      }
      prev_dy = ye.di;
    } else {
      for (int x = 0; x < dw; x++) sum[x] += ye.alpha * buf[x];
    }
  }
  uint8_t* o = dst.row(prev_dy);
  for (int x = 0; x < dw; x++) o[x] = sat_u8(sum[x]);
  return dst;
}

struct LinearTaps {
  std::vector<int> i0, i1;
  std::vector<float> t;        // the fraction, float of the double fraction
};

LinearTaps linear_taps(int s, int d) {
  LinearTaps k;
  for (int x = 0; x < d; x++) {
    double f = (x + 0.5) * (double(s) / d) - 0.5;
    double fl = std::floor(f);
    int i = int(fl);
    k.i0.push_back(std::min(std::max(i, 0), s - 1));
    k.i1.push_back(std::min(std::max(i + 1, 0), s - 1));
    k.t.push_back(float(f - fl));
  }
  return k;
}

inline float lerp_fma(float t, float a, float b) { return std::fma(t, b - a, a); }

// cv::resize(INTER_LINEAR) of one float channel as OpenCV 5 computes it
// there: rows first, each a + t (b - a) as one fused multiply-add.
MatF resize_linear_1ch(const MatF& src, int dh, int dw) {
  LinearTaps kx = linear_taps(src.w, dw), ky = linear_taps(src.h, dh);
  MatF dst(dh, dw);
  for (int y = 0; y < dh; y++) {
    const float* r0 = src.row(ky.i0[y]);
    const float* r1 = src.row(ky.i1[y]);
    float* o = dst.row(y);
    for (int x = 0; x < dw; x++) {
      float h0 = lerp_fma(kx.t[x], r0[kx.i0[x]], r0[kx.i1[x]]);
      float h1 = lerp_fma(kx.t[x], r1[kx.i0[x]], r1[kx.i1[x]]);
      o[x] = lerp_fma(ky.t[y], h0, h1);
    }
  }
  return dst;
}

// cv::resize(INTER_LINEAR) of a 2-channel float image (resizeGeneric_ with
// HResizeLinear / VResizeLinear), applied to each channel: float weights
// (1 - f, f), w0 a + w1 b, rows then columns.
MatF resize_linear_2ch(const MatF& src, int dh, int dw) {
  const int sw = src.w, sh = src.h;
  double scale_x = 1. / (double(dw) / sw), scale_y = 1. / (double(dh) / sh);
  std::vector<int> xofs(static_cast<size_t>(dw));
  std::vector<float> a0(static_cast<size_t>(dw)), a1(static_cast<size_t>(dw));
  int xmax = dw;
  for (int dx = 0; dx < dw; dx++) {
    float fx = float((dx + 0.5) * scale_x - 0.5);
    int sx = int(std::floor(fx));
    fx -= float(sx);
    if (sx < 0) {
      fx = 0;
      sx = 0;
    }
    if (sx + 1 >= sw) {
      xmax = std::min(xmax, dx);
      if (sx >= sw - 1) {
        fx = 0;
        sx = sw - 1;
      }
    }
    xofs[dx] = sx;
    a0[dx] = 1.f - fx;
    a1[dx] = fx;
  }
  MatF hrow(sh, dw);
  for (int y = 0; y < sh; y++) {
    const float* s = src.row(y);
    float* o = hrow.row(y);
    int dx = 0;
    for (; dx < xmax; dx++) o[dx] = s[xofs[dx]] * a0[dx] + s[xofs[dx] + 1] * a1[dx];
    for (; dx < dw; dx++) o[dx] = s[xofs[dx]];
  }
  MatF dst(dh, dw);
  for (int dy = 0; dy < dh; dy++) {
    float fy = float((dy + 0.5) * scale_y - 0.5);
    int sy = int(std::floor(fy));
    fy -= float(sy);
    int y0 = std::min(std::max(sy, 0), sh - 1), y1 = std::min(std::max(sy + 1, 0), sh - 1);
    float b0 = 1.f - fy, b1 = fy;
    const float* r0 = hrow.row(y0);
    const float* r1 = hrow.row(y1);
    float* o = dst.row(dy);
    for (int x = 0; x < dw; x++) o[x] = r0[x] * b0 + r1[x] * b1;
  }
  return dst;
}

// ------------------------------------------------------------ gradients

inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

// cv::spatialGradient: 3x3 Sobel, BORDER_REFLECT_101, int16 out.
void spatial_gradient(const MatU8& src, MatS16& dx, MatS16& dy) {
  const int h = src.h, w = src.w;
  dx = MatS16(h, w);
  dy = MatS16(h, w);
  for (int y = 0; y < h; y++) {
    const uint8_t* um = src.row(reflect101(y - 1, h));
    const uint8_t* u0 = src.row(y);
    const uint8_t* up = src.row(reflect101(y + 1, h));
    for (int x = 0; x < w; x++) {
      int xm = reflect101(x - 1, w), xp = reflect101(x + 1, w);
      int gx = (um[xp] - um[xm]) + 2 * (u0[xp] - u0[xm]) + (up[xp] - up[xm]);
      int gy = (up[xm] + 2 * up[x] + up[xp]) - (um[xm] + 2 * um[x] + um[xp]);
      dx.at(y, x) = int16_t(gx);
      dy.at(y, x) = int16_t(gy);
    }
  }
}

// --------------------------------------------------- variational refinement

struct VariationalRefinement {
  int fixed_point_iters = 5, sor_iters = 5;
  float alpha = 20.f, delta = 5.f, gamma = 10.f, omega = 1.6f;
  float zeta = 0.1f, epsilon = 0.001f;

  // Refines (u, v) in place for the frames I0, I1.
  void calc_uv(const MatU8& I0, const MatU8& I1, MatF& u, MatF& v) const;
};

// dst = derivative of src along x (or y): src[+1] - src[-1], edges
// replicated (cv::Sobel with ksize 1, scale 1, BORDER_REPLICATE).
MatF central_diff(const MatF& s, bool along_x) {
  MatF out(s.h, s.w);
  for (int y = 0; y < s.h; y++)
    for (int x = 0; x < s.w; x++) {
      if (along_x) {
        int xm = std::max(x - 1, 0), xp = std::min(x + 1, s.w - 1);
        out.at(y, x) = s.at(y, xp) - s.at(y, xm);
      } else {
        int ym = std::max(y - 1, 0), yp = std::min(y + 1, s.h - 1);
        out.at(y, x) = s.at(yp, x) - s.at(ym, x);
      }
    }
  return out;
}

void VariationalRefinement::calc_uv(const MatU8& I0, const MatU8& I1, MatF& W_u,
                                    MatF& W_v) const {
  const int h = I0.h, w = I0.w;
  // warp I1 by the initial flow (cv::remap, INTER_LINEAR, BORDER_REPLICATE,
  // float maps; OpenCV 5 interpolates each axis as one fused multiply-add)
  MatF warped(h, w);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      float mx = float(x) + W_u.at(y, x);
      float my = float(y) + W_v.at(y, x);
      float fx = std::floor(mx), fy = std::floor(my);
      float a = mx - fx, b = my - fy;
      int ix = int(fx), iy = int(fy);
      int x0 = std::min(std::max(ix, 0), w - 1), x1 = std::min(std::max(ix + 1, 0), w - 1);
      int y0 = std::min(std::max(iy, 0), h - 1), y1 = std::min(std::max(iy + 1, 0), h - 1);
      float p00 = I1.at(y0, x0), p01 = I1.at(y0, x1);
      float p10 = I1.at(y1, x0), p11 = I1.at(y1, x1);
      float v0 = lerp_fma(a, p00, p01), v1 = lerp_fma(a, p10, p11);
      warped.at(y, x) = lerp_fma(b, v0, v1);
    }
  MatF averaged(h, w), Iz(h, w);
  for (size_t i = 0; i < averaged.d.size(); i++) {
    averaged.d[i] = float(I0.d[i]) * 0.5f + warped.d[i] * 0.5f;
    Iz.d[i] = warped.d[i] - float(I0.d[i]);
  }
  MatF Ix = central_diff(averaged, true), Iy = central_diff(averaged, false);
  MatF Ixz = central_diff(Iz, true), Iyz = central_diff(Iz, false);
  MatF Ixx = central_diff(Ix, true), Ixy = central_diff(Ix, false);
  MatF Iyy = central_diff(Iy, false);

  const float zeta2 = zeta * zeta, eps2 = epsilon * epsilon;
  const float gamma2 = gamma / 2, delta2 = delta / 2, alpha2 = alpha / 2;
  const size_t n = size_t(h) * w;
  std::vector<float> A11(n), A12(n), A22(n), b1(n), b2(n);
  // dU, dV and the smoothness weights live on a grid padded by one zero
  // pixel on each side: a missing neighbour adds 0 * 0 to the SOR sums
  const int ps = w + 2;
  auto P = [ps](int y, int x) { return size_t(y + 1) * ps + size_t(x + 1); };
  const size_t np = size_t(h + 2) * ps;
  std::vector<float> dU(np, 0.f), dV(np, 0.f), wgt(np, 0.f);
  std::vector<float> tU(W_u.d), tV(W_v.d);
  // one colour of the red-black split: rows of (w + 1) / 2 pixels, padded
  // by one zero row and column on each side (and zeros past a row's end)
  struct RB {
    int stride = 0;
    std::vector<float> a11, a12, a22, b1, b2, wgt, du, dv;
    explicit RB(int h, int w) : stride((w + 1) / 2 + 2) {
      const size_t m = size_t(h + 2) * stride;
      for (auto* v : {&a11, &a12, &a22, &b1, &b2, &wgt, &du, &dv}) v->assign(m, 0.f);
    }
    size_t at(int y, int k) const { return size_t(y + 1) * stride + size_t(k + 1); }
  };
  RB rb[2] = {RB(h, w), RB(h, w)};
  const float* Wu = W_u.d.data();
  const float* Wv = W_v.d.data();

  for (int it = 0; it < fixed_point_iters; it++) {
    // data terms (ComputeDataTerm_ParBody), four pixels at a time
    for (int y = 0; y < h; y++) {
      const size_t r = size_t(y) * w;
      const float* du_row = &dU[P(y, 0)];
      const float* dv_row = &dV[P(y, 0)];
      int x = 0;
      for (; x + 4 <= w; x += 4) {
        const size_t i = r + x;
        v4 ix = load4(&Ix.d[i]), iy = load4(&Iy.d[i]), iz = load4(&Iz.d[i]);
        v4 du = load4(du_row + x), dv = load4(dv_row + x);
        v4 norm = ix * ix + iy * iy + splat(zeta2);
        v4 ik1z = iz + ix * du + iy * dv;
        v4 wt = (splat(delta2) / sqrt4(ik1z * ik1z / norm + splat(eps2))) / norm;
        v4 a11 = wt * (ix * ix) + splat(zeta2);
        v4 a12 = wt * (ix * iy);
        v4 a22 = wt * (iy * iy) + splat(zeta2);
        v4 bb1 = splat(0.f) - wt * (iz * ix);
        v4 bb2 = splat(0.f) - wt * (iz * iy);
        v4 ixx = load4(&Ixx.d[i]), ixy = load4(&Ixy.d[i]), iyy = load4(&Iyy.d[i]);
        v4 ixz = load4(&Ixz.d[i]), iyz = load4(&Iyz.d[i]);
        norm = ixx * ixx + ixy * ixy + splat(zeta2);
        v4 norm2 = iyy * iyy + ixy * ixy + splat(zeta2);
        v4 ik1zx = ixz + ixx * du + ixy * dv;
        v4 ik1zy = iyz + ixy * du + iyy * dv;
        wt = splat(gamma2) / sqrt4(ik1zx * ik1zx / norm + ik1zy * ik1zy / norm2 + splat(eps2));
        a11 += wt * (ixx * ixx / norm + ixy * ixy / norm2);
        a12 += wt * (ixx * ixy / norm + ixy * iyy / norm2);
        a22 += wt * (ixy * ixy / norm + iyy * iyy / norm2);
        bb1 -= wt * (ixx * ixz / norm + ixy * iyz / norm2);
        bb2 -= wt * (ixy * ixz / norm + iyy * iyz / norm2);
        store4(&A11[i], a11);
        store4(&A12[i], a12);
        store4(&A22[i], a22);
        store4(&b1[i], bb1);
        store4(&b2[i], bb2);
      }
      for (; x < w; x++) {
        const size_t i = r + x;
        float ix = Ix.d[i], iy = Iy.d[i], iz = Iz.d[i], du = du_row[x], dv = dv_row[x];
        float norm = ix * ix + iy * iy + zeta2;
        float ik1z = iz + ix * du + iy * dv;
        float wt = (delta2 / std::sqrt(ik1z * ik1z / norm + eps2)) / norm;
        float a11 = wt * (ix * ix) + zeta2;
        float a12 = wt * (ix * iy);
        float a22 = wt * (iy * iy) + zeta2;
        float bb1 = -wt * (iz * ix);
        float bb2 = -wt * (iz * iy);
        float ixx = Ixx.d[i], ixy = Ixy.d[i], iyy = Iyy.d[i], ixz = Ixz.d[i], iyz = Iyz.d[i];
        norm = ixx * ixx + ixy * ixy + zeta2;
        float norm2 = iyy * iyy + ixy * ixy + zeta2;
        float ik1zx = ixz + ixx * du + ixy * dv;
        float ik1zy = iyz + ixy * du + iyy * dv;
        wt = gamma2 / std::sqrt(ik1zx * ik1zx / norm + ik1zy * ik1zy / norm2 + eps2);
        a11 += wt * (ixx * ixx / norm + ixy * ixy / norm2);
        a12 += wt * (ixx * ixy / norm + ixy * iyy / norm2);
        a22 += wt * (ixy * ixy / norm + iyy * iyy / norm2);
        bb1 += -wt * (ixx * ixz / norm + ixy * iyz / norm2);
        bb2 += -wt * (ixy * ixz / norm + iyy * iyz / norm2);
        A11[i] = a11;
        A12[i] = a12;
        A22[i] = a22;
        b1[i] = bb1;
        b2[i] = bb2;
      }
    }
    // smoothness weights from the current flow's forward differences (the
    // frame's last column and row difference with themselves: 0)
    for (int y = 0; y < h; y++) {
      const float* u0 = &tU[size_t(y) * w];
      const float* v0 = &tV[size_t(y) * w];
      const float* u1 = &tU[size_t(std::min(y + 1, h - 1)) * w];
      const float* v1 = &tV[size_t(std::min(y + 1, h - 1)) * w];
      float* wr = &wgt[P(y, 0)];
      for (int x = 0; x < w; x++) {
        int xp = x + 1 < w ? x + 1 : x;
        float uxp = u0[xp] - u0[x], vxp = v0[xp] - v0[x];
        float uyp = u1[x] - u0[x], vyp = v1[x] - v0[x];
        wr[x] = alpha2 / std::sqrt(uxp * uxp + vxp * vxp + uyp * uyp + vyp * vyp + eps2);
      }
    }
    // smoothness terms: each pixel's weight serves its right and its lower
    // edge; the red pass (x + y even) adds first, then the black pass
    for (int pass = 0; pass < 2; pass++)      // horizontal edges
      for (int y = 0; y < h; y++) {
        const size_t r = size_t(y) * w;
        const float* wr = &wgt[P(y, 0)];
        for (int x = (y + pass) & 1; x < w - 1; x += 2) {
          const size_t i = r + x;
          float wt = wr[x];
          float du = wt * (Wu[i + 1] - Wu[i]);
          float dv = wt * (Wv[i + 1] - Wv[i]);
          A11[i] += wt;
          A22[i] += wt;
          b1[i] += du;
          b2[i] += dv;
          A11[i + 1] += wt;
          A22[i + 1] += wt;
          b1[i + 1] -= du;
          b2[i + 1] -= dv;
        }
      }
    for (int pass = 0; pass < 2; pass++)      // vertical edges
      for (int y = 0; y < h - 1; y++) {
        const size_t r = size_t(y) * w;
        const float* wr = &wgt[P(y, 0)];
        for (int x = (y + pass) & 1; x < w; x += 2) {
          const size_t i = r + x, j = i + w;
          float wt = wr[x];
          float du = wt * (Wu[j] - Wu[i]);
          float dv = wt * (Wv[j] - Wv[i]);
          A11[i] += wt;
          A22[i] += wt;
          b1[i] += du;
          b2[i] += dv;
          A11[j] += wt;
          A22[j] += wt;
          b1[j] -= du;
          b2[j] -= dv;
        }
      }
    // red-black SOR on the split layout: colour c's pixels of row y are
    // x = s + 2k with s = (y + c) & 1; the other colour's left, right, upper
    // and lower neighbours sit at k - 1 + s, k + s, and k in rows y -+ 1
    for (int c = 0; c < 2; c++) {
      RB& q = rb[c];
      for (int y = 0; y < h; y++)
        for (int x = (y + c) & 1, k = 0; x < w; x += 2, k++) {
          const size_t i = size_t(y) * w + x, o = q.at(y, k);
          q.a11[o] = A11[i];
          q.a12[o] = A12[i];
          q.a22[o] = A22[i];
          q.b1[o] = b1[i];
          q.b2[o] = b2[i];
          q.wgt[o] = wgt[P(y, x)];
          q.du[o] = dU[P(y, x)];
          q.dv[o] = dV[P(y, x)];
        }
    }
    const v4 vomega = splat(omega);
    for (int sweep = 0; sweep < sor_iters; sweep++)
      for (int c = 0; c < 2; c++) {
        RB& q = rb[c];
        const RB& t = rb[1 - c];
        for (int y = 0; y < h; y++) {
          const int s = (y + c) & 1, n = (w - s + 1) / 2;
          const size_t o = q.at(y, 0);
          const size_t l = t.at(y, s - 1), rr = t.at(y, s);
          const size_t up = t.at(y - 1, 0), dn = t.at(y + 1, 0);
          int k = 0;
          for (; k + 4 <= n; k += 4) {
            v4 wc = load4(&q.wgt[o + k]);
            v4 sigma_u = load4(&t.wgt[l + k]) * load4(&t.du[l + k]) +
                         wc * load4(&t.du[rr + k]) +
                         load4(&t.wgt[up + k]) * load4(&t.du[up + k]) +
                         wc * load4(&t.du[dn + k]);
            v4 sigma_v = load4(&t.wgt[l + k]) * load4(&t.dv[l + k]) +
                         wc * load4(&t.dv[rr + k]) +
                         load4(&t.wgt[up + k]) * load4(&t.dv[up + k]) +
                         wc * load4(&t.dv[dn + k]);
            v4 du = load4(&q.du[o + k]), dv = load4(&q.dv[o + k]);
            v4 a12 = load4(&q.a12[o + k]);
            du += vomega * ((sigma_u + load4(&q.b1[o + k]) - dv * a12) / load4(&q.a11[o + k]) - du);
            dv += vomega * ((sigma_v + load4(&q.b2[o + k]) - du * a12) / load4(&q.a22[o + k]) - dv);
            store4(&q.du[o + k], du);
            store4(&q.dv[o + k], dv);
          }
          for (; k < n; k++) {
            float wc = q.wgt[o + k];
            float sigma_u = t.wgt[l + k] * t.du[l + k] + wc * t.du[rr + k] +
                            t.wgt[up + k] * t.du[up + k] + wc * t.du[dn + k];
            float sigma_v = t.wgt[l + k] * t.dv[l + k] + wc * t.dv[rr + k] +
                            t.wgt[up + k] * t.dv[up + k] + wc * t.dv[dn + k];
            float du = q.du[o + k], dv = q.dv[o + k];
            du += omega * ((sigma_u + q.b1[o + k] - dv * q.a12[o + k]) / q.a11[o + k] - du);
            dv += omega * ((sigma_v + q.b2[o + k] - du * q.a12[o + k]) / q.a22[o + k] - dv);
            q.du[o + k] = du;
            q.dv[o + k] = dv;
          }
        }
      }
    for (int c = 0; c < 2; c++) {
      const RB& q = rb[c];
      for (int y = 0; y < h; y++)
        for (int x = (y + c) & 1, k = 0; x < w; x += 2, k++) {
          dU[P(y, x)] = q.du[q.at(y, k)];
          dV[P(y, x)] = q.dv[q.at(y, k)];
        }
    }
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        const size_t i = size_t(y) * w + x, c = P(y, x);
        tU[i] = Wu[i] + dU[c];
        tV[i] = Wv[i] + dV[c];
      }
  }
  W_u.d = tU;
  W_v.d = tV;
}

// ------------------------------------------------------------------- DIS

struct DIS {
  int finest_scale = 1, coarsest_scale = -1, patch_size = 8, patch_stride = 3;
  int grad_descent_iter = 25, variational_refinement_iter = 5;
  float vr_alpha = 20.f, vr_gamma = 10.f, vr_delta = 5.f, vr_epsilon = 0.01f;
  bool use_mean_normalization = true, use_spatial_propagation = true;
  static constexpr int border_size = 16;
  static constexpr float kEps = 0.001f, kInf = 1e10f;

  // per-scale state
  int w = 0, h = 0, ws = 0, hs = 0;
  MatF Sx, Sy;
  MatF xx, yy, xy, x_sum, y_sum;   // structure tensor per patch

  void structure_tensor(const MatS16& Ix, const MatS16& Iy);
  void inverse_search(MatF& Ux, MatF& Uy, const MatU8& I0, const MatU8& I1ext,
                      const MatS16& Ix, const MatS16& Iy, int nstripes, int num_iter);
  void densify(MatF& Ux, MatF& Uy, const MatU8& I0, const MatU8& I1);
  void calc(const MatU8& I0, const MatU8& I1, MatF& flow_u, MatF& flow_v);
};

void DIS::structure_tensor(const MatS16& Ix, const MatS16& Iy) {
  const int ps = patch_size, st = patch_stride;
  MatF axx(h, ws), ayy(h, ws), axy(h, ws), ax(h, ws), ay(h, ws);
  for (int i = 0; i < h; i++) {
    float sxx = 0, syy = 0, sxy = 0, sx = 0, sy = 0;
    const int16_t* xr = Ix.row(i);
    const int16_t* yr = Iy.row(i);
    for (int j = 0; j < ps; j++) {
      sxx += float(xr[j] * xr[j]);
      syy += float(yr[j] * yr[j]);
      sxy += float(xr[j] * yr[j]);
      sx += float(xr[j]);
      sy += float(yr[j]);
    }
    axx.at(i, 0) = sxx;
    ayy.at(i, 0) = syy;
    axy.at(i, 0) = sxy;
    ax.at(i, 0) = sx;
    ay.at(i, 0) = sy;
    int js = 1;
    for (int j = ps; j < w; j++) {
      sxx += float(xr[j] * xr[j] - xr[j - ps] * xr[j - ps]);
      syy += float(yr[j] * yr[j] - yr[j - ps] * yr[j - ps]);
      sxy += float(xr[j] * yr[j] - xr[j - ps] * yr[j - ps]);
      sx += float(xr[j] - xr[j - ps]);
      sy += float(yr[j] - yr[j - ps]);
      if ((j - ps + 1) % st == 0) {
        axx.at(i, js) = sxx;
        ayy.at(i, js) = syy;
        axy.at(i, js) = sxy;
        ax.at(i, js) = sx;
        ay.at(i, js) = sy;
        js++;
      }
    }
  }
  xx = MatF(hs, ws);
  yy = MatF(hs, ws);
  xy = MatF(hs, ws);
  x_sum = MatF(hs, ws);
  y_sum = MatF(hs, ws);
  std::vector<float> sxx(size_t(ws), 0.f), syy(static_cast<size_t>(ws), 0.f), sxy(static_cast<size_t>(ws), 0.f),
      sx(size_t(ws), 0.f), sy(static_cast<size_t>(ws), 0.f);
  for (int i = 0; i < ps; i++)
    for (int j = 0; j < ws; j++) {
      sxx[j] += axx.at(i, j);
      syy[j] += ayy.at(i, j);
      sxy[j] += axy.at(i, j);
      sx[j] += ax.at(i, j);
      sy[j] += ay.at(i, j);
    }
  for (int j = 0; j < ws; j++) {
    xx.at(0, j) = sxx[j];
    yy.at(0, j) = syy[j];
    xy.at(0, j) = sxy[j];
    x_sum.at(0, j) = sx[j];
    y_sum.at(0, j) = sy[j];
  }
  int is = 1;
  for (int i = ps; i < h; i++) {
    for (int j = 0; j < ws; j++) {
      sxx[j] += (axx.at(i, j) - axx.at(i - ps, j));
      syy[j] += (ayy.at(i, j) - ayy.at(i - ps, j));
      sxy[j] += (axy.at(i, j) - axy.at(i - ps, j));
      sx[j] += (ax.at(i, j) - ax.at(i - ps, j));
      sy[j] += (ay.at(i, j) - ay.at(i - ps, j));
    }
    if ((i - ps + 1) % st == 0) {
      for (int j = 0; j < ws; j++) {
        xx.at(is, j) = sxx[j];
        yy.at(is, j) = syy[j];
        xy.at(is, j) = sxy[j];
        x_sum.at(is, j) = sx[j];
        y_sum.at(is, j) = sy[j];
      }
      is++;
    }
  }
}

// OpenCV's v_reduce_sum of a 4-lane float vector on SSE: (l0 + l2) + (l1 + l3).
inline float reduce4(v4 v) { return (v[0] + v[2]) + (v[1] + v[3]); }

// The 8x8 patch kernels on float planes: I0 at (i, j), I1 bilinear at the
// patch's offset (weights w00..w11), in the 4-lane order of OpenCV's SIMD
// code (lane k holds columns k and k + 4, summed over the rows).
struct PatchSums {
  float sum_diff, sum_diff_sq, sum_x, sum_y;
};

template <bool kGrad, bool kMean>
inline PatchSums patch_sums(const float* I0, const float* I1, const float* I0x,
                            const float* I0y, int I0_stride, int I1_stride, float w00,
                            float w01, float w10, float w11) {
  const v4 a00 = splat(w00), a01 = splat(w01), a10 = splat(w10), a11 = splat(w11);
  v4 ax = splat(0.f), ay = splat(0.f), sq = splat(0.f), sd = splat(0.f);
  for (int r = 0; r < 8; r++) {
    const float* a = I1 + size_t(r) * I1_stride;
    const float* b = a + I1_stride;
    const float* z = I0 + size_t(r) * I0_stride;
    v4 dl = a00 * load4(a) + a01 * load4(a + 1) + a10 * load4(b) + a11 * load4(b + 1) -
            load4(z);
    v4 dr = a00 * load4(a + 4) + a01 * load4(a + 5) + a10 * load4(b + 4) +
            a11 * load4(b + 5) - load4(z + 4);
    if (kGrad) {
      const float* gx = I0x + size_t(r) * I0_stride;
      const float* gy = I0y + size_t(r) * I0_stride;
      ax += dl * load4(gx) + dr * load4(gx + 4);
      ay += dl * load4(gy) + dr * load4(gy + 4);
    }
    sq += dl * dl + dr * dr;
    if (kMean) sd += dl + dr;
  }
  return {kMean ? reduce4(sd) : 0.f, reduce4(sq), kGrad ? reduce4(ax) : 0.f,
          kGrad ? reduce4(ay) : 0.f};
}

template <typename T>
std::vector<float> to_float(const Mat<T>& m) {
  return std::vector<float>(m.d.begin(), m.d.end());
}

void DIS::inverse_search(MatF& Ux, MatF& Uy, const MatU8& I0, const MatU8& I1ext,
                         const MatS16& I0x, const MatS16& I0y, int nstripes, int num_iter) {
  const int psz = patch_size, psz2 = psz / 2, bsz = border_size;
  const int w_ext = w + 2 * bsz;
  const int stripe_sz = int(std::ceil(hs / double(nstripes)));
  const float i_lower = float(bsz - psz + 1), i_upper = float(bsz + h - 1);
  const float j_lower = float(bsz - psz + 1), j_upper = float(bsz + w - 1);
  const float n = float(psz) * float(psz);
  const int num_inner = int(std::floor(grad_descent_iter / float(num_iter)));
  const std::vector<float> I0f = to_float(I0), I1f = to_float(I1ext);
  const std::vector<float> gxf = to_float(I0x), gyf = to_float(I0y);
  const float* I1p = I1f.data();

  struct Bilinear {
    float i1, j1, w00, w01, w10, w11;
  };
  auto weights_at = [&](int i, int j, float ux, float uy) {
    Bilinear b;
    b.i1 = std::min(std::max(float(i) + uy + float(bsz), i_lower), i_upper);
    b.j1 = std::min(std::max(float(j) + ux + float(bsz), j_lower), j_upper);
    float di = b.i1 - std::floor(b.i1), dj = b.j1 - std::floor(b.j1);
    b.w11 = di * dj;
    b.w10 = di * (1 - dj);
    b.w01 = (1 - di) * dj;
    b.w00 = (1 - di) * (1 - dj);
    return b;
  };
  auto ssd = [&](int i, int j, float ux, float uy) {
    Bilinear b = weights_at(i, j, ux, uy);
    const float* p0 = I0f.data() + size_t(i) * w + j;
    const float* p1 = I1p + size_t(int(b.i1)) * w_ext + int(b.j1);
    if (use_mean_normalization) {
      PatchSums s = patch_sums<false, true>(p0, p1, nullptr, nullptr, w, w_ext, b.w00,
                                            b.w01, b.w10, b.w11);
      return s.sum_diff_sq - s.sum_diff * s.sum_diff / n;
    }
    return patch_sums<false, false>(p0, p1, nullptr, nullptr, w, w_ext, b.w00, b.w01,
                                    b.w10, b.w11).sum_diff_sq;
  };

  for (int stripe = 0; stripe < nstripes; stripe++) {
    for (int iter = 0; iter < num_iter; iter++) {
      int dir, start_is, end_is, start_js, end_js, start_i, start_j;
      if (iter % 2 == 0) {
        dir = 1;
        start_is = std::min(stripe * stripe_sz, hs);
        end_is = std::min((stripe + 1) * stripe_sz, hs);
        start_js = 0;
        end_js = ws;
        start_i = start_is * patch_stride;
        start_j = 0;
      } else {
        dir = -1;
        start_is = std::min((stripe + 1) * stripe_sz, hs) - 1;
        end_is = std::min(stripe * stripe_sz, hs) - 1;
        start_js = ws - 1;
        end_js = -1;
        start_i = start_is * patch_stride;
        start_j = (ws - 1) * patch_stride;
      }
      int i = start_i;
      for (int is = start_is; dir * is < dir * end_is; is += dir) {
        int j = start_j;
        for (int js = start_js; dir * js < dir * end_js; js += dir) {
          float& sx = Sx.at(is, js);
          float& sy = Sy.at(is, js);
          if (iter == 0) {
            sx = Ux.at(i + psz2, j + psz2);
            sy = Uy.at(i + psz2, j + psz2);
          }
          float min_ssd = kInf, cur_ssd;
          if (use_spatial_propagation) {
            min_ssd = ssd(i, j, sx, sy);
            if (dir * js > dir * start_js) {
              float cx = Sx.at(is, js - dir), cy = Sy.at(is, js - dir);
              cur_ssd = ssd(i, j, cx, cy);
              if (cur_ssd < min_ssd) {
                min_ssd = cur_ssd;
                sx = cx;
                sy = cy;
              }
            }
            if (dir * is > dir * start_is) {
              float cx = Sx.at(is - dir, js), cy = Sy.at(is - dir, js);
              cur_ssd = ssd(i, j, cx, cy);
              if (cur_ssd < min_ssd) {
                min_ssd = cur_ssd;
                sx = cx;
                sy = cy;
              }
            }
          }
          float cur_ux = sx, cur_uy = sy;
          float hxx = xx.at(is, js), hyy = yy.at(is, js), hxy = xy.at(is, js);
          float det = hxx * hyy - hxy * hxy;
          if (std::fabs(det) < kEps) det = kEps;
          float inv11 = hyy / det, inv12 = -hxy / det, inv22 = hxx / det;
          float prev_ssd = kInf;
          float gx_sum = x_sum.at(is, js), gy_sum = y_sum.at(is, js);
          for (int t = 0; t < num_inner; t++) {
            Bilinear b = weights_at(i, j, cur_ux, cur_uy);
            const float* p0 = I0f.data() + size_t(i) * w + j;
            const float* p1 = I1p + size_t(int(b.i1)) * w_ext + int(b.j1);
            const float* gx = gxf.data() + size_t(i) * w + j;
            const float* gy = gyf.data() + size_t(i) * w + j;
            float dux, duy, cur;
            if (use_mean_normalization) {
              PatchSums s = patch_sums<true, true>(p0, p1, gx, gy, w, w_ext, b.w00, b.w01,
                                                   b.w10, b.w11);
              dux = s.sum_x - s.sum_diff * gx_sum / n;
              duy = s.sum_y - s.sum_diff * gy_sum / n;
              cur = s.sum_diff_sq - s.sum_diff * s.sum_diff / n;
            } else {
              PatchSums s = patch_sums<true, false>(p0, p1, gx, gy, w, w_ext, b.w00, b.w01,
                                                    b.w10, b.w11);
              dux = s.sum_x;
              duy = s.sum_y;
              cur = s.sum_diff_sq;
            }
            float dx = inv11 * dux + inv12 * duy;
            float dy = inv12 * dux + inv22 * duy;
            cur_ux -= dx;
            cur_uy -= dy;
            if (cur >= prev_ssd) break;
            prev_ssd = cur;
          }
          float ex = cur_ux - sx, ey = cur_uy - sy;
          if (std::sqrt(ex * ex + ey * ey) <= float(psz)) {
            sx = cur_ux;
            sy = cur_uy;
          }
          j += dir * patch_stride;
        }
        i += dir * patch_stride;
      }
    }
  }
}

void DIS::densify(MatF& Ux, MatF& Uy, const MatU8& I0, const MatU8& I1) {
  const int psz = patch_size, pstr = patch_stride;
  int start_is = 0, end_is = -1;
  for (int i = 0; i < h; i++) {
    if (i % pstr == 0 && i + psz <= h) end_is++;
    if (i - psz >= 0 && (i - psz) % pstr == 0 && start_is < end_is) start_is++;
    int start_js = 0, end_js = -1;
    for (int j = 0; j < w; j++) {
      if (j % pstr == 0 && j + psz <= w) end_js++;
      if (j - psz >= 0 && (j - psz) % pstr == 0 && start_js < end_js) start_js++;
      float sum_coef = 0.f, sum_ux = 0.f, sum_uy = 0.f;
      for (int is = start_is; is <= end_is; is++)
        for (int js = start_js; js <= end_js; js++) {
          float sx = Sx.at(is, js), sy = Sy.at(is, js);
          float j_m = std::min(std::max(float(j) + sx, 0.0f), float(w) - 1.0f - kEps);
          float i_m = std::min(std::max(float(i) + sy, 0.0f), float(h) - 1.0f - kEps);
          int j_l = int(j_m), j_u = j_l + 1, i_l = int(i_m), i_u = i_l + 1;
          float diff = (j_m - float(j_l)) * (i_m - float(i_l)) * float(I1.at(i_u, j_u)) +
                       (float(j_u) - j_m) * (i_m - float(i_l)) * float(I1.at(i_u, j_l)) +
                       (j_m - float(j_l)) * (float(i_u) - i_m) * float(I1.at(i_l, j_u)) +
                       (float(j_u) - j_m) * (float(i_u) - i_m) * float(I1.at(i_l, j_l)) -
                       float(I0.at(i, j));
          float coef = 1 / std::max(1.0f, std::fabs(diff));
          sum_ux += coef * sx;
          sum_uy += coef * sy;
          sum_coef += coef;
        }
      Ux.at(i, j) = sum_ux / sum_coef;
      Uy.at(i, j) = sum_uy / sum_coef;
    }
  }
}

int auto_coarsest(int rows, int cols, int patch_size) {
  int a = int(std::log(std::max(cols, rows) / (4.0 * patch_size)) / std::log(2.0) + 0.5);
  int b = int(std::log(std::min(cols, rows) / patch_size) / std::log(2.0));
  return std::min(a, b);
}

void DIS::calc(const MatU8& I0, const MatU8& I1, MatF& flow_u, MatF& flow_v) {
  int coarsest = coarsest_scale >= 0 ? coarsest_scale : auto_coarsest(I0.h, I0.w, patch_size);
  if (coarsest < 0)
    throw Error{"the frame must have a width or a height of 12 or more"};
  if (coarsest < finest_scale) {
    // OpenCV's autoSelectPatchSizeAndScales for a small frame (finest scale
    // 1 or 2: 8x8 patches, the coarsest scale from the width)
    if (finest_scale != 1 && finest_scale != 2)
      throw Error{"the frame is too small for DIS at finest scale " +
                  std::to_string(finest_scale)};
    float ratio = (2.0f * float(I0.w)) / (5.0f * float(patch_size));
    coarsest = std::max(0, int(std::floor(std::log2(ratio))));
    finest_scale = std::max(coarsest - 2, 0);
  }
  std::vector<MatU8> I0s(size_t(coarsest) + 1), I1s(size_t(coarsest) + 1);
  std::vector<MatF> Ux(size_t(coarsest) + 1), Uy(size_t(coarsest) + 1);
  int fraction = 1;
  for (int i = 0; i <= coarsest; i++) {
    if (i == finest_scale) {
      int rows = I0.h / fraction, cols = I0.w / fraction;
      I0s[i] = fraction == 1 ? I0 : resize_area(I0, rows, cols);
      I1s[i] = fraction == 1 ? I1 : resize_area(I1, rows, cols);
    } else if (i > finest_scale) {
      int rows = I0s[i - 1].h / 2, cols = I0s[i - 1].w / 2;
      I0s[i] = resize_area(I0s[i - 1], rows, cols);
      I1s[i] = resize_area(I1s[i - 1], rows, cols);
    }
    if (i >= finest_scale) {
      if (I0s[i].h < patch_size || I0s[i].w < patch_size)
        throw Error{"the frame (" + std::to_string(I0.h) + "x" + std::to_string(I0.w) +
                    ") is smaller than a patch at DIS scale " + std::to_string(i)};
      Ux[i] = MatF(I0s[i].h, I0s[i].w, 0.f);
      Uy[i] = MatF(I0s[i].h, I0s[i].w, 0.f);
    }
    fraction *= 2;
  }
  const int fs = finest_scale;
  VariationalRefinement vr;
  vr.alpha = vr_alpha;
  vr.gamma = vr_gamma;
  vr.delta = vr_delta;
  vr.epsilon = vr_epsilon;
  vr.sor_iters = 5;
  vr.fixed_point_iters = variational_refinement_iter;
  for (int i = coarsest; i >= fs; i--) {
    w = I0s[i].w;
    h = I0s[i].h;
    ws = 1 + (w - patch_size) / patch_stride;
    hs = 1 + (h - patch_size) / patch_stride;
    Sx = MatF(hs, ws);
    Sy = MatF(hs, ws);
    MatU8 I1ext(h + 2 * border_size, w + 2 * border_size);
    for (int y = 0; y < I1ext.h; y++)
      for (int x = 0; x < I1ext.w; x++)
        I1ext.at(y, x) = I1s[i].at(std::min(std::max(y - border_size, 0), h - 1),
                                   std::min(std::max(x - border_size, 0), w - 1));
    MatS16 I0x, I0y;
    spatial_gradient(I0s[i], I0x, I0y);
    structure_tensor(I0x, I0y);
    if (use_spatial_propagation)
      inverse_search(Ux[i], Uy[i], I0s[i], I1ext, I0x, I0y, 8, 2);
    else
      inverse_search(Ux[i], Uy[i], I0s[i], I1ext, I0x, I0y, 1, 1);
    densify(Ux[i], Uy[i], I0s[i], I1s[i]);
    if (variational_refinement_iter > 0) vr.calc_uv(I0s[i], I1s[i], Ux[i], Uy[i]);
    if (i > fs) {
      Ux[i - 1] = resize_linear_1ch(Ux[i], Ux[i - 1].h, Ux[i - 1].w);
      Uy[i - 1] = resize_linear_1ch(Uy[i], Uy[i - 1].h, Uy[i - 1].w);
      for (float& v : Ux[i - 1].d) v *= 2;
      for (float& v : Uy[i - 1].d) v *= 2;
    }
  }
  flow_u = resize_linear_2ch(Ux[fs], I0.h, I0.w);
  flow_v = resize_linear_2ch(Uy[fs], I0.h, I0.w);
  const float mul = float(1 << fs);
  for (float& v : flow_u.d) v *= mul;
  for (float& v : flow_v.d) v *= mul;
}

int report(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
  return -1;
}

MatU8 wrap_u8(const uint8_t* p, int h, int w) {
  MatU8 m(h, w);
  std::memcpy(m.d.data(), p, m.d.size());
  return m;
}

MatF wrap_f(const float* p, int h, int w) {
  MatF m(h, w);
  std::memcpy(m.d.data(), p, m.d.size() * sizeof(float));
  return m;
}

}  // namespace

extern "C" {

// DIS flow of two [h, w] uint8 frames into flow ([h, w, 2] float32).
// params (int32): finest_scale, coarsest_scale (-1: from the frame size),
// patch_size, patch_stride, gradient-descent iterations, variational
// iterations, mean normalisation, spatial propagation; fparams (float32):
// alpha, gamma, delta, epsilon of the refinement.
int rt_dis_flow(const uint8_t* i0, const uint8_t* i1, int32_t h, int32_t w,
                const int32_t* params, const float* fparams, float* flow, char* err,
                int errlen) {
  try {
    DIS dis;
    dis.finest_scale = params[0];
    dis.coarsest_scale = params[1];
    dis.patch_size = params[2];
    dis.patch_stride = params[3];
    dis.grad_descent_iter = params[4];
    dis.variational_refinement_iter = params[5];
    dis.use_mean_normalization = params[6] != 0;
    dis.use_spatial_propagation = params[7] != 0;
    dis.vr_alpha = fparams[0];
    dis.vr_gamma = fparams[1];
    dis.vr_delta = fparams[2];
    dis.vr_epsilon = fparams[3];
    if (dis.patch_size != 8) throw Error{"only 8x8 patches are supported"};
    if (dis.patch_stride < 1 || dis.finest_scale < 0 || dis.grad_descent_iter < 1)
      throw Error{"invalid DIS parameters"};
    MatU8 a = wrap_u8(i0, h, w), b = wrap_u8(i1, h, w);
    MatF u, v;
    dis.calc(a, b, u, v);
    for (size_t k = 0; k < u.d.size(); k++) {
      flow[2 * k] = u.d[k];
      flow[2 * k + 1] = v.d[k];
    }
    return 0;
  } catch (const Error& e) {
    return report(err, errlen, e.msg);
  } catch (const std::exception& e) {
    return report(err, errlen, e.what());
  }
}

// The variational refinement alone (cv::VariationalRefinement::calcUV):
// u and v ([h, w] float32) refined in place.  fparams: alpha, gamma, delta,
// epsilon, omega; iters: fixed-point and SOR iterations.
int rt_variational_refinement(const uint8_t* i0, const uint8_t* i1, int32_t h, int32_t w,
                              float* u, float* v, const float* fparams,
                              const int32_t* iters, char* err, int errlen) {
  try {
    VariationalRefinement vr;
    vr.alpha = fparams[0];
    vr.gamma = fparams[1];
    vr.delta = fparams[2];
    vr.epsilon = fparams[3];
    vr.omega = fparams[4];
    vr.fixed_point_iters = iters[0];
    vr.sor_iters = iters[1];
    MatU8 a = wrap_u8(i0, h, w), b = wrap_u8(i1, h, w);
    MatF mu = wrap_f(u, h, w), mv = wrap_f(v, h, w);
    vr.calc_uv(a, b, mu, mv);
    std::memcpy(u, mu.d.data(), mu.d.size() * sizeof(float));
    std::memcpy(v, mv.d.data(), mv.d.size() * sizeof(float));
    return 0;
  } catch (const Error& e) {
    return report(err, errlen, e.msg);
  } catch (const std::exception& e) {
    return report(err, errlen, e.what());
  }
}

}  // extern "C"
