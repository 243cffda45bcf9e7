// Helpers shared by the RoIAlign kernels of this directory: the pyramid
// levels a launch reads, channel vectors of a [.., C] NHWC row, and the
// sample points of a rotated roi (rroi_align.cu and
// rroi_align_backward.cu).
//
// Vec<T>: one 16-byte vector (4 float32 or 8 bfloat16 channels), loaded
// and accumulated into float32 registers, converted, or stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int stride[kMaxLevels];
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void fma_load(const float* p, float wgt, float* acc) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    acc[0] += wgt * q.x;
    acc[1] += wgt * q.y;
    acc[2] += wgt * q.z;
    acc[3] += wgt * q.w;
  }
  __device__ static void to_float(const uint4& q, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&q);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void fma_load(const __nv_bfloat16* p, float wgt,
                                  float* acc) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += wgt * f.x;
      acc[2 * i + 1] += wgt * f.y;
    }
  }
  __device__ static void to_float(const uint4& q, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// the levels of a launch from the C interface's scalar arguments
inline Levels make_levels(const void* f0, const void* f1, const void* f2,
                          const void* f3, int h0, int w0, int h1, int w1,
                          int h2, int w2, int h3, int w3, int st0, int st1,
                          int st2, int st3) {
  Levels lv;
  const void* ptrs[kMaxLevels] = {f0, f1, f2, f3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int sts[kMaxLevels] = {st0, st1, st2, st3};
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = ptrs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.stride[i] = sts[i];
  }
  return lv;
}

// A rotated roi (cx, cy, w, h, theta in image pixels) on a level of
// `stride` pixels: its centre and size in level pixels and its
// rotation.
struct RotatedRoi {
  float cx, cy, rw, rh, cos_t, sin_t;
};

// The sample points of rotated rois, computed as the plain version
// (aidet_tpu_torch/ops/rroi_align.py::sample_coords) computes them in
// float32, one rounding per operation: the _rn intrinsics are never
// contracted into FMAs, 1 / out_size is a rounded factor as there, and
// cos and sin are rounded from double precision.  So the forward, the
// backward's binning and its sums, and the plain version put every
// sample at the same point, bit for bit, and a sample on a cell or tile
// edge falls on the same side in all of them.
__device__ __forceinline__ RotatedRoi rotated_roi_at(
    const float* __restrict__ rrois, int k, int stride, int aligned) {
  const float* r = rrois + 5 * k;
  const float inv = __fdiv_rn(1.0f, static_cast<float>(stride));
  const float offset = aligned ? 0.5f : 0.0f;
  RotatedRoi g;
  g.cx = __fsub_rn(__fmul_rn(__ldg(r + 0), inv), offset);
  g.cy = __fsub_rn(__fmul_rn(__ldg(r + 1), inv), offset);
  g.rw = fmaxf(__fmul_rn(__ldg(r + 2), inv), 1e-3f);
  g.rh = fmaxf(__fmul_rn(__ldg(r + 3), inv), 1e-3f);
  double s, c;
  sincos(static_cast<double>(__ldg(r + 4)), &s, &c);
  g.cos_t = static_cast<float>(c);
  g.sin_t = static_cast<float>(s);
  return g;
}

// Sample (i, j) of the roi's n x n grid (n = out_size * ratio; i along
// the roi's height, j along its width) in level pixels: (ys, xs),
// before the out-of-map test and the clamp.  inv_out = 1.0f / out_size.
__device__ __forceinline__ void rotated_sample(const RotatedRoi& g, int i,
                                               int j, int ratio,
                                               float inv_out, float& ys,
                                               float& xs) {
  const float fr = static_cast<float>(ratio);
  const float gy = __fdiv_rn(static_cast<float>(i) + 0.5f, fr);
  const float gx = __fdiv_rn(static_cast<float>(j) + 0.5f, fr);
  const float yl = __fmul_rn(__fsub_rn(__fmul_rn(gy, inv_out), 0.5f), g.rh);
  const float xl = __fmul_rn(__fsub_rn(__fmul_rn(gx, inv_out), 0.5f), g.rw);
  xs = __fsub_rn(__fadd_rn(g.cx, __fmul_rn(xl, g.cos_t)),
                 __fmul_rn(yl, g.sin_t));
  ys = __fadd_rn(__fadd_rn(g.cy, __fmul_rn(xl, g.sin_t)),
                 __fmul_rn(yl, g.cos_t));
}

// A sample (ys, xs) on an h x w map: false if it lies outside [-1, h] x
// [-1, w] and contributes nothing; else its clamped corner rows y0, y1
// and columns x0, x1 (y1 = min(y0 + 1, h - 1): at the last row both are
// one cell) and the weights ly, lx of y1 and x1.
__device__ __forceinline__ bool sample_corners(float ys, float xs, int h,
                                               int w, int& y0, int& y1,
                                               int& x0, int& x1, float& ly,
                                               float& lx) {
  const float fh = static_cast<float>(h);
  const float fw = static_cast<float>(w);
  if (ys < -1.0f || ys > fh || xs < -1.0f || xs > fw) return false;
  const float y = fminf(fmaxf(ys, 0.0f), fh - 1.0f);
  const float x = fminf(fmaxf(xs, 0.0f), fw - 1.0f);
  y0 = static_cast<int>(floorf(y));
  x0 = static_cast<int>(floorf(x));
  y1 = min(y0 + 1, h - 1);
  x1 = min(x0 + 1, w - 1);
  ly = y - static_cast<float>(y0);
  lx = x - static_cast<float>(x0);
  return true;
}

}  // namespace
