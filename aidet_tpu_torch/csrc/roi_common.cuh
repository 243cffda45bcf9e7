// Helpers shared by the RoIAlign forward kernels of this directory
// (roi_align.cu, roi_align_bandx.cu, rroi_align.cu): the pyramid levels
// a launch reads, and loads of channel vectors of a [.., C] NHWC row
// accumulated into float32 registers.
//
// Vec<T>: one 16-byte vector (4 float32 or 8 bfloat16 channels).

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

}  // namespace
