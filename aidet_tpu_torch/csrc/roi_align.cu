// Multi-level aligned RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel aidet_tpu/ops/roi_align_band.py::roi_align_band
// (its pallas_call and _kernel), the default RoIAlign of bf16 predict.
//
// What it computes: for each roi k (routed to pyramid level lvl[k] of
// image bidx[k] by the caller), and each of the out_size x out_size bins,
// the mean of sampling_ratio^2 bilinear samples of the level's NHWC
// feature map, over all C channels:
//   x1 = roi.x1 / stride - 0.5, roi_w = roi.x2 / stride - 0.5 - x1
//   (aligned; v1 drops the 0.5 and clamps roi_w, roi_h at 1),
//   sample (iy, ix) of bin (py, px) at
//   y = y1 + (py * ratio + iy + 0.5) / ratio * roi_h / out_size;
// a sample with y < -1, y > H, x < -1 or x > W contributes 0, and the
// others are clamped to the map as in aidet_tpu/ops/roi_align.py
// (_bilinear_gather).  Output [K, out_size, out_size, C], caller order.
//
// What bounds it on an H100: memory.  Each output element costs
// 4 * ratio^2 loads and as many FMAs, so the arithmetic intensity is
// far below the H100's ridge (~295 bf16 FLOP per byte of HBM traffic);
// the loads are gathers from the feature pyramid (2 x 87040 x 256 bf16
// values for 2 images of 1024^2) that mostly hit the L2 cache, because
// the samples of one roi are neighbours.  Measured times: PERF.md.
//
// What the design does about it: the TPU kernel sorts rois into row
// bands, caches a band in VMEM and pools 4 rois per step with two
// block-diagonal MXU products, because a TPU pays a fixed cost per DMA.
// None of that carries over.  Here one block takes one (roi, bin row)
// pair; threadIdx.y is the bin column and threadIdx.x walks the channels
// in 16-byte vectors (8 bf16 or 4 f32), so one warp reads the C
// contiguous channels of a sample corner in fully coalesced 512-byte
// rows.  Sums are kept in f32 registers and the store is one 16-byte
// vector per thread.  No shared memory, no atomics, no sort.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include "roi_common.cuh"

namespace {

template <typename T>
__global__ void roi_align_kernel(Levels lv, int channels,
                                 const float* __restrict__ rois,
                                 const int* __restrict__ bidx,
                                 const int* __restrict__ lvls,
                                 int out_size, int ratio, int aligned,
                                 T* __restrict__ out) {
  constexpr int V = Vec<T>::kN;
  const int k = blockIdx.x / out_size;
  const int py = blockIdx.x % out_size;
  const int px = threadIdx.y;

  const int l = lvls[k];
  const int height = lv.h[l];
  const int width = lv.w[l];
  const float inv = 1.0f / static_cast<float>(lv.stride[l]);
  const float offset = aligned ? 0.5f : 0.0f;
  const float x1 = rois[4 * k + 0] * inv - offset;
  const float y1 = rois[4 * k + 1] * inv - offset;
  float roi_w = (rois[4 * k + 2] * inv - offset) - x1;
  float roi_h = (rois[4 * k + 3] * inv - offset) - y1;
  if (!aligned) {  // v1 clamps the roi size at 1; aligned mode does not
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  const float bin_w = roi_w / static_cast<float>(out_size);
  const float bin_h = roi_h / static_cast<float>(out_size);
  const float fh = static_cast<float>(height);
  const float fw = static_cast<float>(width);

  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(bidx[k]) * height * width * channels;
  T* dst = out + (static_cast<size_t>(k) * out_size * out_size +
                  static_cast<size_t>(py) * out_size + px) *
                     channels;
  const float inv_count = 1.0f / static_cast<float>(ratio * ratio);
  const int nvec = channels / V;

  for (int cv = threadIdx.x; cv < nvec; cv += blockDim.x) {
    const int c = cv * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int iy = 0; iy < ratio; ++iy) {
      const float gy =
          (static_cast<float>(py * ratio + iy) + 0.5f) / ratio;
      const float ys = y1 + gy * bin_h;
      if (ys < -1.0f || ys > fh) continue;
      const float y = fminf(fmaxf(ys, 0.0f), fh - 1.0f);
      const int y0 = static_cast<int>(floorf(y));
      const int y1i = min(y0 + 1, height - 1);
      const float ly = y - static_cast<float>(y0);
      const float hy = 1.0f - ly;
      const T* row0 = feat + static_cast<size_t>(y0) * width * channels + c;
      const T* row1 = feat + static_cast<size_t>(y1i) * width * channels + c;
      for (int ix = 0; ix < ratio; ++ix) {
        const float gx =
            (static_cast<float>(px * ratio + ix) + 0.5f) / ratio;
        const float xs = x1 + gx * bin_w;
        if (xs < -1.0f || xs > fw) continue;
        const float x = fminf(fmaxf(xs, 0.0f), fw - 1.0f);
        const int x0 = static_cast<int>(floorf(x));
        const int x1i = min(x0 + 1, width - 1);
        const float lx = x - static_cast<float>(x0);
        const float hx = 1.0f - lx;
        const size_t o0 = static_cast<size_t>(x0) * channels;
        const size_t o1 = static_cast<size_t>(x1i) * channels;
        Vec<T>::fma_load(row0 + o0, hy * hx, acc);
        Vec<T>::fma_load(row0 + o1, hy * lx, acc);
        Vec<T>::fma_load(row1 + o0, ly * hx, acc);
        Vec<T>::fma_load(row1 + o1, ly * lx, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] *= inv_count;
    Vec<T>::store(dst + c, acc);
  }
}

template <typename T>
int launch(const Levels& lv, int channels, const float* rois,
           const int* bidx, const int* lvls, int num_rois, int out_size,
           int ratio, int aligned, void* out, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const int nvec = channels / V;
  const dim3 block(nvec < 32 ? nvec : 32, out_size);
  const dim3 grid(num_rois * out_size);
  roi_align_kernel<T><<<grid, block, 0, stream>>>(
      lv, channels, rois, bidx, lvls, out_size, ratio, aligned,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  f0..f3 are the level maps
// [B, H_l, W_l, C] (unused ones may be null), st* their strides in
// pixels.  rois [K, 4] float32, bidx and lvls [K] int32, out
// [K, out_size, out_size, C] of the feature dtype.  All device pointers
// 16-byte aligned and C a multiple of the 16-byte vector width; the
// Python wrapper checks both.  device is the CUDA ordinal the tensors
// and the stream belong to.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it cannot take.
extern "C" int aidet_roi_align_forward(
    int device, int dtype, const void* f0, const void* f1, const void* f2,
    const void* f3, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
    int w3, int st0, int st1, int st2, int st3, int num_levels,
    int channels, const void* rois, const void* bidx, const void* lvls,
    int num_rois, int out_size, int sampling_ratio, int aligned, void* out,
    void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      out_size > 32 || sampling_ratio < 1 || channels < 1 || num_rois < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  // this library links its own CUDA runtime, whose current device is
  // not the caller's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Levels lv = make_levels(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3,
                                w3, st0, st1, st2, st3);
  const float* r = static_cast<const float*>(rois);
  const int* b = static_cast<const int*>(bidx);
  const int* l = static_cast<const int*>(lvls);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (channels % Vec<__nv_bfloat16>::kN) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<__nv_bfloat16>(lv, channels, r, b, l, num_rois, out_size,
                                 sampling_ratio, aligned, out, s);
  }
  if (dtype == 0) {
    if (channels % Vec<float>::kN) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch<float>(lv, channels, r, b, l, num_rois, out_size,
                         sampling_ratio, aligned, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
