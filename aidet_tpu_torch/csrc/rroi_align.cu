// Rotated multi-level aligned RoIAlign forward for Hopper (sm_90a).
//
// Replaces the forward of the TPU kernel
// aidet_tpu/ops/rroi_align_pallas.py::rroi_align_pallas (its
// pallas_call and _kernel), which computes
// aidet_tpu/ops/rroi_align.py::batched_rroi_align.
//
// What it computes: for each rotated roi k = (cx, cy, w, h, theta) in
// image pixels, routed to pyramid level lvl[k] of image bidx[k] by the
// caller, and each of the out_size x out_size bins, the mean of
// sampling_ratio^2 bilinear samples of the level's NHWC feature map,
// over all C channels.  On level l (stride s):
//   cx' = cx / s - 0.5, cy' = cy / s - 0.5 (aligned; v1 drops the 0.5),
//   rw = max(w / s, 1e-3), rh = max(h / s, 1e-3),
//   sample i of n = out_size * ratio along each roi axis at the local
//   offset ((i + 0.5) / ratio / out_size - 0.5) * rw (or rh), rotated
//   by theta about the centre:
//     x = cx' + xl cos(theta) - yl sin(theta)
//     y = cy' + xl sin(theta) + yl cos(theta);
// a sample with y < -1, y > H, x < -1 or x > W contributes 0 and still
// counts in the mean; the others are clamped to the map.  Output
// [K, out_size, out_size, C] in the features' dtype, caller order.
// The sample points are the plain version's, bit for bit
// (roi_common.cuh: rotated_roi_at, rotated_sample), as in the backward
// (rroi_align_backward.cu).
//
// What bounds it on an H100: memory.  As for K1 (roi_align.cu), each
// output element costs 4 * ratio^2 loads and as many FMAs, far below
// the card's ridge of ~295 bf16 FLOP per byte; the loads are gathers of
// the cells the rotated samples touch, which mostly hit the L2 cache.
// On the predict path there are only B x 100 rois, so one launch is a
// few microseconds of work and its fixed launch cost weighs as much.
//
// What the design does about it: the TPU kernel builds a dense
// interpolation matrix M [out_size^2, 32 * 48] per roi on the host and
// reduces a DMA'd window with one MXU product, because rotation mixes
// x and y and a TPU has no cheap gather.  That is a TPU device and
// does not carry over: here the samples are gathered directly, as in
// K1.  One block takes one (roi, bin row) pair; threadIdx.y is the bin
// column and threadIdx.x walks the channels in 16-byte vectors (8 bf16
// or 4 f32), so one warp reads the C contiguous channels of a sample
// corner in coalesced 512-byte rows.  Sums are kept in f32 registers,
// the store is one 16-byte vector per thread.  No shared memory, no
// atomics, no window, no level bump: the caller routes (with or without
// the TPU kernel's window bump).
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/rroi_align.py).

#include "roi_common.cuh"

namespace {

template <typename T>
__global__ void rroi_align_kernel(Levels lv, int channels,
                                  const float* __restrict__ rrois,
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
  const RotatedRoi g = rotated_roi_at(rrois, k, lv.stride[l], aligned);
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));

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
      for (int ix = 0; ix < ratio; ++ix) {
        float ys, xs;
        rotated_sample(g, py * ratio + iy, px * ratio + ix, ratio, inv_out,
                       ys, xs);
        int y0, y1i, x0, x1i;
        float ly, lx;
        if (!sample_corners(ys, xs, height, width, y0, y1i, x0, x1i, ly,
                            lx)) {
          continue;
        }
        const float hy = 1.0f - ly;
        const float hx = 1.0f - lx;
        const T* row0 = feat + static_cast<size_t>(y0) * width * channels + c;
        const T* row1 = feat + static_cast<size_t>(y1i) * width * channels + c;
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
int launch(const Levels& lv, int channels, const float* rrois,
           const int* bidx, const int* lvls, int num_rois, int out_size,
           int ratio, int aligned, void* out, cudaStream_t stream) {
  if (channels % Vec<T>::kN) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = channels / Vec<T>::kN;
  const dim3 block(nvec < 32 ? nvec : 32, out_size);
  const dim3 grid(num_rois * out_size);
  rroi_align_kernel<T><<<grid, block, 0, stream>>>(
      lv, channels, rrois, bidx, lvls, out_size, ratio, aligned,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  f0..f3 are the level maps
// [B, H_l, W_l, C] (unused ones may be null), st* their strides in
// pixels.  rrois [K, 5] float32 (cx, cy, w, h, theta), bidx and lvls
// [K] int32, out [K, out_size, out_size, C] of the feature dtype.  All
// device pointers 16-byte aligned and C a multiple of the 16-byte
// vector width; the Python wrapper checks both.  device is the CUDA
// ordinal the tensors and the stream belong to.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it cannot take.
extern "C" int aidet_rroi_align_forward(
    int device, int dtype, const void* f0, const void* f1, const void* f2,
    const void* f3, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
    int w3, int st0, int st1, int st2, int st3, int num_levels,
    int channels, const void* rrois, const void* bidx, const void* lvls,
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
  const float* r = static_cast<const float*>(rrois);
  const int* b = static_cast<const int*>(bidx);
  const int* l = static_cast<const int*>(lvls);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(lv, channels, r, b, l, num_rois, out_size,
                                 sampling_ratio, aligned, out, s);
  }
  if (dtype == 0) {
    return launch<float>(lv, channels, r, b, l, num_rois, out_size,
                         sampling_ratio, aligned, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
