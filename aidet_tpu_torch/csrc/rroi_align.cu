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
// the cells the rotated samples touch, which mostly hit the L1 and L2
// caches.  On the paths there are only B x 100 (predict) or B x 128
// (train) rois, so one launch is a few microseconds of work, and what
// each block does before its first feature load weighs as much as the
// loads.
//
// What the design does about it: the TPU kernel builds a dense
// interpolation matrix M [out_size^2, 32 * 48] per roi on the host and
// reduces a DMA'd window with one MXU product, because rotation mixes
// x and y and a TPU has no cheap gather.  That is a TPU device and
// does not carry over: here the samples are gathered directly.  One
// block takes one roi, so all of a roi's gathers go through one SM's L1,
// and the launch is one wave on 132 SMs at both path shapes (2 blocks
// of kThreads fit an SM):
// - Plan once per roi.  Thread 0 computes the roi's geometry
//   (rotated_roi_at: one double sincos per block, not per thread);
//   then each thread plans one sample of the block's bins into shared
//   memory: its four corner cells and weights, with 1 / ratio^2 folded
//   in, or cell -1 for a sample outside the map (as K1's plan pass).
//   The sample points are roi_common.cuh's, bit for bit.
// - Gather.  Thread (bin, channel vector) issues the 4 corner loads of
//   kGroup samples (a whole bin at ratio 2) before any FMA, sums in
//   float32 registers and stores one 16-byte vector.  threadIdx.x walks
//   the channel vectors fastest, so a warp reads the C contiguous
//   channels of a corner in coalesced 512-byte rows and reads its
//   plan entries as shared-memory broadcasts.  The output is stored
//   with a streaming (evict-first) hint: nothing reads it back here.
// A bin range whose plan would not fit kPlanSamples entries is planned
// and gathered in chunks of bins.  No atomics, no global scratch, no
// window, no level bump: the caller routes (with or without the TPU
// kernel's window bump).
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/rroi_align.py).

#include "roi_common.cuh"

namespace {

// Threads per block; samples whose 4 corner loads a thread issues
// together (a whole bin at ratio 2); plan entries in shared memory.  Two
// blocks an SM: at most 128 registers a thread.
constexpr int kThreads = 256;
constexpr int kGroup = 4;
constexpr int kPlanSamples = 512;

// One sample of the plan: its corners' cells (y * W + x on the roi's
// level; cell[0] = -1 for a sample outside the map) and weights, in the
// order (y0, x0), (y0, x1), (y1, x0), (y1, x1), times 1 / ratio^2.
struct alignas(16) SamplePlan {
  int4 cell;
  float4 w;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    rroi_align_kernel(Levels lv, int channels,
                      const float* __restrict__ rrois,
                      const int* __restrict__ bidx,
                      const int* __restrict__ lvls, int out_size, int ratio,
                      int aligned, T* __restrict__ out) {
  constexpr int V = Vec<T>::kN;
  __shared__ SamplePlan plan[kPlanSamples];
  __shared__ RotatedRoi geo;
  const int k = blockIdx.x;
  const int l = lvls[k];
  const int img = bidx[k];
  if (threadIdx.x == 0) geo = rotated_roi_at(rrois, k, lv.stride[l], aligned);
  __syncthreads();
  const RotatedRoi g = geo;
  const int height = lv.h[l];
  const int width = lv.w[l];
  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(img) * height * width * channels;
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));
  const float inv_count = 1.0f / static_cast<float>(ratio * ratio);
  const int r2 = ratio * ratio;
  const int ss = out_size * out_size;
  const int nvec = channels / V;
  const int chunk = kPlanSamples / r2;   // bins planned at a time (>= 1)

  for (int b0 = 0; b0 < ss; b0 += chunk) {
    const int nb = min(chunk, ss - b0);
    for (int q = threadIdx.x; q < nb * r2; q += kThreads) {
      const int bin = b0 + q / r2;
      const int s = q - (q / r2) * r2;
      const int py = bin / out_size;
      const int px = bin - py * out_size;
      float ys, xs;
      rotated_sample(g, py * ratio + s / ratio, px * ratio + s % ratio,
                     ratio, inv_out, ys, xs);
      int y0, y1, x0, x1;
      float ly, lx;
      SamplePlan p;
      if (sample_corners(ys, xs, height, width, y0, y1, x0, x1, ly, lx)) {
        const float hy = 1.0f - ly;
        const float hx = 1.0f - lx;
        p.cell = make_int4(y0 * width + x0, y0 * width + x1,
                           y1 * width + x0, y1 * width + x1);
        p.w = make_float4(hy * hx * inv_count, hy * lx * inv_count,
                          ly * hx * inv_count, ly * lx * inv_count);
      } else {
        p.cell = make_int4(-1, 0, 0, 0);
        p.w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      plan[q] = p;
    }
    __syncthreads();

    for (int task = threadIdx.x; task < nb * nvec; task += kThreads) {
      const int bl = task / nvec;
      const int c = (task - bl * nvec) * V;
      const SamplePlan* bp = plan + bl * r2;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
      for (int s0 = 0; s0 < r2; s0 += kGroup) {
        uint4 q[kGroup][4];
        float w[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const bool on = s0 + u < r2 && bp[s0 + u].cell.x >= 0;
          const int4 cell = on ? bp[s0 + u].cell : make_int4(0, 0, 0, 0);
          const float4 wt = on ? bp[s0 + u].w
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const int cells[4] = {cell.x, cell.y, cell.z, cell.w};
          w[u][0] = wt.x;
          w[u][1] = wt.y;
          w[u][2] = wt.z;
          w[u][3] = wt.w;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            q[u][j] = on ? __ldg(reinterpret_cast<const uint4*>(
                               feat + static_cast<size_t>(cells[j]) *
                                          channels + c))
                         : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float f[V];
            Vec<T>::to_float(q[u][j], f);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] += w[u][j] * f[i];
          }
        }
      }
      uint4 q;
      Vec<T>::store(reinterpret_cast<T*>(&q), acc);
      __stcs(reinterpret_cast<uint4*>(out + (static_cast<size_t>(k) * ss +
                                             b0 + bl) * channels + c),
             q);
    }
    __syncthreads();   // the next chunk's plan overwrites this one
  }
}

template <typename T>
int launch(const Levels& lv, int channels, const float* rrois,
           const int* bidx, const int* lvls, int num_rois, int out_size,
           int ratio, int aligned, void* out, cudaStream_t stream) {
  if (channels % Vec<T>::kN) return static_cast<int>(cudaErrorInvalidValue);
  rroi_align_kernel<T><<<num_rois, kThreads, 0, stream>>>(
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
      out_size > 32 || sampling_ratio < 1 ||
      sampling_ratio * sampling_ratio > kPlanSamples || channels < 1 ||
      num_rois < 0) {
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
