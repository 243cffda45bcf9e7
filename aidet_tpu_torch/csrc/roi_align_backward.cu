// Multi-level aligned RoIAlign backward for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// aidet_tpu/ops/roi_align_pallas.py::roi_align_pallas, its custom_vjp
// _bwd (roi_align_pallas.py:378-393): the linear transpose of
// aidet_tpu/ops/roi_align.py::batched_multilevel_roi_align.  The
// forward of that function is K1 (roi_align.cu); the autograd Function
// in aidet_tpu_torch/ops/roi_align.py pairs the two.
//
// What it computes: given grad_out [K, out_size, out_size, C] (the
// forward's output dtype), and the forward's rois [K, 4] float32,
// image index bidx [K] and level lvls [K] (int32, routed by the caller
// exactly as for the forward), it adds
//   grad[bin] * w_corner / ratio^2
// for every sample of every bin into the 4 bilinear corners of that
// sample on level lvls[k] of image bidx[k].  The sample geometry is the
// forward's: aligned offset -0.5 (v1: none, sizes clamped at 1), a
// sample with y < -1, y > H, x < -1 or x > W adds nothing, the others
// are clamped to the map, and where a clamp makes two corners one cell
// (y0 == y1 at the last row) that cell receives both weights.  The
// gradient with respect to the rois is zero (the reference's _bwd
// returns zeros); the caller returns None for it.
//
// Accumulation: one float32 table per level ([B, H_l, W_l, C], one
// contiguous buffer for all levels), zeroed here with cudaMemsetAsync
// and summed with atomicAdd, as the reference sums its transpose in
// float32.  For bfloat16 features a second kernel casts the whole
// table once into the bfloat16 gradient.  Atomics make the order of
// the sums vary from run to run, so results agree with the plain
// version to rounding, not bit for bit.
//
// What bounds it on an H100: memory traffic and the atomics.  The
// bytes are grad_out (read once), the float32 table (memset, atomics
// that mostly hit L2, then read once by the cast) and the bfloat16
// gradient (written once); at the train path's shapes (2 x 512 rois,
// C = 256, 7x7) there are up to 4 x 4 x 49 x 256 ~ 200k float atomic
// adds per roi, ~2e8 in all, which the L2's atomic units absorb at a
// rate of the same order as the byte traffic.  Measured times: PERF.md.
//
// Design: K1's grid.  One block takes one (roi, bin row) pair;
// threadIdx.y is the bin column.  Each thread computes a sample's
// corners and weights once, then threadIdx.x walks the channels one by
// one, so that every atomic instruction of a warp adds into 32
// consecutive floats of one corner cell (one 128-byte line; lanes
// holding 16-byte vectors, as K1's loads do, would spread one
// instruction over eight lines).  No shared memory, no sort.  Staging
// a roi's window in shared memory before the atomics, vector atomics,
// or sorting rois by level and position, is later work.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;

struct Tables {
  float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int stride[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void roi_align_backward_kernel(Tables tb, int channels,
                                          const float* __restrict__ rois,
                                          const int* __restrict__ bidx,
                                          const int* __restrict__ lvls,
                                          int out_size, int ratio,
                                          int aligned,
                                          const T* __restrict__ grad_out) {
  const int k = blockIdx.x / out_size;
  const int py = blockIdx.x % out_size;
  const int px = threadIdx.y;

  const int l = lvls[k];
  const int height = tb.h[l];
  const int width = tb.w[l];
  const float inv = 1.0f / static_cast<float>(tb.stride[l]);
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

  float* table = tb.ptr[l] +
                 static_cast<size_t>(bidx[k]) * height * width * channels;
  const T* src = grad_out + (static_cast<size_t>(k) * out_size * out_size +
                             static_cast<size_t>(py) * out_size + px) *
                                channels;
  const float inv_count = 1.0f / static_cast<float>(ratio * ratio);

  for (int iy = 0; iy < ratio; ++iy) {
    const float gy = (static_cast<float>(py * ratio + iy) + 0.5f) / ratio;
    const float ys = y1 + gy * bin_h;
    if (ys < -1.0f || ys > fh) continue;
    const float y = fminf(fmaxf(ys, 0.0f), fh - 1.0f);
    const int y0 = static_cast<int>(floorf(y));
    const int y1i = min(y0 + 1, height - 1);
    const float ly = y - static_cast<float>(y0);
    const float hy = 1.0f - ly;
    for (int ix = 0; ix < ratio; ++ix) {
      const float gx = (static_cast<float>(px * ratio + ix) + 0.5f) / ratio;
      const float xs = x1 + gx * bin_w;
      if (xs < -1.0f || xs > fw) continue;
      const float x = fminf(fmaxf(xs, 0.0f), fw - 1.0f);
      const int x0 = static_cast<int>(floorf(x));
      const int x1i = min(x0 + 1, width - 1);
      const float lx = x - static_cast<float>(x0);
      const float hx = 1.0f - lx;
      float* p00 = table + (static_cast<size_t>(y0) * width + x0) * channels;
      float* p01 = table + (static_cast<size_t>(y0) * width + x1i) * channels;
      float* p10 = table + (static_cast<size_t>(y1i) * width + x0) * channels;
      float* p11 = table + (static_cast<size_t>(y1i) * width + x1i) * channels;
      const float w00 = hy * hx * inv_count;
      const float w01 = hy * lx * inv_count;
      const float w10 = ly * hx * inv_count;
      const float w11 = ly * lx * inv_count;
      // lanes on consecutive channels: each atomic instruction of a
      // warp covers one contiguous run of 32 floats
      for (int c = threadIdx.x; c < channels; c += blockDim.x) {
        const float g = to_float(src[c]);
        atomicAdd(p00 + c, w00 * g);
        atomicAdd(p01 + c, w01 * g);
        atomicAdd(p10 + c, w10 * g);
        atomicAdd(p11 + c, w11 * g);
      }
    }
  }
}

// table (float32) -> out (bfloat16), 8 values per thread; n % 8 == 0
__global__ void cast_to_bf16_kernel(const float* __restrict__ table,
                                    __nv_bfloat16* __restrict__ out,
                                    size_t n8) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n8; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(table)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(table)[2 * i + 1];
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(a.x, a.y);
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    reinterpret_cast<uint4*>(out)[i] = q;
  }
}

template <typename T>
int launch(const Tables& tb, int channels, const float* rois,
           const int* bidx, const int* lvls, int num_rois, int out_size,
           int ratio, int aligned, const void* grad_out,
           cudaStream_t stream) {
  const dim3 block(channels < 32 ? channels : 32, out_size);
  const dim3 grid(num_rois * out_size);
  roi_align_backward_kernel<T><<<grid, block, 0, stream>>>(
      tb, channels, rois, bidx, lvls, out_size, ratio, aligned,
      static_cast<const T*>(grad_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the dtype of grad_out and of the
// features' gradient.  table is one float32 buffer of table_elems
// values holding the levels' [B, H_l, W_l, C] tables back to back, in
// level order; it is zeroed here.  grad_feats: for bfloat16, a buffer
// of table_elems bfloat16 values that receives the cast table (laid
// out as the table); for float32, null (the table is the gradient).
// h*, w*, st*: the levels' sizes and strides in pixels.  rois [K, 4]
// float32, bidx and lvls [K] int32, grad_out [K, out_size, out_size, C].
// All device pointers 16-byte aligned and C a multiple of the 16-byte
// vector width; the Python wrapper checks both.  device is the CUDA
// ordinal the tensors and the stream belong to.  Returns the first
// CUDA error of the memset and the launches, or cudaErrorInvalidValue
// for arguments it cannot take.
extern "C" int aidet_roi_align_backward(
    int device, int dtype, void* table, long long table_elems,
    void* grad_feats, int h0, int w0, int h1, int w1, int h2, int w2,
    int h3, int w3, int st0, int st1, int st2, int st3, int num_levels,
    int batch, int channels, const void* rois, const void* bidx,
    const void* lvls, int num_rois, int out_size, int sampling_ratio,
    int aligned, const void* grad_out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      out_size > 32 || sampling_ratio < 1 || channels < 1 || num_rois < 0 ||
      batch < 1 || table_elems < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the bfloat16 cast converts 8 values per thread
  if ((dtype == 1 && (channels % 8 || grad_feats == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int sts[kMaxLevels] = {st0, st1, st2, st3};
  Tables tb;
  long long off = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    tb.ptr[i] = static_cast<float*>(table) + off;
    tb.h[i] = hs[i];
    tb.w[i] = ws[i];
    tb.stride[i] = sts[i];
    if (i < num_levels) {
      off += static_cast<long long>(batch) * hs[i] * ws[i] * channels;
    }
  }
  if (off != table_elems) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is
  // not the caller's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(table, 0, static_cast<size_t>(table_elems) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rois > 0) {
    const float* r = static_cast<const float*>(rois);
    const int* b = static_cast<const int*>(bidx);
    const int* l = static_cast<const int*>(lvls);
    const int rc = dtype == 1
        ? launch<__nv_bfloat16>(tb, channels, r, b, l, num_rois, out_size,
                                sampling_ratio, aligned, grad_out, s)
        : launch<float>(tb, channels, r, b, l, num_rois, out_size,
                        sampling_ratio, aligned, grad_out, s);
    if (rc != 0) return rc;
  }
  if (dtype == 1 && table_elems > 0) {
    const size_t n8 = static_cast<size_t>(table_elems) / 8;
    const int threads = 256;
    const size_t want = (n8 + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 65536 ? want : 65536);
    cast_to_bf16_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(table),
        static_cast<__nv_bfloat16*>(grad_feats), n8);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
