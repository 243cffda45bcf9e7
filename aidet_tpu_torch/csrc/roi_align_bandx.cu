// Band-chunked multi-level aligned RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel aidet_tpu/ops/roi_align_bandx.py::
// roi_align_bandx (its pallas_call and _kernel), the opt-in
// (AIDET_ROI_BAND=x) RoIAlign of bf16 predict.  It computes the same
// function as K1 (roi_align.cu): for each roi k (routed to level lvl[k]
// of image bidx[k] by the caller) and each of the out_size x out_size
// bins, the mean of ratio^2 aligned bilinear samples of the level's
// NHWC map over all C channels; a sample with y < -1, y > H, x < -1 or
// x > W contributes 0, the others are clamped to the map.  Output
// [K, out_size, out_size, C] in the caller's roi order.
//
// What makes it K3: the caller (aidet_tpu_torch/ops/roi_align.py::
// bandx_chunks) sorts the rois by an (image, level, 16-row band) key,
// the band of the roi's first sample row, with a stable argsort, and
// cuts each key's run into chunks of at most 128 / out_size rois.  One
// block takes one chunk: it stages the chunk's 48-row band of the
// level (rows row0 .. row0 + 47, every column up to stage_w) into
// shared memory once per 16-byte channel slice, and reduces every roi
// of the chunk out of shared memory with separable weights, x first
// then y, in f32:
//   t(y) = sum over the bin column's x samples and their 2 corners of
//          w_x * band[y][x]                    (one row, one bin column)
//   out[py][px] = sum over bin row py's y samples of
//                 (1 - ly) t(y0) + ly t(y1), over ratio^2.
// The rows of the y samples rise monotonically, so a thread keeps the
// t of the last two rows and computes each row's t once per bin
// column, not once per sample.  A roi whose samples reach beyond the
// staged band (without the TPU kernel's window bump, a tall roi on a
// fine level can span more than 48 rows; columns beyond stage_w on wide
// levels) reads those cells from global memory through the same
// generic load; the function stays the caller's.
//
// What bounds it on an H100: memory, in a different way than K1.  The
// staging reads the whole band of every chunk (48 x W x C values; at
// level 0 of a 1024^2 input 6.3 MB of bf16 for up to 18 rois), which
// is more than the rois need, but reads it once, in coalesced 16-byte
// cp.async copies, and the samples then hit shared memory.  The stage
// of 48 x 256 cells x 16 bytes (196,608 bytes) allows one block per SM.
// Measured times: PERF.md.
//
// What does not carry over from the TPU kernel: its x-major [B, W, H,
// C] transpose of the pyramid and its block-diagonal Wy products serve
// the MXU, and its chunk-granular grid serves the sequential TPU grid;
// here the band keeps the NHWC layout, and the threads of a block own
// (roi, bin column, 8-byte channel half) triples.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include "roi_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 48;

// One 8-byte vector (2 float32 or 4 bfloat16 channels), loaded through
// a generic pointer, so that one instruction reads from shared or from
// global memory.
template <typename T>
struct Half;

template <>
struct Half<float> {
  static constexpr int kN = 2;
  __device__ static void fma_load(const float* p, float wgt, float* acc) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    acc[0] += wgt * q.x;
    acc[1] += wgt * q.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct Half<__nv_bfloat16> {
  static constexpr int kN = 4;
  __device__ static void fma_load(const __nv_bfloat16* p, float wgt,
                                  float* acc) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += wgt * f.x;
      acc[2 * i + 1] += wgt * f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One bin column's x samples of one row: the 8-byte channel half at
// (row y, column x) lies in the staged band when the row and column
// were staged, else in global memory.
template <typename T>
struct RowReader {
  const uint4* band;   // [rows][stage_cols] 16-byte cells
  const T* feat;       // the image's level map [H, W, C]
  int row0, rows, stage_cols, width, channels, c0, half;

  __device__ const T* cell(int y, int x) const {
    const int yr = y - row0;
    if (yr >= 0 && yr < rows && x < stage_cols) {
      return reinterpret_cast<const T*>(band + yr * stage_cols + x) +
             half * Half<T>::kN;
    }
    return feat + (static_cast<size_t>(y) * width + x) * channels + c0 +
           half * Half<T>::kN;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_bandx_kernel(Levels lv, int channels,
                           const float* __restrict__ rois,
                           const int* __restrict__ bidx,
                           const int* __restrict__ lvls,
                           const int* __restrict__ perm,
                           const int* __restrict__ chunk_start,
                           const int* __restrict__ chunk_count,
                           const int* __restrict__ chunk_row0,
                           int stage_w, int out_size, int ratio,
                           int aligned, T* __restrict__ out) {
  constexpr int V = Vec<T>::kN;       // channels per 16-byte band cell
  constexpr int H = Half<T>::kN;      // channels per thread
  extern __shared__ uint4 band[];

  const int count = chunk_count[blockIdx.x];
  if (count == 0) return;
  const int start = chunk_start[blockIdx.x];
  const int row0 = chunk_row0[blockIdx.x];
  const int first = perm[start];
  const int l = lvls[first];
  const int height = lv.h[l];
  const int width = lv.w[l];
  const int rows = min(kBandRows, height - row0);
  const int stage_cols = min(width, stage_w);
  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(bidx[first]) * height * width *
                      channels;

  // this thread's (roi of the chunk, bin column, channel half)
  const int t = threadIdx.x;
  const int r = t / (2 * out_size);
  const int px = (t / 2) % out_size;
  const int half = t % 2;
  const bool active = r < count;
  const int k = active ? perm[start + r] : first;

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
  const float inv_count = 1.0f / static_cast<float>(ratio * ratio);
  const int cells = rows * stage_cols;

  for (int c0 = 0; c0 < channels; c0 += V) {
    // stage the band's channel slice [c0, c0 + V)
    for (int i = t; i < cells; i += kThreads) {
      const int y = i / stage_cols;
      const int x = i - y * stage_cols;
      cp_async16(band + i,
                 feat + (static_cast<size_t>(row0 + y) * width + x) *
                            channels + c0);
    }
    cp_async_wait_all();
    __syncthreads();

    if (active) {
      const RowReader<T> rd{band, feat, row0, rows, stage_cols, width,
                            channels, c0, half};
      // t of one row for this bin column: x samples, 2 corners each
      auto row_t = [&](int y, float* acc) {
#pragma unroll
        for (int j = 0; j < H; ++j) acc[j] = 0.0f;
        for (int ix = 0; ix < ratio; ++ix) {
          const float gx =
              (static_cast<float>(px * ratio + ix) + 0.5f) / ratio;
          const float xs = x1 + gx * bin_w;
          if (xs < -1.0f || xs > fw) continue;
          const float x = fminf(fmaxf(xs, 0.0f), fw - 1.0f);
          const int x0 = static_cast<int>(floorf(x));
          const int x1i = min(x0 + 1, width - 1);
          const float lx = x - static_cast<float>(x0);
          Half<T>::fma_load(rd.cell(y, x0), 1.0f - lx, acc);
          Half<T>::fma_load(rd.cell(y, x1i), lx, acc);
        }
      };
      float ta[H], tb[H];
      int ra = -1, rb = -1;
      T* dst = out + (static_cast<size_t>(k) * out_size * out_size + px) *
                         channels + c0 + half * H;
      for (int py = 0; py < out_size; ++py) {
        float acc[H];
#pragma unroll
        for (int j = 0; j < H; ++j) acc[j] = 0.0f;
        for (int iy = 0; iy < ratio; ++iy) {
          const float gy =
              (static_cast<float>(py * ratio + iy) + 0.5f) / ratio;
          const float ys = y1 + gy * bin_h;
          if (ys < -1.0f || ys > fh) continue;
          const float y = fminf(fmaxf(ys, 0.0f), fh - 1.0f);
          const int y0 = static_cast<int>(floorf(y));
          const int y1i = min(y0 + 1, height - 1);
          const float ly = y - static_cast<float>(y0);
          if (y0 != ra) {
            if (y0 == rb) {
#pragma unroll
              for (int j = 0; j < H; ++j) ta[j] = tb[j];
            } else {
              row_t(y0, ta);
            }
            ra = y0;
          }
          if (y1i != rb) {
            if (y1i == ra) {
#pragma unroll
              for (int j = 0; j < H; ++j) tb[j] = ta[j];
            } else {
              row_t(y1i, tb);
            }
            rb = y1i;
          }
#pragma unroll
          for (int j = 0; j < H; ++j) {
            acc[j] += (1.0f - ly) * ta[j] + ly * tb[j];
          }
        }
#pragma unroll
        for (int j = 0; j < H; ++j) acc[j] *= inv_count;
        Half<T>::store(dst + static_cast<size_t>(py) * out_size * channels,
                       acc);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const Levels& lv, int channels, const float* rois,
           const int* bidx, const int* lvls, const int* perm,
           const int* chunk_start, const int* chunk_count,
           const int* chunk_row0, int num_chunks, int stage_w,
           int smem_bytes, int out_size, int ratio, int aligned, void* out,
           cudaStream_t stream) {
  if (channels % Vec<T>::kN) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      roi_align_bandx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  roi_align_bandx_kernel<T><<<num_chunks, kThreads, smem_bytes, stream>>>(
      lv, channels, rois, bidx, lvls, perm, chunk_start, chunk_count,
      chunk_row0, stage_w, out_size, ratio, aligned, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  f0..f3 are the level maps
// [B, H_l, W_l, C] (unused ones may be null), st* their strides in
// pixels.  rois [K, 4] float32, bidx and lvls [K] int32, all in the
// caller's order; perm [K] int32, the caller's roi index of each sorted
// position; chunk_start, chunk_count and chunk_row0 [num_chunks] int32:
// a chunk's first sorted position, its roi count (0 for an unused
// chunk, at most 128 / out_size) and its band's first row.  stage_w
// columns of at most 48 rows are staged (smem_bytes = 48 * stage_w * 16
// at most, which the caller sizes for the pyramid).  out [K, out_size,
// out_size, C] of the feature dtype.  All device pointers 16-byte
// aligned and C a multiple of the 16-byte vector width; the Python
// wrapper checks both.  device is the CUDA ordinal the tensors and the
// stream belong to.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int aidet_roi_align_bandx_forward(
    int device, int dtype, const void* f0, const void* f1, const void* f2,
    const void* f3, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
    int w3, int st0, int st1, int st2, int st3, int num_levels,
    int channels, const void* rois, const void* bidx, const void* lvls,
    int num_rois, const void* perm, const void* chunk_start,
    const void* chunk_count, const void* chunk_row0, int num_chunks,
    int stage_w, int smem_bytes, int out_size, int sampling_ratio,
    int aligned, void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      2 * out_size > kThreads || sampling_ratio < 1 || channels < 1 ||
      num_rois < 0 || num_chunks < 0 || stage_w < 1 ||
      smem_bytes < 16 * stage_w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0 || num_chunks == 0) return 0;
  // this library links its own CUDA runtime, whose current device is
  // not the caller's
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Levels lv = make_levels(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3,
                                w3, st0, st1, st2, st3);
  const float* r = static_cast<const float*>(rois);
  const int* b = static_cast<const int*>(bidx);
  const int* l = static_cast<const int*>(lvls);
  const int* p = static_cast<const int*>(perm);
  const int* cs = static_cast<const int*>(chunk_start);
  const int* cc = static_cast<const int*>(chunk_count);
  const int* cr = static_cast<const int*>(chunk_row0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(lv, channels, r, b, l, p, cs, cc, cr,
                                 num_chunks, stage_w, smem_bytes, out_size,
                                 sampling_ratio, aligned, out, s);
  }
  if (dtype == 0) {
    return launch<float>(lv, channels, r, b, l, p, cs, cc, cr, num_chunks,
                         stage_w, smem_bytes, out_size, sampling_ratio,
                         aligned, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
