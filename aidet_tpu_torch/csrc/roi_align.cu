// Multi-level aligned RoIAlign forward for Hopper (sm_90a).
//
// Replaces the TPU kernel aidet_tpu/ops/roi_align_band.py::roi_align_band
// (its pallas_call and _kernel), the default RoIAlign of bf16 predict,
// and is the forward of K2 (aidet_tpu/ops/roi_align_pallas.py).
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
// What bounds it on an H100: memory in principle (each output element
// costs 4 * ratio^2 corner reads and as many FMAs, far below the ridge
// of ~295 bf16 FLOP per byte of HBM); at the paths' shapes, the issue
// rate of its loads and FMAs.  Gathering the 4 corners of every sample
// asks for 16 x 16 bytes per output vector at ratio 2, 3.3x (7x7) to
// 11x (14x14) the cells of the rois' windows.  Staging each window
// once saves those requests; at 7x7 it costs about as many
// instructions as the gathers.  Measured times, and the variants that
// show where the time goes: PERF.md.
//
// Design: one block per (roi, slice of up to 16 16-byte channel
// vectors); threadIdx.x is the vector, threadIdx.y the bin column.
// - Plan.  The sample rows of a roi are a monotone sequence, and so are
//   their clamped corner rows; warp 0 walks them in increasing y and
//   lists the distinct rows (at most 2 * out_size * ratio) with a
//   ballot, giving every sample row the list index of its two corners
//   and their weights (1/ratio^2 folded in); then the columns.  A
//   sample outside the map gets index -1.  The cells the roi reads are
//   exactly (distinct rows) x (distinct columns), since a sample is
//   inside the map when its row and its column are.
// - Stage.  The window is walked in tiles of at most `cap` cells: whole
//   rows, several at a time when they fit, else one row cut into column
//   stripes.  Each tile is copied once into shared memory with 16-byte
//   cp.async, coalesced along the channels, through a ring of kStages
//   buffers: the copies of the next kStages - 1 tiles are in flight
//   while a tile is reduced, one barrier per tile (two buffers of 8 KB
//   measured fastest: smaller rings let more blocks share an SM).
//   Every distinct cell of the window is loaded once per block.
// - Reduce x, then y.  For each staged row, thread (vector, px) sums
//   its bin column's 2 * ratio weighted corners into X[row][px], kept in
//   a ring of 2 * ratio rows of shared memory that only this thread
//   touches.  As soon as the last row a bin row reads is done (rows come
//   in increasing y and a bin row spans at most 2 * ratio of them) the
//   thread sums the bin's y-weighted X rows and writes the output
//   vector, once.
// No atomics, no global scratch.  A roi of any size or aspect takes the
// same path: only its tile count grows.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include "roi_common.cuh"

namespace {

constexpr int kMaxLanes = 16;            // 16-byte vectors per block
constexpr int kMaxThreads = 512;
constexpr int kMaxSamples = 1024;        // out_size * sampling_ratio
constexpr int kStages = 2;               // tile buffers in flight
constexpr int kStageBytes = 8 * 1024;    // one tile buffer
constexpr int kMaxSmem = 227 * 1024;     // an H100 block's shared memory

// 8 bfloat16 or 4 float32 channels of a staged 16-byte cell, weighted
template <typename T>
struct Cell;

template <>
struct Cell<float> {
  __device__ static void fma(const uint4& q, float w, float* acc) {
    const float4 f = *reinterpret_cast<const float4*>(&q);
    acc[0] += w * f.x;
    acc[1] += w * f.y;
    acc[2] += w * f.z;
    acc[3] += w * f.w;
  }
};

template <>
struct Cell<__nv_bfloat16> {
  __device__ static void fma(const uint4& q, float w, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += w * f.x;
      acc[2 * i + 1] += w * f.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One axis of a roi's plan, by the first `width` threads of warp 0:
// the n samples at start + (m + 0.5) / ratio * bin (m = 0..n-1),
// walked in increasing coordinate.  Lists the distinct clamped corners
// (sorted) in list[0..*count) and gives sample m the list index of its
// two corners in idx[m], idx[n + m] (-1 for a sample outside
// [-1, size]) and their weights, times scale, in w[m], w[n + m].  The
// corners are monotone in the walk and the samples inside the map
// consecutive, so a corner is new when it exceeds the previous sample's
// far corner (the largest listed so far), and a corner that is not new
// is that one or the one listed before it.  Lanes take 32 samples at a
// time and place the new corners with a ballot.
__device__ void plan_axis(float start, float bin, int ratio, int n,
                          int size, float scale, int width, int* list,
                          short* idx, float* w, int* count) {
  const int lane = threadIdx.x + threadIdx.y * blockDim.x;
  const unsigned mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
  const bool rev = bin < 0.0f;
  const float fsize = static_cast<float>(size);
  int listed = 0;    // corners listed by earlier chunks
  int last = -1;     // the largest of them (-1: none yet)
  for (int t0 = 0; t0 < n; t0 += width) {
    const int t = t0 + lane;
    const int m = rev ? n - 1 - t : t;
    bool inside = false;
    int c0 = 0, c1 = 0;
    float l = 0.0f;
    if (t < n) {
      const float g = (static_cast<float>(m) + 0.5f) / ratio;
      const float p = start + g * bin;
      inside = p >= -1.0f && p <= fsize;
      const float c = fminf(fmaxf(p, 0.0f), fsize - 1.0f);
      c0 = static_cast<int>(floorf(c));
      c1 = min(c0 + 1, size - 1);
      l = c - static_cast<float>(c0);
    }
    // the far corner of the previous sample of the walk, if inside
    int prev = __shfl_up_sync(mask, inside ? c1 : -1, 1);
    if (lane == 0) prev = last;
    const bool new0 = inside && c0 > prev;
    const bool new1 = inside && c1 > max(c0, prev);
    const unsigned below = (1u << lane) - 1u;
    const unsigned b0 = __ballot_sync(mask, new0);
    const unsigned b1 = __ballot_sync(mask, new1);
    const int before = listed + __popc(b0 & below) + __popc(b1 & below);
    if (t < n) {
      if (inside) {
        const int i0 = new0 ? before : (c0 == prev ? before - 1 : before - 2);
        if (new0) list[before] = c0;
        if (new1) list[before + new0] = c1;
        idx[m] = static_cast<short>(i0);
        idx[n + m] = static_cast<short>(c1 == c0 ? i0 : i0 + 1);
        w[m] = (1.0f - l) * scale;
        w[n + m] = l * scale;
      } else {
        idx[m] = -1;
        idx[n + m] = -1;
        w[m] = 0.0f;
        w[n + m] = 0.0f;
      }
    }
    listed += __popc(b0) + __popc(b1);
    const int top = 31 - __clz(mask);
    const int edge = __shfl_sync(mask, inside ? c1 : -1, top);
    last = edge >= 0 ? edge : last;
  }
  if (lane == 0) *count = listed;
}

// Rows of X kept: a bin row reads at most 2 * ratio listed rows; a
// power of two, so that a row's slot is a mask of its index
__host__ __device__ inline int ring_rows(int ratio) {
  int r = 1;
  while (r < 2 * ratio) r *= 2;
  return r;
}

// Bytes of dynamic shared memory of a launch (host and device agree)
struct Layout {
  int stage, ring, geom, total;
};

__host__ __device__ inline Layout layout(int n, int out_size, int ratio,
                                         int lanes, int cap, int vec) {
  Layout s;
  s.stage = kStages * cap * lanes * 16;
  s.ring = ring_rows(ratio) * out_size * lanes * vec * 4;
  // wy, wx: 2n floats each; rows, cols: 2n ints each; ry, cx: 2n shorts
  s.geom = 2 * n * (4 + 4 + 4 + 4 + 2 + 2);
  s.total = s.stage + s.ring + s.geom;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_kernel(Levels lv, int channels, const float* __restrict__ rois,
                     const int* __restrict__ bidx,
                     const int* __restrict__ lvls, int out_size, int ratio,
                     int aligned, int cap, T* __restrict__ out) {
  constexpr int V = Vec<T>::kN;
  constexpr int Q = V / 4;   // float4s of f32 sums per vector
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_rows, s_cols;
  __shared__ short s_hi[32];

  const int k = blockIdx.x;
  const int lanes = blockDim.x;
  const int lane = threadIdx.x;
  const int px = threadIdx.y;
  const int tid = threadIdx.y * lanes + lane;
  const int nthreads = lanes * out_size;
  const int n = out_size * ratio;
  const int ring_mask = ring_rows(ratio) - 1;
  const int vec = blockIdx.y * lanes + lane;
  const bool active = vec < channels / V;

  const Layout sz = layout(n, out_size, ratio, lanes, cap, V);
  uint4* stage = reinterpret_cast<uint4*>(smem);   // [kStages][cap][lanes]
  float4* xring = reinterpret_cast<float4*>(smem + sz.stage);
  float* wy = reinterpret_cast<float*>(smem + sz.stage + sz.ring);
  float* wx = wy + 2 * n;
  int* rows = reinterpret_cast<int*>(wx + 2 * n);
  int* cols = rows + 2 * n;
  short* ry = reinterpret_cast<short*>(cols + 2 * n);
  short* cx = ry + 2 * n;

  // the roi's level, read with constant indices: an index computed at
  // run time copies the parameter struct to local memory in every
  // thread (6% of the kernel's time at the paths' shapes)
  const int l = lvls[k];
  int height = lv.h[0], width = lv.w[0], stride = lv.stride[0];
  const void* level_ptr = lv.ptr[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (l == i) {
      height = lv.h[i];
      width = lv.w[i];
      stride = lv.stride[i];
      level_ptr = lv.ptr[i];
    }
  }
  const float inv = 1.0f / static_cast<float>(stride);
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
  const bool rev = bin_h < 0.0f;   // y order of the bin rows

  const int plan_width = min(32, nthreads);
  if (tid < plan_width) {
    plan_axis(y1, bin_h, ratio, n, height,
              1.0f / static_cast<float>(ratio * ratio), plan_width, rows, ry,
              wy, &s_rows);
    plan_axis(x1, bin_w, ratio, n, width, 1.0f, plan_width, cols, cx, wx,
              &s_cols);
  }
  __syncthreads();
  if (tid < out_size) {   // the last listed row each bin row reads
    int hi = -1;
    for (int iy = 0; iy < ratio; ++iy) {
      hi = max(hi, static_cast<int>(ry[n + tid * ratio + iy]));
    }
    s_hi[tid] = static_cast<short>(hi);
  }
  __syncthreads();
  const int nrows = s_rows;
  const int ncols = s_cols;

  const T* feat = static_cast<const T*>(level_ptr) +
                  static_cast<size_t>(bidx[k]) * height * width * channels;
  T* dst = out + (static_cast<size_t>(k) * out_size * out_size + px) *
                     channels + static_cast<size_t>(vec) * V;
  const size_t row_step = static_cast<size_t>(out_size) * channels;

  // the bin row at y-order position b, from the ring
  auto finish = [=](int b) {
    const int py = rev ? out_size - 1 - b : b;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    for (int iy = 0; iy < ratio; ++iy) {
      const int m = py * ratio + iy;
      const int r0 = ry[m];
      if (r0 < 0) continue;
      const int r1 = ry[n + m];
      const float w0 = wy[m], w1 = wy[n + m];
      const float4* x0 =
          xring + ((r0 & ring_mask) * out_size + px) * Q * lanes;
      const float4* x1p =
          xring + ((r1 & ring_mask) * out_size + px) * Q * lanes;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 a = x0[q * lanes + lane];
        const float4 c = x1p[q * lanes + lane];
        acc[4 * q + 0] += w0 * a.x + w1 * c.x;
        acc[4 * q + 1] += w0 * a.y + w1 * c.y;
        acc[4 * q + 2] += w0 * a.z + w1 * c.z;
        acc[4 * q + 3] += w0 * a.w + w1 * c.w;
      }
    }
    if (active) Vec<T>::store(dst + py * row_step, acc);
  };

  if (nrows == 0 || ncols == 0) {   // every sample outside the map
    float zero[V];
#pragma unroll
    for (int j = 0; j < V; ++j) zero[j] = 0.0f;
    for (int py = 0; py < out_size && active; ++py) {
      Vec<T>::store(dst + py * row_step, zero);
    }
    return;
  }

  // tiles: rows_per cells-wide rows, or one row in stripes of cap cells
  const int rows_per = ncols <= cap ? cap / ncols : 1;
  const int stripes = ncols <= cap ? 1 : (ncols + cap - 1) / cap;
  const int tile_w = ncols <= cap ? ncols : cap;
  const int ntiles = ((nrows + rows_per - 1) / rows_per) * stripes;
  const int vec0 = blockIdx.y * lanes;
  const int nvec = min(lanes, channels / V - vec0);

  auto load = [=](int t, int buf) {
    const int q0 = (t / stripes) * rows_per;
    const int s0 = (t - (t / stripes) * stripes) * cap;
    const int nr = min(rows_per, nrows - q0);
    const int ns = min(tile_w, ncols - s0);
    uint4* b = stage + buf * cap * lanes;
    if (lane < nvec) {
      // thread (lane, px) copies vector `lane` of cells px, px +
      // out_size, ... of the tile (row rr, column cc of the cell)
      int rr = 0, cc = px;
      while (cc >= ns) {
        cc -= ns;
        ++rr;
      }
      const T* src = feat + static_cast<size_t>(vec0 + lane) * V;
      for (int cell = px; cell < nr * ns; cell += out_size) {
        cp_async16(b + cell * lanes + lane,
                   src + (static_cast<size_t>(rows[q0 + rr]) * width +
                          cols[s0 + cc]) * channels);
        cc += out_size;
        while (cc >= ns) {
          cc -= ns;
          ++rr;
        }
      }
    }
    cp_async_commit();
  };

  // kStages - 1 tiles in flight ahead of the one being reduced; every
  // thread commits one (possibly empty) group per tile slot
  for (int f = 0; f < kStages - 1; ++f) {
    if (f < ntiles) {
      load(f, f);
    } else {
      cp_async_commit();
    }
  }
  int next = 0;   // the next bin row to finish, in y order
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t
    // all copies of tile t landed, and every thread is done with tile
    // t - 1, whose buffer the next load refills
    __syncthreads();
    const int f = t + kStages - 1;
    if (f < ntiles) {
      load(f, f % kStages);
    } else {
      cp_async_commit();
    }
    const uint4* b = stage + (t % kStages) * cap * lanes;
    const int q0 = (t / stripes) * rows_per;
    const int s0 = (t % stripes) * cap;
    const int nr = min(rows_per, nrows - q0);
    const int ns = min(tile_w, ncols - s0);
    for (int rl = 0; rl < nr; ++rl) {
      const int q = q0 + rl;
      float4* xr = xring + ((q & ring_mask) * out_size + px) * Q * lanes;
      float acc[V];
      if (s0 == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.0f;
      } else {
#pragma unroll
        for (int q4 = 0; q4 < Q; ++q4) {
          const float4 a = xr[q4 * lanes + lane];
          acc[4 * q4 + 0] = a.x;
          acc[4 * q4 + 1] = a.y;
          acc[4 * q4 + 2] = a.z;
          acc[4 * q4 + 3] = a.w;
        }
      }
      if (active) {
        for (int ix = 0; ix < ratio; ++ix) {
          const int m = px * ratio + ix;
#pragma unroll
          for (int corner = 0; corner < 2; ++corner) {
            const int c = cx[corner * n + m] - s0;
            if (c < 0 || c >= ns) continue;   // outside the map or stripe
            Cell<T>::fma(b[(rl * ns + c) * lanes + lane],
                         wx[corner * n + m], acc);
          }
        }
      }
#pragma unroll
      for (int q4 = 0; q4 < Q; ++q4) {
        xr[q4 * lanes + lane] = make_float4(acc[4 * q4], acc[4 * q4 + 1],
                                            acc[4 * q4 + 2], acc[4 * q4 + 3]);
      }
      if (s0 + ns == ncols) {   // row q is complete
        while (next < out_size) {
          const int hi = s_hi[rev ? out_size - 1 - next : next];
          if (hi > q) break;
          finish(next++);
        }
      }
    }
  }
  while (next < out_size) finish(next++);
}

template <typename T>
int launch(const Levels& lv, int channels, const float* rois,
           const int* bidx, const int* lvls, int num_rois, int out_size,
           int ratio, int aligned, void* out, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  if (channels % V) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = channels / V;
  const int n = out_size * ratio;
  // the widest channel slice whose ring and tiles fit a block
  int lanes = min(min(nvec, kMaxLanes), kMaxThreads / out_size);
  int cap = 0;
  Layout sz;
  for (;;) {
    cap = kStageBytes / (lanes * 16);
    sz = layout(n, out_size, ratio, lanes, cap, V);
    if (sz.total <= kMaxSmem) break;
    if (lanes == 1) return static_cast<int>(cudaErrorInvalidValue);
    lanes = (lanes + 1) / 2;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      roi_align_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sz.total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 block(lanes, out_size);
  const dim3 grid(num_rois, (nvec + lanes - 1) / lanes);
  roi_align_kernel<T><<<grid, block, sz.total, stream>>>(
      lv, channels, rois, bidx, lvls, out_size, ratio, aligned, cap,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  f0..f3 are the level maps
// [B, H_l, W_l, C] (unused ones may be null), st* their strides in
// pixels.  rois [K, 4] float32, bidx and lvls [K] int32, out
// [K, out_size, out_size, C] of the feature dtype.  All device pointers
// 16-byte aligned and C a multiple of the 16-byte vector width; the
// Python wrapper checks both.  out_size is at most 32 and out_size *
// sampling_ratio at most 1024.  device is the CUDA ordinal the tensors
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
      out_size > 32 || sampling_ratio < 1 ||
      out_size * sampling_ratio > kMaxSamples || channels < 1 ||
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
  const float* r = static_cast<const float*>(rois);
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
