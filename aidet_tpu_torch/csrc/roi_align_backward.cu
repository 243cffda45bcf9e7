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
// (y0 == y1 at the last row) that cell receives both weights.  Sums are
// float32; the gradient is written in grad_out's dtype.  The gradient
// with respect to the rois is zero (the reference's _bwd returns
// zeros); the caller returns None for it.
//
// What bounds it on an H100: memory.  The function reads grad_out once
// and writes the whole pyramid's gradient once (zeros included); at the
// train path's shapes (2 x 512 rois, C = 256, 7x7, levels 256^2..32^2)
// that is 26 MB and 89 MB in bfloat16.  A scatter with float atomics
// into a zeroed float32 table adds a full-size table's memset, its
// read-modify-writes in L2 (2e8 atomic adds) and, for bfloat16, a cast
// pass: 3x the bytes the function needs, and the atomics' rate besides.
// Measured times, and the variants that led to this design: PERF.md.
//
// Design: a gather, tile by tile, in shared memory.
// 1. Binning.  Each level's [B, H, W] cells are cut into 4x4-cell
//    tiles.  One thread per (roi, bin) finds the tiles the corners of
//    the bin's samples fall in (its distinct tile rows times its
//    distinct tile columns, as the samples form a grid) and counts one
//    entry for each with an integer atomic; each warp of a pass over
//    the tiles places 32 lists at once, one atomic on the running total
//    (lists are contiguous, in no fixed order); the same threads then
//    fill each tile's list with their bin index (roi * out_size^2 +
//    bin).  The lists live in a scratch buffer sized by the upper
//    bound 4 * K * n^2 entries (n = out_size * ratio), so no count goes
//    back to the host.
// 2. Accumulate.  One warp per (tile, 32 16-byte channel vectors, 256
//    bfloat16 or 128 float32 channels): lane j owns vector j of all 16
//    cells, float32 sums in shared memory (16 KB in bfloat16) that no
//    other thread touches, so it adds without atomics.  For 32 entries
//    at a time, lane j computes entry j's weights on the tile's 4 rows
//    and 4 columns (a bin's samples are a grid, so cell (y, x) gets
//    wy[y] * wx[x] of the bin's gradient, every corner summed); the
//    warp then takes the entries kInFlight at a time: every lane loads
//    its 16 bytes of each entry's grad_out bin (512 bytes a warp, the
//    next group's loads issued before this group's sums), receives the
//    weights by shuffles and adds the weighted vector into each cell
//    with weight, one read-modify-write per cell and bin.  A bin's
//    grad_out is read once per tile it touches (about 2.2 times at the
//    train path's shapes), not once per sample.  Then the warp writes
//    the whole tile once, in the gradient's dtype, zeros where no
//    sample fell.
// No float atomics, no global float32 table, no memset, no cast pass.
// The order in which entries reach a list follows the atomics of the
// fill, so the float32 sums' order (and the last bit of a gradient) may
// vary from run to run.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr long long kMaxInt = 0x7fffffffLL;
constexpr int kTile = 4;                  // tile side in cells
constexpr int kCells = kTile * kTile;
constexpr int kInFlight = 4;   // grad_out loads a lane keeps in flight

struct Tiles {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int stride[kMaxLevels];
  int across[kMaxLevels];     // tiles along a row of the level
  int per_image[kMaxLevels];  // tiles of one image's level
  int first[kMaxLevels + 1];  // first tile id of each level; the total
  long long grad_off[kMaxLevels];   // the level's gradient in grad_feats
};

// The forward's geometry of roi k on its level: first sample row and
// column, bin height and width, in level pixels.
struct Roi {
  float y1, x1, bin_h, bin_w;
};

__device__ __forceinline__ Roi roi_at(const float* __restrict__ rois, int k,
                                      int stride, int out_size,
                                      int aligned) {
  const float inv = 1.0f / static_cast<float>(stride);
  const float offset = aligned ? 0.5f : 0.0f;
  Roi g;
  g.x1 = __ldg(rois + 4 * k + 0) * inv - offset;
  g.y1 = __ldg(rois + 4 * k + 1) * inv - offset;
  float roi_w = (__ldg(rois + 4 * k + 2) * inv - offset) - g.x1;
  float roi_h = (__ldg(rois + 4 * k + 3) * inv - offset) - g.y1;
  if (!aligned) {  // v1 clamps the roi size at 1; aligned mode does not
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  g.bin_w = roi_w / static_cast<float>(out_size);
  g.bin_h = roi_h / static_cast<float>(out_size);
  return g;
}

// Sample m of an axis (start + (m + 0.5) / ratio * bin) on a map of
// `size` cells: false if it lies outside [-1, size] and adds nothing,
// else its clamped corners c0, c1 and the weight of c1.
__device__ __forceinline__ bool corners(float start, float bin, int m,
                                        int ratio, int size, int& c0,
                                        int& c1, float& l) {
  const float fsize = static_cast<float>(size);
  const float p = start + (static_cast<float>(m) + 0.5f) / ratio * bin;
  if (p < -1.0f || p > fsize) return false;
  const float c = fminf(fmaxf(p, 0.0f), fsize - 1.0f);
  c0 = static_cast<int>(floorf(c));
  c1 = min(c0 + 1, size - 1);
  l = c - static_cast<float>(c0);
  return true;
}

// The next distinct tile index (cells / kTile) of the corners of an
// axis's samples m0 .. m0 + ratio - 1 after `last` (-1: the first), in
// increasing order; -1 when there is none.  Corners are monotone in
// the walk (backwards for bin < 0), and a corner's tile is at most one
// more than its sample's near corner's, so the distinct tiles come out
// sorted.
__device__ __forceinline__ int next_tile(float start, float bin, int m0,
                                         int ratio, int size, int last) {
  for (int t = 0; t < ratio; ++t) {
    const int m = m0 + (bin < 0.0f ? ratio - 1 - t : t);
    int c0, c1;
    float l;
    if (!corners(start, bin, m, ratio, size, c0, c1, l)) continue;
    if (c0 / kTile > last) return c0 / kTile;
    if (c1 / kTile > last) return c1 / kTile;
  }
  return -1;
}

__global__ void roi_align_bwd_zero_kernel(int* __restrict__ p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = 0;
}

// One thread per (roi, bin) e = k * out_size^2 + py * out_size + px.
// The bin's samples are a ratio x ratio grid, and a sample lies inside
// the map when its row and its column do, so the tiles its corners fall
// in are (distinct tile rows) x (distinct tile columns): one entry each.
// kFill false: count the entries of every tile; true: write them.
template <bool kFill>
__global__ void roi_align_bwd_bin_kernel(
    Tiles tb, const float* __restrict__ rois, const int* __restrict__ bidx,
    const int* __restrict__ lvls, int total, int out_size, int ratio,
    int aligned, int* __restrict__ counts, int* __restrict__ cursor,
    int* __restrict__ entries) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ss = out_size * out_size;
  const int k = e / ss;
  const int py = (e - k * ss) / out_size;
  const int px = e - k * ss - py * out_size;
  const int l = lvls[k];
  const Roi g = roi_at(rois, k, tb.stride[l], out_size, aligned);
  const int base = tb.first[l] + bidx[k] * tb.per_image[l];
  for (int ty = next_tile(g.y1, g.bin_h, py * ratio, ratio, tb.h[l], -1);
       ty >= 0;
       ty = next_tile(g.y1, g.bin_h, py * ratio, ratio, tb.h[l], ty)) {
    for (int tx = next_tile(g.x1, g.bin_w, px * ratio, ratio, tb.w[l], -1);
         tx >= 0;
         tx = next_tile(g.x1, g.bin_w, px * ratio, ratio, tb.w[l], tx)) {
      const int tile = base + ty * tb.across[l] + tx;
      if (kFill) {
        entries[atomicAdd(cursor + tile, 1)] = e;
      } else {
        atomicAdd(counts + tile, 1);
      }
    }
  }
}

// Places every tile's list in the entry buffer: offsets[t] and
// cursor[t] get the start of a run of counts[t] entries.  The lanes of
// a warp take consecutive runs with one atomic on the running total
// (*used, zeroed before), so the lists are contiguous but not in tile
// order.
__global__ void roi_align_bwd_place_kernel(const int* __restrict__ counts,
                                           int n, int* __restrict__ used,
                                           int* __restrict__ offsets,
                                           int* __restrict__ cursor) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int v = t < n ? counts[t] : 0;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  int at = 0;
  if (lane == 31) at = atomicAdd(used, x);
  at = __shfl_sync(0xffffffffu, at, 31) + x - v;
  if (t < n) {
    offsets[t] = at;
    cursor[t] = at;
  }
}

// 16 bytes of channels: 8 bfloat16 or 4 float32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
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
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
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

// Lane's 16 bytes of grad_out's bin of the warp's entry i of a batch
// of cnt (lane i holds it); zeros past cnt.  Every lane calls it.
template <typename T>
__device__ __forceinline__ uint4 fetch(const T* __restrict__ grad_out,
                                       int entry, int i, int cnt,
                                       bool active, int channels, int c) {
  const int bin = __shfl_sync(0xffffffffu, entry, min(i, 31));
  if (!active || i >= cnt) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(
      grad_out + static_cast<size_t>(bin) * channels + c));
}

// One warp per block: blockIdx.x the tile, blockIdx.y the slice of 32
// 16-byte channel vectors; lane j owns vector j of the slice in all the
// tile's cells, its float32 sums at tile_sums[(cell * Q + q) * 32 + j]
// (float4 q of the vector: consecutive lanes, consecutive banks).
template <typename T>
__global__ void __launch_bounds__(32)
    roi_align_bwd_accumulate_kernel(Tiles tb, int num_levels, int channels,
                                    const float* __restrict__ rois,
                                    int out_size, int ratio, int aligned,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ entries,
                                    const T* __restrict__ grad_out,
                                    T* __restrict__ grad) {
  constexpr int V = Vec16<T>::kN;
  constexpr int Q = V / 4;
  extern __shared__ float4 tile_sums[];
  const int lane = threadIdx.x;
  const int c = (blockIdx.y * 32 + lane) * V;
  const bool active = c < channels;

  const int t = blockIdx.x;
  int l = 0;
  while (l + 1 < num_levels && t >= tb.first[l + 1]) ++l;
  const int local = t - tb.first[l];
  const int b = local / tb.per_image[l];
  const int r = local % tb.per_image[l];
  const int ty0 = (r / tb.across[l]) * kTile;
  const int tx0 = (r % tb.across[l]) * kTile;
  const int height = tb.h[l];
  const int width = tb.w[l];
  const int stride = tb.stride[l];

#pragma unroll
  for (int i = 0; i < kCells * Q; ++i) {
    tile_sums[i * 32 + lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  const int ss = out_size * out_size;
  const float inv_count = 1.0f / static_cast<float>(ratio * ratio);
  const int beg = offsets[t];
  const int end = beg + counts[t];
  for (int base = beg; base < end; base += 32) {
    // lane j: entry base + j's bin, and the bin's weights on the tile's
    // 4 rows and 4 columns: a bin's samples are a grid, so the weight
    // of cell (y, x) is wy[y] * wx[x], each summed over the samples'
    // corners on that row or column (1 / ratio^2 folded into wy)
    const int entry = base + lane < end ? entries[base + lane] : 0;
    float wy[kTile] = {}, wx[kTile] = {};
    if (base + lane < end) {
      const int k = entry / ss;
      const int py = (entry - k * ss) / out_size;
      const int px = entry - k * ss - py * out_size;
      const Roi geo = roi_at(rois, k, stride, out_size, aligned);
      for (int i = 0; i < ratio; ++i) {
        int c0, c1;
        float w1;
        if (corners(geo.y1, geo.bin_h, py * ratio + i, ratio, height, c0,
                    c1, w1)) {
#pragma unroll
          for (int d = 0; d < kTile; ++d) {
            wy[d] += ((c0 - ty0 == d) ? (1.0f - w1) : 0.0f) +
                     ((c1 - ty0 == d) ? w1 : 0.0f);
          }
        }
        if (corners(geo.x1, geo.bin_w, px * ratio + i, ratio, width, c0,
                    c1, w1)) {
#pragma unroll
          for (int d = 0; d < kTile; ++d) {
            wx[d] += ((c0 - tx0 == d) ? (1.0f - w1) : 0.0f) +
                     ((c1 - tx0 == d) ? w1 : 0.0f);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < kTile; ++d) wy[d] *= inv_count;
    }
    // kInFlight entries' grad_out vectors per group, the next group's
    // loads issued before this group's sums
    const int cnt = min(32, end - base);
    uint4 g[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      g[u] = fetch(grad_out, entry, u, cnt, active, channels, c);
    }
    for (int i = 0; i < cnt; i += kInFlight) {
      uint4 cur[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) cur[u] = g[u];
      if (i + kInFlight < cnt) {
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          g[u] = fetch(grad_out, entry, i + kInFlight + u, cnt, active,
                       channels, c);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int src = min(i + u, 31);
        float ry[kTile], rx[kTile];
#pragma unroll
        for (int d = 0; d < kTile; ++d) {
          ry[d] = __shfl_sync(0xffffffffu, wy[d], src);
          rx[d] = __shfl_sync(0xffffffffu, wx[d], src);
        }
        if (i + u >= cnt) continue;   // uniform across the warp
        float f[V];
        Vec16<T>::to_float(cur[u], f);
#pragma unroll
        for (int dy = 0; dy < kTile; ++dy) {
          if (ry[dy] == 0.0f) continue;
#pragma unroll
          for (int dx = 0; dx < kTile; ++dx) {
            if (rx[dx] == 0.0f) continue;
            const float w = ry[dy] * rx[dx];
#pragma unroll
            for (int j = 0; j < Q; ++j) {
              float4* p =
                  tile_sums + ((dy * kTile + dx) * Q + j) * 32 + lane;
              float4 v = *p;
              v.x += w * f[4 * j];
              v.y += w * f[4 * j + 1];
              v.z += w * f[4 * j + 2];
              v.w += w * f[4 * j + 3];
              *p = v;
            }
          }
        }
      }
    }
  }

  if (!active) return;
  T* out = grad + tb.grad_off[l] +
           static_cast<size_t>(b) * height * width * channels + c;
#pragma unroll
  for (int cell = 0; cell < kCells; ++cell) {
    const int y = ty0 + cell / kTile;
    const int x = tx0 + cell % kTile;
    if (y >= height || x >= width) continue;
    float v[V];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float4 a = tile_sums[(cell * Q + j) * 32 + lane];
      v[4 * j] = a.x;
      v[4 * j + 1] = a.y;
      v[4 * j + 2] = a.z;
      v[4 * j + 3] = a.w;
    }
    Vec16<T>::store(out + (static_cast<size_t>(y) * width + x) * channels,
                    v);
  }
}

template <typename T>
int launch_accumulate(const Tiles& tb, int num_levels, int channels,
                      const float* rois, int out_size, int ratio,
                      int aligned, const int* counts, const int* offsets,
                      const int* entries, const void* grad_out, void* grad,
                      cudaStream_t stream) {
  constexpr int V = Vec16<T>::kN;
  if (channels % V) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kCells * 32 * V * 4;   // at most 16 KB
  const dim3 grid(tb.first[num_levels], (channels / V + 31) / 32);
  roi_align_bwd_accumulate_kernel<T><<<grid, 32, smem, stream>>>(
      tb, num_levels, channels, rois, out_size, ratio, aligned, counts,
      offsets, entries, static_cast<const T*>(grad_out),
      static_cast<T*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the dtype of grad_out and of the
// features' gradient.  grad_feats: one buffer of grad_elems values of
// that dtype receiving the levels' [B, H_l, W_l, C] gradients back to
// back, in level order; every value is written.  scratch: scratch_ints
// int32 values, the tile lists' bookkeeping, laid out as
//   counts [T] | used [1] | offsets [T] | cursor [T] | entries [4 K n^2]
// with T = B * sum over levels of ceil(H_l / 4) * ceil(W_l / 4) tiles
// and n = out_size * sampling_ratio; scratch_ints must be 3 T + 1 +
// 4 K n^2.  h*, w*, st*: the levels' sizes and strides in pixels.  rois
// [K, 4] float32, bidx and lvls [K] int32, grad_out [K, out_size,
// out_size, C].  All device pointers 16-byte aligned and C a multiple
// of the 16-byte vector width (8 bfloat16, 4 float32); the
// Python wrapper checks both.  device is the CUDA ordinal the tensors
// and the stream belong to.  Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue for arguments it cannot take.
extern "C" int aidet_roi_align_backward(
    int device, int dtype, void* grad_feats, long long grad_elems,
    void* scratch, long long scratch_ints, int h0, int w0, int h1, int w1,
    int h2, int w2, int h3, int w3, int st0, int st1, int st2, int st3,
    int num_levels, int batch, int channels, const void* rois,
    const void* bidx, const void* lvls, int num_rois, int out_size,
    int sampling_ratio, int aligned, const void* grad_out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      out_size > 32 || sampling_ratio < 1 || channels < 4 ||
      num_rois < 0 || batch < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(out_size) * sampling_ratio;
  const long long bound = 4LL * num_rois * n * n;
  if (bound > kMaxInt ||
      static_cast<long long>(num_rois) * out_size * out_size > kMaxInt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int sts[kMaxLevels] = {st0, st1, st2, st3};
  Tiles tb;
  long long elems = 0, tiles = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    tb.h[i] = hs[i];
    tb.w[i] = ws[i];
    tb.stride[i] = sts[i];
    tb.across[i] = (ws[i] + kTile - 1) / kTile;
    tb.per_image[i] = tb.across[i] * ((hs[i] + kTile - 1) / kTile);
    tb.first[i] = static_cast<int>(tiles);
    tb.grad_off[i] = elems;
    if (i < num_levels) {
      if (hs[i] < 1 || ws[i] < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      elems += static_cast<long long>(batch) * hs[i] * ws[i] * channels;
      tiles += static_cast<long long>(batch) * tb.per_image[i];
    }
  }
  tb.first[num_levels] = static_cast<int>(tiles);
  if (elems != grad_elems || tiles > kMaxInt / 4 ||
      scratch_ints != 3 * tiles + 1 + bound) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = static_cast<int>(tiles);
  int* counts = static_cast<int*>(scratch);
  int* used = counts + nt;
  int* offsets = used + 1;
  int* cursor = offsets + nt;
  int* entries = cursor + nt;
  // this library links its own CUDA runtime, whose current device is
  // not the caller's
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* b = static_cast<const int*>(bidx);
  const int* l = static_cast<const int*>(lvls);
  const int total = num_rois * out_size * out_size;
  // few threads per block: the binning has one thread per bin, some
  // 50k at the train path's shapes, to spread over the SMs
  const int threads = 64;
  const int bin_blocks = (total + threads - 1) / threads;
  const int tile_blocks = (nt + 256) / 256;
  roi_align_bwd_zero_kernel<<<tile_blocks, 256, 0, s>>>(counts, nt + 1);
  if (total > 0) {
    roi_align_bwd_bin_kernel<false><<<bin_blocks, threads, 0, s>>>(
        tb, r, b, l, total, out_size, sampling_ratio, aligned, counts,
        nullptr, nullptr);
  }
  roi_align_bwd_place_kernel<<<tile_blocks, 256, 0, s>>>(counts, nt, used,
                                                         offsets, cursor);
  if (total > 0) {
    roi_align_bwd_bin_kernel<true><<<bin_blocks, threads, 0, s>>>(
        tb, r, b, l, total, out_size, sampling_ratio, aligned, nullptr,
        cursor, entries);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dtype == 1
      ? launch_accumulate<__nv_bfloat16>(tb, num_levels, channels, r,
                                         out_size, sampling_ratio, aligned,
                                         counts, offsets, entries, grad_out,
                                         grad_feats, s)
      : launch_accumulate<float>(tb, num_levels, channels, r, out_size,
                                 sampling_ratio, aligned, counts, offsets,
                                 entries, grad_out, grad_feats, s);
}
