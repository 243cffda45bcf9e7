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
// Design: a gather, tile by tile, in shared memory (roi_tiles.cuh, the
// lists and the per-tile sums it shares with K4's backward,
// rroi_align_backward.cu).
// 1. Binning.  One thread per (roi, bin) finds the 4x4-cell tiles the
//    corners of the bin's samples fall in (its distinct tile rows times
//    its distinct tile columns, as the samples form a grid) and lists
//    the bin once in each: count, place and fill passes.
// 2. Accumulate.  One warp per (tile, 32 16-byte channel vectors, 256
//    bfloat16 or 128 float32 channels): lane j owns vector j of all 16
//    cells.  For 32 entries at a time, lane j computes entry j's
//    weights on the tile's 4 rows and 4 columns (a bin's samples are a
//    grid, so cell (y, x) gets wy[y] * wx[x] of the bin's gradient,
//    every corner summed); the warp then takes the entries kInFlight at
//    a time: every lane loads its 16 bytes of each entry's grad_out bin
//    (512 bytes a warp, the next group's loads issued before this
//    group's sums), receives the weights by shuffles and adds the
//    weighted vector into each cell with weight, one read-modify-write
//    per cell and bin.  A bin's grad_out is read once per tile it
//    touches (about 2.2 times at the train path's shapes), not once per
//    sample.  Then the warp writes the whole tile once.
// No float atomics, no global float32 table, no memset, no cast pass.
// The order in which entries reach a list follows the atomics of the
// fill, so the float32 sums' order (and the last bit of a gradient) may
// vary from run to run.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include "roi_tiles.cuh"

namespace {

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
  zero_ints(p, n);
}

__global__ void roi_align_bwd_place_kernel(const int* __restrict__ counts,
                                           int n, int* __restrict__ used,
                                           int* __restrict__ offsets,
                                           int* __restrict__ cursor) {
  place_lists(counts, n, used, offsets, cursor);
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
      list_entry<kFill>(base + ty * tb.across[l] + tx, e, counts, cursor,
                        entries);
    }
  }
}

// One warp per block: blockIdx.x the tile, blockIdx.y the slice of 32
// 16-byte channel vectors; lane j owns vector j of the slice in all the
// tile's cells (its float32 sums: roi_tiles.cuh).
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
  constexpr int V = Vec<T>::kN;
  extern __shared__ float4 tile_sums[];
  const int lane = threadIdx.x;
  const int c = (blockIdx.y * 32 + lane) * V;
  const bool active = c < channels;

  const int t = blockIdx.x;
  int l, b, ty0, tx0;
  tile_at(tb, num_levels, t, l, b, ty0, tx0);
  const int height = tb.h[l];
  const int width = tb.w[l];
  const int stride = tb.stride[l];
  zero_tile<T>(tile_sums, lane);

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
        Vec<T>::to_float(cur[u], f);
#pragma unroll
        for (int dy = 0; dy < kTile; ++dy) {
          if (ry[dy] == 0.0f) continue;
#pragma unroll
          for (int dx = 0; dx < kTile; ++dx) {
            if (rx[dx] == 0.0f) continue;
            add_to_cell<T>(tile_sums, dy * kTile + dx, ry[dy] * rx[dx], f,
                           lane);
          }
        }
      }
    }
  }

  if (!active) return;
  write_tile<T>(tb, l, b, ty0, tx0, channels, c, tile_sums, lane, grad);
}

template <typename T>
int launch_accumulate(const Tiles& tb, int num_levels, int channels,
                      const float* rois, int out_size, int ratio,
                      int aligned, const int* counts, const int* offsets,
                      const int* entries, const void* grad_out, void* grad,
                      cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
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
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int sts[kMaxLevels] = {st0, st1, st2, st3};
  Tiles tb;
  Lists ls;
  if ((dtype != 0 && dtype != 1) ||
      !tile_layout(hs, ws, sts, num_levels, batch, channels, num_rois,
                   out_size, sampling_ratio, grad_elems, scratch,
                   scratch_ints, tb, ls)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  err = build_lists(
      ls, tb.first[num_levels], roi_align_bwd_zero_kernel,
      roi_align_bwd_place_kernel,
      [&](bool fill) {
        if (total == 0) return;
        if (fill) {
          roi_align_bwd_bin_kernel<true><<<bin_blocks, threads, 0, s>>>(
              tb, r, b, l, total, out_size, sampling_ratio, aligned,
              nullptr, ls.cursor, ls.entries);
        } else {
          roi_align_bwd_bin_kernel<false><<<bin_blocks, threads, 0, s>>>(
              tb, r, b, l, total, out_size, sampling_ratio, aligned,
              ls.counts, nullptr, nullptr);
        }
      },
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dtype == 1
      ? launch_accumulate<__nv_bfloat16>(tb, num_levels, channels, r,
                                         out_size, sampling_ratio, aligned,
                                         ls.counts, ls.offsets, ls.entries,
                                         grad_out, grad_feats, s)
      : launch_accumulate<float>(tb, num_levels, channels, r, out_size,
                                 sampling_ratio, aligned, ls.counts,
                                 ls.offsets, ls.entries, grad_out,
                                 grad_feats, s);
}
