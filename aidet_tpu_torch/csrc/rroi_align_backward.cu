// Rotated multi-level aligned RoIAlign backward for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel
// aidet_tpu/ops/rroi_align_pallas.py::rroi_align_pallas, its custom_vjp
// _vjp_bwd (rroi_align_pallas.py:282-296): the linear transpose of
// aidet_tpu/ops/rroi_align.py::batched_rroi_align (rroi_align_fused),
// routed as that function routes, without the TPU kernel's window bump.
// The forward is K4 (rroi_align.cu); the autograd Function in
// aidet_tpu_torch/ops/rroi_align.py pairs the two.
//
// What it computes: given grad_out [K, out_size, out_size, C] (the
// forward's output dtype), and the forward's rotated rois [K, 5]
// (cx, cy, w, h, theta) float32, image index bidx [K] and level lvls [K]
// (int32, routed by the caller exactly as for the forward), it adds
//   grad[bin] * w_corner / ratio^2
// for every sample of every bin into the 4 bilinear corners of that
// sample on level lvls[k] of image bidx[k].  The sample geometry is the
// forward's (roi_common.cuh): each of a bin's ratio^2 samples rotated
// into the map (w and h clamped to 1e-3 cells, any theta); a sample
// with y < -1, y > H, x < -1 or x > W adds nothing but still counts in
// the mean; the others are clamped to [0, H-1] x [0, W-1] with
// y1 = min(y0 + 1, H - 1), so at the last row (column) both corners
// are one cell, which receives both weights.  Sums are float32; the
// gradient is written once in grad_out's dtype.  The rois get no
// gradient (the reference's _vjp_bwd returns None for them).
//
// What bounds it on an H100: memory.  The function reads grad_out once
// and writes the whole pyramid's gradient once (zeros included); at the
// RRoI train step's shapes (2 x 128 rotated rois, C = 256, 7x7, levels
// 256^2..32^2) that is 6.4 MB and 89 MB in bfloat16: about 0.03 ms at
// 3.35 TB/s.  The multiply-adds (4 corners per sample per channel) are
// far below the card's rate.
//
// Design: K2's backward (roi_align_backward.cu) with rotated bins, on
// the tile lists and per-tile shared-memory sums of roi_tiles.cuh: no
// float atomics on the gradient, no global float32 table, no memset, no
// cast pass.  K2's binning rests on an axis-aligned bin (its tiles are
// its distinct tile rows times columns, its weights wy * wx); a rotated
// bin's samples are no grid, so here:
// 1. Binning.  One thread per (roi, bin) walks the bin's samples'
//    corners and lists the bin once in each distinct tile they fall in
//    (a tile is counted at the first sample whose corners reach it; at
//    most 4 tiles a sample, 16 a bin at ratio 2): count, place and fill
//    passes.
// 2. Accumulate.  One warp per (tile, 32 16-byte channel vectors).  For
//    32 entries at a time, lane j recomputes entry j's samples and adds
//    each corner that falls inside the tile, times 1 / ratio^2, to that
//    cell's weight in its row of a 32 x 16 shared table (samples of a
//    bin that hit one cell add one after the other).  The warp then
//    takes the entries kInFlight at a time: every lane loads its 16
//    bytes of the entry's grad_out bin (the next group's loads issued
//    before this group's sums), reads the entry's 16 weights (one
//    broadcast each) and adds the weighted vector into each cell with a
//    weight.  Then the warp writes the whole tile once.
// The scratch is sized by the bound 4 K n^2 entries, known on the host,
// so nothing goes back to the host.  The order in which entries reach
// a list follows the fill's atomics, so the float32 sums' order (and
// the last bit of a gradient) may vary from run to run.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/rroi_align.py).

#include "roi_tiles.cuh"

namespace {

// Sample s (0 .. ratio^2 - 1, row-major in the bin) of bin (py, px) of
// roi g on an h x w map: false if it adds nothing, else the tile rows
// ty[0] <= ty[1] and columns tx[0] <= tx[1] of its corners (equal when
// both corners share a tile).
__device__ __forceinline__ bool sample_tiles(const RotatedRoi& g, int py,
                                             int px, int s, int ratio,
                                             float inv_out, int h, int w,
                                             int* ty, int* tx) {
  float ys, xs;
  rotated_sample(g, py * ratio + s / ratio, px * ratio + s % ratio, ratio,
                 inv_out, ys, xs);
  int y0, y1, x0, x1;
  float ly, lx;
  if (!sample_corners(ys, xs, h, w, y0, y1, x0, x1, ly, lx)) return false;
  ty[0] = y0 / kTile;
  ty[1] = y1 / kTile;
  tx[0] = x0 / kTile;
  tx[1] = x1 / kTile;
  return true;
}

__global__ void rroi_align_bwd_zero_kernel(int* __restrict__ p, int n) {
  zero_ints(p, n);
}

__global__ void rroi_align_bwd_place_kernel(const int* __restrict__ counts,
                                            int n, int* __restrict__ used,
                                            int* __restrict__ offsets,
                                            int* __restrict__ cursor) {
  place_lists(counts, n, used, offsets, cursor);
}

// One thread per (roi, bin) e = k * out_size^2 + py * out_size + px:
// one entry in each distinct tile of the bin's samples' corners.
// kFill false: count the entries of every tile; true: write them.
template <bool kFill>
__global__ void rroi_align_bwd_bin_kernel(
    Tiles tb, const float* __restrict__ rrois, const int* __restrict__ bidx,
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
  const int h = tb.h[l];
  const int w = tb.w[l];
  const RotatedRoi g = rotated_roi_at(rrois, k, tb.stride[l], aligned);
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));
  const int base = tb.first[l] + bidx[k] * tb.per_image[l];
  for (int s = 0; s < ratio * ratio; ++s) {
    int ty[2], tx[2];
    if (!sample_tiles(g, py, px, s, ratio, inv_out, h, w, ty, tx)) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a == 1 && ty[1] == ty[0]) break;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (b == 1 && tx[1] == tx[0]) break;
        // listed already at an earlier sample of the bin?
        bool seen = false;
        for (int s2 = 0; s2 < s && !seen; ++s2) {
          int uy[2], ux[2];
          if (sample_tiles(g, py, px, s2, ratio, inv_out, h, w, uy, ux)) {
            seen = (ty[a] == uy[0] || ty[a] == uy[1]) &&
                   (tx[b] == ux[0] || tx[b] == ux[1]);
          }
        }
        if (!seen) {
          list_entry<kFill>(base + ty[a] * tb.across[l] + tx[b], e, counts,
                            cursor, entries);
        }
      }
    }
  }
}

// Adds w to the weight of cell (dy, dx) of the tile if it lies in it.
__device__ __forceinline__ void add_weight(float* row, int dy, int dx,
                                           float w) {
  if (static_cast<unsigned>(dy) < kTile && static_cast<unsigned>(dx) < kTile) {
    row[dy * kTile + dx] += w;
  }
}

// One warp per block: blockIdx.x the tile, blockIdx.y the slice of 32
// 16-byte channel vectors; lane j owns vector j of the slice in all the
// tile's cells (its float32 sums: roi_tiles.cuh), and row j of the
// batch's weights.
template <typename T>
__global__ void __launch_bounds__(32)
    rroi_align_bwd_accumulate_kernel(Tiles tb, int num_levels, int channels,
                                     const float* __restrict__ rrois,
                                     int out_size, int ratio, int aligned,
                                     const int* __restrict__ counts,
                                     const int* __restrict__ offsets,
                                     const int* __restrict__ entries,
                                     const T* __restrict__ grad_out,
                                     T* __restrict__ grad) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float4 tile_sums[];
  // entry j's weight on each cell of the tile (a padded row per lane)
  __shared__ float weights[32][kCells + 1];
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
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));
  float* row = weights[lane];
  const int beg = offsets[t];
  const int end = beg + counts[t];
  for (int base = beg; base < end; base += 32) {
    // lane j: entry base + j's bin, and its weight on each cell of the
    // tile, summed over the corners of its samples that fall in it
    const int entry = base + lane < end ? entries[base + lane] : 0;
#pragma unroll
    for (int d = 0; d < kCells; ++d) row[d] = 0.0f;
    if (base + lane < end) {
      const int k = entry / ss;
      const int py = (entry - k * ss) / out_size;
      const int px = entry - k * ss - py * out_size;
      const RotatedRoi geo = rotated_roi_at(rrois, k, stride, aligned);
      for (int iy = 0; iy < ratio; ++iy) {
        for (int ix = 0; ix < ratio; ++ix) {
          float ys, xs;
          rotated_sample(geo, py * ratio + iy, px * ratio + ix, ratio,
                         inv_out, ys, xs);
          int y0, y1, x0, x1;
          float ly, lx;
          if (!sample_corners(ys, xs, height, width, y0, y1, x0, x1, ly,
                              lx)) {
            continue;
          }
          const float hy = (1.0f - ly) * inv_count;
          const float wy = ly * inv_count;
          const float hx = 1.0f - lx;
          add_weight(row, y0 - ty0, x0 - tx0, hy * hx);
          add_weight(row, y0 - ty0, x1 - tx0, hy * lx);
          add_weight(row, y1 - ty0, x0 - tx0, wy * hx);
          add_weight(row, y1 - ty0, x1 - tx0, wy * lx);
        }
      }
    }
    __syncwarp();
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
        if (i + u >= cnt) break;   // uniform across the warp
        float f[V];
        Vec<T>::to_float(cur[u], f);
        const float* wi = weights[i + u];
#pragma unroll
        for (int d = 0; d < kCells; ++d) {
          const float w = wi[d];
          if (w != 0.0f) add_to_cell<T>(tile_sums, d, w, f, lane);
        }
      }
    }
    __syncwarp();   // the weights are rewritten for the next batch
  }

  if (!active) return;
  write_tile<T>(tb, l, b, ty0, tx0, channels, c, tile_sums, lane, grad);
}

template <typename T>
int launch_accumulate(const Tiles& tb, int num_levels, int channels,
                      const float* rrois, int out_size, int ratio,
                      int aligned, const Lists& ls, const void* grad_out,
                      void* grad, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  if (channels % V) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kCells * 32 * V * 4;   // at most 16 KB
  const dim3 grid(tb.first[num_levels], (channels / V + 31) / 32);
  rroi_align_bwd_accumulate_kernel<T><<<grid, 32, smem, stream>>>(
      tb, num_levels, channels, rrois, out_size, ratio, aligned, ls.counts,
      ls.offsets, ls.entries, static_cast<const T*>(grad_out),
      static_cast<T*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of aidet_roi_align_backward (roi_align_backward.cu),
// with rotated rois: dtype 0 = float32, 1 = bfloat16, the dtype of
// grad_out and of the features' gradient.  grad_feats: one buffer of
// grad_elems values of that dtype receiving the levels' [B, H_l, W_l, C]
// gradients back to back, in level order; every value is written.
// scratch: scratch_ints int32 values laid out as
//   counts [T] | used [1] | offsets [T] | cursor [T] | entries [4 K n^2]
// with T = B * sum over levels of ceil(H_l / 4) * ceil(W_l / 4) tiles
// and n = out_size * sampling_ratio; scratch_ints must be 3 T + 1 +
// 4 K n^2.  h*, w*, st*: the levels' sizes and strides in pixels.
// rrois [K, 5] float32 (cx, cy, w, h, theta), bidx and lvls [K] int32,
// grad_out [K, out_size, out_size, C].  All device pointers 16-byte
// aligned and C a multiple of the 16-byte vector width (8 bfloat16,
// 4 float32); the Python wrapper checks both.  device is the CUDA
// ordinal the tensors and the stream belong to.  Returns the first CUDA
// error of the launches, or cudaErrorInvalidValue for arguments it
// cannot take.
extern "C" int aidet_rroi_align_backward(
    int device, int dtype, void* grad_feats, long long grad_elems,
    void* scratch, long long scratch_ints, int h0, int w0, int h1, int w1,
    int h2, int w2, int h3, int w3, int st0, int st1, int st2, int st3,
    int num_levels, int batch, int channels, const void* rrois,
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
  const float* r = static_cast<const float*>(rrois);
  const int* b = static_cast<const int*>(bidx);
  const int* l = static_cast<const int*>(lvls);
  const int total = num_rois * out_size * out_size;
  const int threads = 64;
  const int bin_blocks = (total + threads - 1) / threads;
  err = build_lists(
      ls, tb.first[num_levels], rroi_align_bwd_zero_kernel,
      rroi_align_bwd_place_kernel,
      [&](bool fill) {
        if (total == 0) return;
        if (fill) {
          rroi_align_bwd_bin_kernel<true><<<bin_blocks, threads, 0, s>>>(
              tb, r, b, l, total, out_size, sampling_ratio, aligned,
              nullptr, ls.cursor, ls.entries);
        } else {
          rroi_align_bwd_bin_kernel<false><<<bin_blocks, threads, 0, s>>>(
              tb, r, b, l, total, out_size, sampling_ratio, aligned,
              ls.counts, nullptr, nullptr);
        }
      },
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dtype == 1
      ? launch_accumulate<__nv_bfloat16>(tb, num_levels, channels, r,
                                         out_size, sampling_ratio, aligned,
                                         ls, grad_out, grad_feats, s)
      : launch_accumulate<float>(tb, num_levels, channels, r, out_size,
                                 sampling_ratio, aligned, ls, grad_out,
                                 grad_feats, s);
}
