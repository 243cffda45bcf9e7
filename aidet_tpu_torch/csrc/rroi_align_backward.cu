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
// far below the card's rate.  About 63% of the 4x4-cell tiles receive
// no sample there: their cost is the store of zeros alone.  Writing the
// gradient's bytes takes about as long as the bound on this card
// (`zero_()` of the same bytes: 3.1 TB/s), so the design hides the
// rest behind those stores: the listing is latency-bound, and a tile
// with entries waits on a chain of dependent loads (its list, the
// entries' weights, their grad_out rows).
//
// Design: K2's tile lists (roi_tiles.cuh: no float atomics on the
// gradient, no global float32 table, no memset, no cast pass), with
// rotated bins, in five kernels on one stream:
// 1. plan.  One block per roi: thread 0 computes the roi's geometry
//    (rotated_roi_at, one double sincos per roi), then one thread per
//    sample of its n x n grid writes the sample's (y0, x0, ly, lx) of
//    sample_corners, or y0 = -1 outside the map, to a per-sample table
//    in K4's work buffer (16 bytes a sample).  The same blocks zero the tile
//    counts and the running totals: no zero pass.  The later passes
//    read the table and recompute no geometry, so the binning, the sums
//    and the plain version put every sample at the same point.
// 2. count and 4. fill.  A bin is listed once in each distinct 4x4-cell
//    tile of its samples' corners, at the first sample whose corners
//    reach it (first_reached: a bin's first four samples are loaded
//    together and compared in registers).  The count runs one thread
//    per (roi, bin); the fill one thread per (roi, bin, sample), which
//    lists the tiles its sample reaches first (at most 4), issues their
//    cursor atomics together, and writes each entry's bin and its 16
//    weights on the tile's cells (all the bin's samples' corners in the
//    tile times 1 / ratio^2, summed in the bin's sample order, in a
//    shared-memory column of the thread).
// 3. place: roi_tiles.cuh's offsets, and the accumulate's walk: one
//    (tile, count, offset) per tile with entries.
// 5. accumulate, in two kinds of block.  A kernel ends only when its
//    writes are done, so the zeros and the sums share this last launch:
//    the latency-bound sums hide behind the bandwidth-bound zeros, and
//    both store with an evict-first hint, so that the zeros do not
//    evict the sums' inputs.  Every block is one warp.
//    - Zero blocks, dispatched first: one per 32 tiles, whose counts
//      its lanes load at once; it stores the rows of those without
//      entries as zeros from registers, in coalesced 512-byte stores;
//      every such value is written once.
//    - Sum blocks: one per (tile, 128-channel slice) task of the tiles
//      with entries (blocks past them end at once); lane j owns 4
//      channels of every cell of the tile, float32 sums in 64
//      registers.  For 32 entries at a time the warp stages in shared
//      memory, with cp.async, the
//      entries' weights (lane j: entry j's 16) and then each entry's
//      grad_out row (lane j: its 4 channels): two round trips a batch.
//      Every lane then adds each entry's weighted vector into each cell
//      with a weight (broadcast reads), and the warp stores its cells
//      once, in the gradient's dtype.
// The scratch (K2's lists) and the work buffer (the plan, the weights,
// the walk) are sized on the host by the bound 4 K n^2 entries, so
// nothing goes back to the host.
// The order in which entries reach a list follows the fill's atomics,
// so the float32 sums' order (and the last bit of a gradient) may vary
// from run to run.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/rroi_align.py).

#include "roi_tiles.cuh"

namespace {

constexpr int kSlice = 128;        // channels of an accumulate task
constexpr int kPlanThreads = 256;
constexpr int kBinThreads = 128;
// The accumulate's blocks are one warp; 16 an SM: at most 128
// registers a thread, for the 64 sums
constexpr int kAccMinBlocks = 16;

// Four channels of a [.., C] row, loaded, converted to float32, stored.
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  using Raw = uint4;
  __device__ static void to_float(const Raw& q, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&q);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  // evict-first (streaming) stores: nothing here reads the gradient
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static void to_float(const Raw& q, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p), q);
  }
};

// kBytes (8 or 16) from global to shared memory, asynchronously
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// K4's work buffer, beside K2's scratch (roi_tiles.cuh's Lists):
//   plan [K n^2] int4 | weights [4 K n^2][4] float4 | order [T] int4 |
//   ends [4] int (the walk's length, padded to 16 bytes)
struct Work {
  int4* plan;
  float4* weights;   // 16 floats an entry slot
  int4* order;
  int* ends;
};

inline long long work_ints(int num_rois, long long n, long long tiles) {
  return 68LL * num_rois * n * n + 4LL * tiles + 4;
}

inline Work work_at(int* p, int num_rois, long long n, int tiles) {
  Work x;
  const long long samples = static_cast<long long>(num_rois) * n * n;
  x.plan = reinterpret_cast<int4*>(p);
  x.weights = reinterpret_cast<float4*>(p + 4 * samples);
  x.order = reinterpret_cast<int4*>(p + 68 * samples);
  x.ends = p + 68 * samples + 4LL * tiles;
  return x;
}

// The plan entry of a sample: (y0, x0, ly, lx) of sample_corners, or
// y0 = -1 for a sample outside the map.
__device__ __forceinline__ int4 plan_entry(const RotatedRoi& g, int i, int j,
                                           int ratio, float inv_out, int h,
                                           int w) {
  float ys, xs;
  rotated_sample(g, i, j, ratio, inv_out, ys, xs);
  int y0, y1, x0, x1;
  float ly, lx;
  if (!sample_corners(ys, xs, h, w, y0, y1, x0, x1, ly, lx)) {
    return make_int4(-1, 0, 0, 0);
  }
  return make_int4(y0, x0, __float_as_int(ly), __float_as_int(lx));
}

// The tile rows ty[0] <= ty[1] and columns tx[0] <= tx[1] of a planned
// sample's corners on an h x w map (equal when both corners share a
// tile); false for a sample outside the map.
__device__ __forceinline__ bool plan_tiles(const int4& p, int h, int w,
                                           int* ty, int* tx) {
  if (p.x < 0) return false;
  ty[0] = p.x / kTile;
  ty[1] = min(p.x + 1, h - 1) / kTile;
  tx[0] = p.y / kTile;
  tx[1] = min(p.y + 1, w - 1) / kTile;
  return true;
}

// Whether planned sample p has a corner in tile (ty, tx).
__device__ __forceinline__ bool reaches(const int4& p, int h, int w, int ty,
                                        int tx) {
  int uy[2], ux[2];
  return plan_tiles(p, h, w, uy, ux) && (ty == uy[0] || ty == uy[1]) &&
         (tx == ux[0] || tx == ux[1]);
}

// Adds planned sample p's corner weights (times inv_count) that fall in
// the tile at rows ty0.., columns tx0.. to col[cell][tid], the thread's
// column of a shared [kCells][kBinThreads] table, in the sums' order
// (y0, x0), (y0, x1), (y1, x0), (y1, x1).
__device__ __forceinline__ void add_sample_weights(const int4& p, int h,
                                                   int wd, int ty0, int tx0,
                                                   float inv_count,
                                                   float (*col)[kBinThreads],
                                                   int tid) {
  if (p.x < 0) return;
  const int y0 = p.x - ty0;
  const int x0 = p.y - tx0;
  const int y1 = min(p.x + 1, h - 1) - ty0;
  const int x1 = min(p.y + 1, wd - 1) - tx0;
  const float ly = __int_as_float(p.z);
  const float lx = __int_as_float(p.w);
  const float hy = (1.0f - ly) * inv_count;
  const float wy = ly * inv_count;
  const float hx = 1.0f - lx;
  const int ys[4] = {y0, y0, y1, y1};
  const int xs[4] = {x0, x1, x0, x1};
  const float ws[4] = {hy * hx, hy * lx, wy * hx, wy * lx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (static_cast<unsigned>(ys[c]) < kTile &&
        static_cast<unsigned>(xs[c]) < kTile) {
      col[ys[c] * kTile + xs[c]][tid] += ws[c];
    }
  }
}

// One block per roi k < num_rois: its n x n samples' plan entries at
// plan[k * n^2 ..].  Every block first zeroes its share of the nz ints
// at `counts` (the tile counts and the running total), and block 0 the
// walk's length.
__global__ void __launch_bounds__(kPlanThreads)
    rroi_align_bwd_plan_kernel(Tiles tb, const float* __restrict__ rrois,
                               const int* __restrict__ lvls, int num_rois,
                               int out_size, int ratio, int aligned,
                               int* __restrict__ counts, int nz, Work x) {
  for (int i = blockIdx.x * kPlanThreads + threadIdx.x; i < nz;
       i += gridDim.x * kPlanThreads) {
    counts[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) x.ends[0] = 0;
  const int k = blockIdx.x;
  if (k >= num_rois) return;   // the whole block
  __shared__ RotatedRoi geo;
  __shared__ int level;
  if (threadIdx.x == 0) {
    level = lvls[k];
    geo = rotated_roi_at(rrois, k, tb.stride[level], aligned);
  }
  __syncthreads();
  const RotatedRoi g = geo;
  const int h = tb.h[level];
  const int w = tb.w[level];
  const int n = out_size * ratio;
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));
  int4* dst = x.plan + static_cast<size_t>(k) * n * n;
  for (int s = threadIdx.x; s < n * n; s += kPlanThreads) {
    const int i = s / n;
    dst[s] = plan_entry(g, i, s - i * n, ratio, inv_out, h, w);
  }
}

// K2's place (offsets and cursors), then the walk: one (tile, count,
// offset, 0) per tile with entries, in slots claimed with one atomic
// per warp on the walk's length.
__global__ void rroi_align_bwd_place_kernel(const int* __restrict__ counts,
                                            int n, int* __restrict__ used,
                                            int* __restrict__ offsets,
                                            int* __restrict__ cursor,
                                            Work x) {
  place_lists(counts, n, used, offsets, cursor);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int v = t < n ? counts[t] : 0;
  const int at = v > 0 ? offsets[t] : 0;   // written by this thread
  const unsigned full = __ballot_sync(0xffffffffu, v > 0);
  int front = 0;
  if (lane == 0 && full) front = atomicAdd(x.ends, __popc(full));
  front = __shfl_sync(0xffffffffu, front, 0);
  if (v > 0) {
    x.order[front + __popc(full & ((1u << lane) - 1u))] =
        make_int4(t, v, at, 0);
  }
}

// Bin e = k * out_size^2 + py * out_size + px of the plan: its roi k,
// the roi's level map (h x w), the first tile of its image on the
// level, the tiles across a row, and its first sample (sample s at
// bin[(s / ratio) * n + s % ratio]).
struct BinAt {
  int h, w, base, across;
  const int4* bin;
};

__device__ __forceinline__ BinAt bin_at(const Tiles& tb,
                                        const int* __restrict__ bidx,
                                        const int* __restrict__ lvls, int e,
                                        int out_size, int ratio,
                                        const int4* plan) {
  const int ss = out_size * out_size;
  const int k = e / ss;
  const int py = (e - k * ss) / out_size;
  const int px = e - k * ss - py * out_size;
  const int l = lvls[k];
  const int n = out_size * ratio;
  BinAt a;
  a.h = tb.h[l];
  a.w = tb.w[l];
  a.base = tb.first[l] + bidx[k] * tb.per_image[l];
  a.across = tb.across[l];
  a.bin = plan + static_cast<size_t>(k) * n * n +
          static_cast<size_t>(py) * ratio * n + px * ratio;
  return a;
}

// Sample s < 4 of a bin from its first four samples ps, in registers
__device__ __forceinline__ int4 bin_sample(const int4* ps, int s) {
  int4 p = ps[0];
  if (s == 1) p = ps[1];
  if (s == 2) p = ps[2];
  if (s == 3) p = ps[3];
  return p;
}

// The tiles (at most 4, ids in t[]) that sample s of the bin reaches and
// no earlier sample of the bin does: each tile of a bin's corners is
// listed at the first sample that reaches it.  ps: the bin's first four
// samples; later ones are loaded from the plan (row stride n).
__device__ __forceinline__ int first_reached(const BinAt& a, const int4* ps,
                                             int s, int ratio, int n,
                                             int* t) {
  const int4 p = s < 4 ? bin_sample(ps, s)
                       : __ldg(a.bin + (s / ratio) * n + s % ratio);
  int ty[2], tx[2];
  if (!plan_tiles(p, a.h, a.w, ty, tx)) return 0;
  int found = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == 1 && ty[1] == ty[0]) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && tx[1] == tx[0]) break;
      bool seen = false;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        seen = seen || (v < s && reaches(ps[v], a.h, a.w, ty[i], tx[j]));
      }
      for (int s2 = 4; s2 < s && !seen; ++s2) {
        seen = reaches(__ldg(a.bin + (s2 / ratio) * n + s2 % ratio), a.h,
                       a.w, ty[i], tx[j]);
      }
      if (!seen) t[found++] = a.base + ty[i] * a.across + tx[j];
    }
  }
  return found;
}

// The bin's first four samples (-1 entries past r2)
__device__ __forceinline__ void first_samples(const BinAt& a, int ratio,
                                              int n, int4* ps) {
  const int r2 = ratio * ratio;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ps[u] = u < r2 ? __ldg(a.bin + (u / ratio) * n + u % ratio)
                   : make_int4(-1, 0, 0, 0);
  }
}

// One thread per (roi, bin): one entry counted in each distinct tile of
// the bin's samples' corners.
__global__ void __launch_bounds__(kBinThreads)
    rroi_align_bwd_count_kernel(Tiles tb, const int* __restrict__ bidx,
                                const int* __restrict__ lvls, int total,
                                int out_size, int ratio, Work x,
                                int* __restrict__ counts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int n = out_size * ratio;
  const BinAt a = bin_at(tb, bidx, lvls, e, out_size, ratio, x.plan);
  int4 ps[4];
  first_samples(a, ratio, n, ps);
  for (int s = 0; s < ratio * ratio; ++s) {
    int t[4];
    const int found = first_reached(a, ps, s, ratio, n, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < found) atomicAdd(counts + t[i], 1);
    }
  }
}

// The zeros of the tiles without entries, by zero block `block` (one
// warp): tiles block * 32 .. block * 32 + 31.  Lane j loads tile j's
// count; then the warp stores each empty tile's rows as zeros, lane j
// the 16-byte vectors j, j + 32, .. of a row (coalesced 512-byte
// stores), evict-first.  Every such value is written once.
__device__ __forceinline__ void zero_empty_tiles(
    const Tiles& tb, int num_levels, int block,
    const int* __restrict__ counts, int row_bytes, int elem_bytes,
    char* __restrict__ grad) {
  const int nt = tb.first[num_levels];
  const int lane = threadIdx.x;
  const int t = block * 32 + lane;
  unsigned empty = __ballot_sync(0xffffffffu, t < nt && counts[t] == 0);
  while (empty) {
    const int i = __ffs(empty) - 1;
    empty &= empty - 1;
    int l, b, ty0, tx0;
    tile_at(tb, num_levels, block * 32 + i, l, b, ty0, tx0);
    const int height = tb.h[l];
    const int width = tb.w[l];
    const int vecs = min(kTile, width - tx0) * row_bytes / 16;
    char* out = grad + tb.grad_off[l] * elem_bytes +
                static_cast<size_t>(b) * height * width * row_bytes;
    for (int y = ty0; y < min(ty0 + kTile, height); ++y) {
      uint4* row = reinterpret_cast<uint4*>(
          out + (static_cast<size_t>(y) * width + tx0) * row_bytes);
      for (int v = lane; v < vecs; v += 32) {
        __stcs(row + v, make_uint4(0u, 0u, 0u, 0u));
      }
    }
  }
}

// One thread per (roi, bin, sample): the bin's entries in the tiles
// that the sample reaches first, written with their weights (all the
// bin's samples' corners in the tile), the cursor atomics issued
// together.
__global__ void __launch_bounds__(kBinThreads)
    rroi_align_bwd_fill_kernel(Tiles tb, const int* __restrict__ bidx,
                               const int* __restrict__ lvls, int total,
                               int out_size, int ratio, Work x,
                               int* __restrict__ cursor,
                               int* __restrict__ entries) {
  // an entry's weights being summed, a column per thread
  __shared__ float col[kCells][kBinThreads];
  const int r2 = ratio * ratio;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total * r2) return;
  const int e = gid / r2;
  const int s = gid - e * r2;
  const int n = out_size * ratio;
  const int tid = threadIdx.x;
  const BinAt a = bin_at(tb, bidx, lvls, e, out_size, ratio, x.plan);
  int4 ps[4];
  first_samples(a, ratio, n, ps);
  int t[4];
  const int found = first_reached(a, ps, s, ratio, n, t);
  int at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < found) at[i] = atomicAdd(cursor + t[i], 1);
  }
  const float inv_count = 1.0f / static_cast<float>(r2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= found) break;
    const int r = t[i] - a.base;
    const int ty0 = (r / a.across) * kTile;
    const int tx0 = (r % a.across) * kTile;
#pragma unroll
    for (int d = 0; d < kCells; ++d) col[d][tid] = 0.0f;
    if (r2 <= 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        add_sample_weights(ps[u], a.h, a.w, ty0, tx0, inv_count, col, tid);
      }
    } else {
      for (int q = 0; q < r2; ++q) {
        add_sample_weights(__ldg(a.bin + (q / ratio) * n + q % ratio), a.h,
                           a.w, ty0, tx0, inv_count, col, tid);
      }
    }
    entries[at[i]] = e;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x.weights[4 * static_cast<size_t>(at[i]) + j] =
          make_float4(col[4 * j][tid], col[4 * j + 1][tid],
                      col[4 * j + 2][tid], col[4 * j + 3][tid]);
    }
  }
}

// One warp a block.  Blocks below zero_blocks: zero_empty_tiles.  The
// others, sum blocks: block zero_blocks + i takes task i if it is below
// the walk's length times slices: slice i % slices (128 channels, 4 a
// lane) of the tile of order[i / slices].
template <typename T>
__global__ void __launch_bounds__(32, kAccMinBlocks)
    rroi_align_bwd_accumulate_kernel(Tiles tb, int num_levels, int channels,
                                     int slices, int zero_blocks, Work x,
                                     const int* __restrict__ counts,
                                     const int* __restrict__ entries,
                                     const T* __restrict__ grad_out,
                                     T* __restrict__ grad) {
  using Raw = typename Vec4<T>::Raw;
  // entry j's weights on the tile's cells, and lane i's 4 channels of
  // entry j's grad_out row
  __shared__ alignas(16) float4 wrow[32][4];
  __shared__ alignas(16) Raw stage[32][32];
  if (blockIdx.x < zero_blocks) {
    zero_empty_tiles(tb, num_levels, blockIdx.x, counts,
                     channels * static_cast<int>(sizeof(T)),
                     static_cast<int>(sizeof(T)),
                     reinterpret_cast<char*>(grad));
    return;
  }
  const int lane = threadIdx.x;
  const int task = blockIdx.x - zero_blocks;
  if (task >= x.ends[0] * slices) return;
  const int4 job = x.order[task / slices];   // (tile, count, offset, 0)
  const int c = (task - (task / slices) * slices) * kSlice + lane * 4;
  const bool active = c < channels;
  int l, b, ty0, tx0;
  tile_at(tb, num_levels, job.x, l, b, ty0, tx0);
  const int height = tb.h[l];
  const int width = tb.w[l];
  float acc[kCells][4];
#pragma unroll
  for (int d = 0; d < kCells; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[d][j] = 0.0f;
  }

  const int end = job.z + job.y;
  for (int base = job.z; base < end; base += 32) {
    const int m = min(32, end - base);
    // lane j: entry base + j's bin, and its weights staged
    const int entry = lane < m ? entries[base + lane] : 0;
    if (lane < m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        cp_async<16>(&wrow[lane][q],
                     x.weights + 4 * static_cast<size_t>(base + lane) + q);
      }
    }
    // every entry's grad_out row: lane's 4 channels
    for (int i = 0; i < m; ++i) {
      const int bin = __shfl_sync(0xffffffffu, entry, i);
      if (active) {
        cp_async<sizeof(Raw)>(
            &stage[i][lane],
            grad_out + static_cast<size_t>(bin) * channels + c);
      }
    }
    cp_async_wait_all();
    __syncwarp();
    for (int i = 0; i < m; ++i) {
      float f[4];
      Vec4<T>::to_float(stage[i][lane], f);
      float wi[kCells];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = wrow[i][q];
        wi[4 * q] = v.x;
        wi[4 * q + 1] = v.y;
        wi[4 * q + 2] = v.z;
        wi[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int d = 0; d < kCells; ++d) {
        if (wi[d] != 0.0f) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[d][j] += wi[d] * f[j];
        }
      }
    }
    __syncwarp();   // the stage is rewritten for the next batch
  }

  if (!active) return;
  T* out = grad + tb.grad_off[l] +
           static_cast<size_t>(b) * height * width * channels + c;
#pragma unroll
  for (int d = 0; d < kCells; ++d) {
    const int y = ty0 + d / kTile;
    const int xc = tx0 + d % kTile;
    if (y < height && xc < width) {
      Vec4<T>::store(out + (static_cast<size_t>(y) * width + xc) * channels,
                     acc[d]);
    }
  }
}

template <typename T>
int launch_accumulate(const Tiles& tb, int num_levels, int channels,
                      const Work& x, const int* counts, const int* entries,
                      const void* grad_out, void* grad,
                      cudaStream_t stream) {
  if (channels % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (channels + kSlice - 1) / kSlice;
  const long long nt = tb.first[num_levels];
  const long long zero_blocks = (nt + 31) / 32;
  const long long tasks = nt * slices;
  if (zero_blocks + tasks > kMaxInt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rroi_align_bwd_accumulate_kernel<T>
      <<<static_cast<int>(zero_blocks + tasks), 32, 0, stream>>>(
          tb, num_levels, channels, slices, static_cast<int>(zero_blocks),
          x, counts, entries, static_cast<const T*>(grad_out),
          static_cast<T*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of aidet_roi_align_backward (roi_align_backward.cu),
// with rotated rois: dtype 0 = float32, 1 = bfloat16, the dtype of
// grad_out and of the features' gradient.  grad_feats: one buffer of
// grad_elems values of that dtype receiving the levels' [B, H_l, W_l, C]
// gradients back to back, in level order; every value is written.
// scratch: K2's scratch_ints int32 values (roi_tiles.cuh's Lists,
// 3 T + 1 + 4 K n^2 of them) with T = B * sum over levels of
// ceil(H_l / 4) * ceil(W_l / 4) tiles and n = out_size *
// sampling_ratio.  work: work_ints int32 values, 16-byte aligned, laid
// out as plan [4 K n^2] | weights [64 K n^2] | order [4 T] | ends [4];
// work_ints must be 68 K n^2 + 4 T + 4.  h*, w*, st*: the levels'
// sizes and strides in pixels.
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
    int sampling_ratio, int aligned, const void* grad_out, void* stream,
    void* work, long long work_ints_given) {
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int sts[kMaxLevels] = {st0, st1, st2, st3};
  const long long n = static_cast<long long>(out_size) * sampling_ratio;
  long long tiles = 0;
  for (int i = 0; i < num_levels && i < kMaxLevels; ++i) {
    tiles += static_cast<long long>(batch) * ((hs[i] + kTile - 1) / kTile) *
             ((ws[i] + kTile - 1) / kTile);
  }
  Tiles tb;
  Lists ls;
  if ((dtype != 0 && dtype != 1) || tiles > kMaxInt / 4 ||
      work_ints_given != work_ints(num_rois, n, tiles) ||
      reinterpret_cast<uintptr_t>(work) % 16 ||
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
  const int nt = tb.first[num_levels];
  const Work x = work_at(static_cast<int*>(work), num_rois, n, nt);
  const int total = num_rois * out_size * out_size;
  const int bin_blocks = (total + kBinThreads - 1) / kBinThreads;
  const int tile_blocks = (nt + 256) / 256;
  rroi_align_bwd_plan_kernel<<<max(num_rois, tile_blocks), kPlanThreads, 0,
                               s>>>(tb, r, l, num_rois, out_size,
                                    sampling_ratio, aligned, ls.counts,
                                    nt + 1, x);
  if (total) {
    rroi_align_bwd_count_kernel<<<bin_blocks, kBinThreads, 0, s>>>(
        tb, b, l, total, out_size, sampling_ratio, x, ls.counts);
  }
  rroi_align_bwd_place_kernel<<<tile_blocks, 256, 0, s>>>(
      ls.counts, nt, ls.used, ls.offsets, ls.cursor, x);
  if (total) {
    const long long samples =
        static_cast<long long>(total) * sampling_ratio * sampling_ratio;
    rroi_align_bwd_fill_kernel<<<static_cast<int>(
                                     (samples + kBinThreads - 1) /
                                     kBinThreads),
                                 kBinThreads, 0, s>>>(
        tb, b, l, total, out_size, sampling_ratio, x, ls.cursor,
        ls.entries);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dtype == 1
      ? launch_accumulate<__nv_bfloat16>(tb, num_levels, channels, x,
                                         ls.counts, ls.entries, grad_out,
                                         grad_feats, s)
      : launch_accumulate<float>(tb, num_levels, channels, x, ls.counts,
                                 ls.entries, grad_out, grad_feats, s);
}
