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
// Two kernels, launched one after the other on the caller's stream:
//
// The plan (one block of 1024 threads, no host synchronisation) sorts
// the rois by an (image, level, 16-row band) key, the band of the roi's
// first sample row as the TPU kernel's `_prepare` takes it, and within
// a key by the roi's first sample column, so that the rois of a chunk
// are neighbours in x.  The sort is two stable counting sorts (by
// column, then by key): each warp counts its contiguous segment of the
// rois per bin in order (__match_any_sync ranks equal bins within a
// warp step), one block-wide scan turns the bins-by-segments counts
// into offsets, and each warp places its segment again in order, so
// the order is that of a stable sort, the same on every run.  Each
// key's run is cut into chunks of at most chunk_size rois, and each
// chunk gets its staged box: the rows and columns that its rois'
// samples read inside its 48-row band, with its columns cut to the
// shared-memory budget where the box would exceed it.  The grid of the
// reduction is a static bound on the chunk count that the caller
// computes from shapes; unused chunks have count 0.  The plan's
// arithmetic rounds each operation as the plain twin
// (aidet_tpu_torch/ops/roi_align.py::bandx_chunks) does, so both give
// the same table.
//
// The reduction: a block per (chunk, two 32-byte channel slices: 32
// bfloat16 or 16 float32 channels) stages its box, one slice of each
// cell (a whole sector) after the other, through a ring of two
// shared-memory stages filled by cp.async (commit groups, wait_group
// 1): the copy of slice c + 1 runs while slice c is reduced.  (A block
// per chunk and all its slices ran 13-18% longer: the grid was one
// wave, as long as its longest chunk.)  While the first slice
// arrives the block plans its rois' sample rows and columns (corners
// and weights) into shared memory once.  Each corner is one load: from
// the stage (ld.shared, slots swizzled over the banks) where the box
// holds the cell, else from global memory (ld.global.nc), a row's
// loads issued before its FMAs (a branch around each corner's FMAs
// kept them apart and cost more than reading everything from global
// memory).  The threads own
// (roi of the chunk, bin column, 16-byte half of the slice) triples
// and reduce with separable weights, x first then y, in f32:
//   t(y) = sum over the bin column's x samples and their 2 corners of
//          w_x * cell[y][x]                    (one row, one bin column)
//   out[py][px] = sum over bin row py's y samples of
//                 (1 - ly) t(y0) + ly t(y1), over ratio^2.
// The rows of the y samples are monotone, so a thread keeps the t of
// the last two rows and computes each row's t once per bin column.
// Sample points are computed as the plain version's `sample_coords`,
// one rounding per operation.
//
// What bounds it on an H100: the latency of its gathers at 16 warps an
// SM (two blocks, held there by the registers a thread takes), far from
// its bytes (PERF.md).  Within that, stages of 52 KB (boxes of at most
// 1664 cells) measured fastest: smaller ones leave more corners to
// global memory, larger ones leave one block an SM.
//
// What does not carry over from the TPU kernel: its x-major [B, W, H,
// C] transpose of the pyramid and its block-diagonal Wy products serve
// the MXU, and its chunk-granular grid serves the sequential TPU grid;
// here the box keeps the NHWC layout.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (aidet_tpu_torch/ops/roi_align.py).

#include "roi_common.cuh"

namespace {

constexpr int kPlanThreads = 1024;   // plan block
constexpr int kBandRows = 48;
constexpr int kBandStride = 16;
constexpr int kWinRows = 32;
// a chunk's row of the table: start, count, row0, then its staged box:
// first row, rows, first column, columns; then one unused int
constexpr int kChunkInts = 8;

// The sample axes of roi r [4] on a level of `stride` pixels, as the
// plain version's sample_coords computes them in float32: the roi's
// first edge and its bin size in level pixels.
__device__ __forceinline__ void roi_axes(const float* __restrict__ r,
                                         int stride, int out_size,
                                         int aligned, float& x1,
                                         float& bin_w, float& y1,
                                         float& bin_h) {
  const float inv = __fdiv_rn(1.0f, static_cast<float>(stride));
  const float off = aligned ? 0.5f : 0.0f;
  x1 = __fsub_rn(__fmul_rn(__ldg(r + 0), inv), off);
  y1 = __fsub_rn(__fmul_rn(__ldg(r + 1), inv), off);
  float w = __fsub_rn(__fsub_rn(__fmul_rn(__ldg(r + 2), inv), off), x1);
  float h = __fsub_rn(__fsub_rn(__fmul_rn(__ldg(r + 3), inv), off), y1);
  if (!aligned) {  // v1 clamps the roi size at 1; aligned mode does not
    w = fmaxf(w, 1.0f);
    h = fmaxf(h, 1.0f);
  }
  bin_w = __fdiv_rn(w, static_cast<float>(out_size));
  bin_h = __fdiv_rn(h, static_cast<float>(out_size));
}

// Sample j of an axis: first + ((j + 0.5) / ratio) * bin.
__device__ __forceinline__ float axis_sample(float first, float bin, int j,
                                             int ratio) {
  const float g =
      __fdiv_rn(static_cast<float>(j) + 0.5f, static_cast<float>(ratio));
  return __fadd_rn(first, __fmul_rn(g, bin));
}

// A sample p on an axis of `size` cells: false outside [-1, size], else
// its clamped corners c0, c1 and the weight l of c1.
__device__ __forceinline__ bool axis_corners(float p, int size, int& c0,
                                             int& c1, float& l) {
  const float fs = static_cast<float>(size);
  if (p < -1.0f || p > fs) return false;
  const float c = fminf(fmaxf(p, 0.0f), fs - 1.0f);
  c0 = static_cast<int>(floorf(c));
  c1 = min(c0 + 1, size - 1);
  l = c - static_cast<float>(c0);
  return true;
}

// ---------------------------------------------------------------- plan

// Exclusive scan of a[0 .. n) in place by the whole block; returns the
// total to every thread.  scratch: 32 ints of shared memory.
__device__ int block_scan(int* a, int n, int* scratch) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(n, t * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = scratch[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? scratch[warp - 1] : 0);
  const int total = scratch[31];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// One stable counting sort of the sequence elem(0 .. k) by bin(e) in
// [0, bins) into out[0 .. k).  Segment w of the sequence (warp w <
// segs) is counted and placed by warp w in order; m [bins * segs]
// holds the counts, then the offsets, bin-major.  If starts is given,
// starts[b] receives the first position of bin b (starts[bins] = k).
template <typename Elem, typename Bin>
__device__ void stable_pass(int k, int bins, int segs, int* m,
                            int* scratch, Elem elem, Bin bin, int* out,
                            int* starts) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int i = t; i < bins * segs; i += kPlanThreads) m[i] = 0;
  __syncthreads();
  const int seg = (k + segs - 1) / segs;
  const int lo = warp * seg;
  const int hi = min(k, lo + seg);
  if (warp < segs) {
    for (int base = lo; base < hi; base += 32) {
      const int p = base + lane;
      const int b = p < hi ? bin(elem(p)) : -1;
      const unsigned same = __match_any_sync(0xffffffffu, b);
      if (b >= 0 && lane == __ffs(same) - 1) {
        m[b * segs + warp] += __popc(same);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  block_scan(m, bins * segs, scratch);
  if (starts != nullptr) {
    for (int b = t; b < bins; b += kPlanThreads) starts[b] = m[b * segs];
    if (t == 0) starts[bins] = k;
    __syncthreads();
  }
  if (warp < segs) {
    const unsigned below = (1u << lane) - 1u;
    for (int base = lo; base < hi; base += 32) {
      const int p = base + lane;
      const int e = p < hi ? elem(p) : 0;
      const int b = p < hi ? bin(e) : -1;
      const unsigned same = __match_any_sync(0xffffffffu, b);
      int* slot = b >= 0 ? m + b * segs + warp : nullptr;
      const int at = b >= 0 ? *slot : 0;
      __syncwarp();
      if (b >= 0) {
        out[at + __popc(same & below)] = e;
        if (lane == __ffs(same) - 1) *slot = at + __popc(same);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// The chunk plan; see the file's head.  work: 7 * num_rois ints of
// scratch (per roi its box, its key, its first column, and the order
// after the first pass).  Dynamic shared memory: bins * segs + 2 *
// (groups + 1) + 32 ints, bins = max(groups, widest level), groups =
// num_images * num_levels * max_bands.
__global__ void __launch_bounds__(kPlanThreads)
    roi_align_bandx_plan_kernel(Levels lv, int num_levels,
                                const float* __restrict__ rois,
                                const int* __restrict__ bidx,
                                const int* __restrict__ lvls, int k,
                                int num_images, int out_size, int ratio,
                                int aligned, int chunk_size,
                                int stage_cells, int segs,
                                int* __restrict__ work,
                                int* __restrict__ perm,
                                int* __restrict__ chunks, int num_chunks) {
  extern __shared__ int plan_smem[];
  int max_bands = 0;
  int max_cols = 1;
  for (int l = 0; l < num_levels; ++l) {
    max_bands = max(max_bands, (lv.h[l] + kBandStride - 1) / kBandStride);
    max_cols = max(max_cols, lv.w[l]);
  }
  ++max_bands;
  const int groups = num_images * num_levels * max_bands;
  const int bins = max(groups, max_cols);
  int* m = plan_smem;
  int* starts = m + bins * segs;        // [groups + 1]
  int* cbase = starts + groups + 1;     // [groups + 1]
  int* scratch = cbase + groups + 1;    // [32]
  int4* box = reinterpret_cast<int4*>(work);  // [k] y0, y1, x0, x1
  int* key = work + 4 * k;              // [k] (image, level, band) key
  int* col = work + 5 * k;              // [k] first sample column
  int* order = work + 6 * k;            // [k] after the first pass
  const int n = out_size * ratio;

  for (int i = threadIdx.x; i < k; i += kPlanThreads) {
    const int l = lvls[i];
    const int h = lv.h[l];
    const int w = lv.w[l];
    float x1, bin_w, y1, bin_h;
    roi_axes(rois + 4 * i, lv.stride[l], out_size, aligned, x1, bin_w, y1,
             bin_h);
    int ylo = h, yhi = -1, xlo = w, xhi = -1;
    int c0, c1;
    float f;
    for (int j = 0; j < n; ++j) {
      if (axis_corners(axis_sample(y1, bin_h, j, ratio), h, c0, c1, f)) {
        ylo = min(ylo, c0);
        yhi = max(yhi, c1);
      }
      if (axis_corners(axis_sample(x1, bin_w, j, ratio), w, c0, c1, f)) {
        xlo = min(xlo, c0);
        xhi = max(xhi, c1);
      }
    }
    if (yhi < 0 || xhi < 0) {  // no sample inside the map
      ylo = h;
      yhi = -1;
      xlo = w;
      xhi = -1;
    }
    // the first sample row and column, clamped to the map, floored
    const float fy0 = axis_sample(y1, bin_h, 0, ratio);
    const float fx0 = axis_sample(x1, bin_w, 0, ratio);
    const int first_y = static_cast<int>(
        floorf(fminf(fmaxf(fy0, 0.0f), static_cast<float>(h - 1))));
    const int first_x = static_cast<int>(
        floorf(fminf(fmaxf(fx0, 0.0f), static_cast<float>(w - 1))));
    const int wy = min(first_y, max(h - min(kWinRows, h), 0));
    key[i] = (bidx[i] * num_levels + l) * max_bands + wy / kBandStride;
    col[i] = first_x;
    box[i] = make_int4(ylo, yhi, xlo, xhi);
  }
  __syncthreads();

  // by first column, then stably by key: sorted by (key, column, index)
  stable_pass(k, max_cols, segs, m, scratch, [](int p) { return p; },
              [&](int e) { return col[e]; }, order, nullptr);
  stable_pass(k, groups, segs, m, scratch, [&](int p) { return order[p]; },
              [&](int e) { return key[e]; }, perm, starts);

  // chunks per key, and each key's first chunk
  for (int g = threadIdx.x; g < groups; g += kPlanThreads) {
    cbase[g] = (starts[g + 1] - starts[g] + chunk_size - 1) / chunk_size;
  }
  __syncthreads();
  const int used = block_scan(cbase, groups, scratch);
  if (threadIdx.x == 0) cbase[groups] = used;
  __syncthreads();

  for (int c = threadIdx.x; c < num_chunks; c += kPlanThreads) {
    int* row = chunks + c * kChunkInts;
    if (c >= used) {
      row[0] = k;
#pragma unroll
      for (int j = 1; j < kChunkInts; ++j) row[j] = 0;
      continue;
    }
    int lo = 0, hi = groups;  // the last key whose first chunk <= c
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (cbase[mid] <= c) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int g = lo;
    const int start = starts[g] + (c - cbase[g]) * chunk_size;
    const int count = min(chunk_size, starts[g + 1] - start);
    const int l = (g / max_bands) % num_levels;
    const int h = lv.h[l];
    const int hp = (h + kBandStride - 1) / kBandStride * kBandStride;
    const int row0 = min((g % max_bands) * kBandStride,
                         max(hp - min(kBandRows, hp), 0));
    int ylo = 1 << 30, yhi = -1, xlo = 1 << 30, xhi = -1;
    for (int p = start; p < start + count; ++p) {
      const int4 b = box[perm[p]];
      ylo = min(ylo, b.x);
      yhi = max(yhi, b.y);
      xlo = min(xlo, b.z);
      xhi = max(xhi, b.w);
    }
    ylo = max(ylo, row0);
    yhi = min(yhi, min(row0 + kBandRows, h) - 1);
    int nrows = 0, ncols = 0;
    if (yhi >= ylo && xhi >= xlo) {
      nrows = yhi - ylo + 1;
      ncols = min(xhi - xlo + 1, stage_cells / nrows);
    } else {
      ylo = 0;
      xlo = 0;
    }
    row[0] = start;
    row[1] = count;
    row[2] = row0;
    row[3] = ylo;
    row[4] = nrows;
    row[5] = xlo;
    row[6] = ncols;
    row[7] = 0;
  }
}

// ----------------------------------------------------------- reduction

constexpr int kSlice = 32;   // bytes of each cell staged at a time
constexpr int kLanes = 2;    // lanes of a bin column: 16 bytes of a slice
constexpr int kKept = 2;     // x samples kept in registers (ratio <= 2)
constexpr int kSlicesPerBlock = 2;  // a block's share of a chunk's slices

// A lane's 16 bytes of a cell's slice (4 float32 or 8 bfloat16
// channels), summed in float32.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int kN = 4;
  __device__ static void fma(const uint4& q, float w, float* acc) {
    const float4 f = *reinterpret_cast<const float4*>(&q);
    acc[0] += w * f.x;
    acc[1] += w * f.y;
    acc[2] += w * f.z;
    acc[3] += w * f.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void fma(const uint4& q, float w, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += w * f.x;
      acc[2 * i + 1] += w * f.y;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The stage slot of cell i of a box (row-major).  A cell's slice is 32
// bytes, four to a row of the 32 banks; XORing the slot's low two bits
// with higher ones spreads cells read together at strides of 1 to 8
// columns over the banks.
__device__ __forceinline__ int swizzle(int i) {
  return i ^ (((i >> 2) ^ (i >> 4) ^ (i >> 6)) & 3);
}

// The reduction's block: kLanes lanes per bin column of each of the
// chunk's rois, rounded up to whole warps (256 at most, since
// out_size * chunk_size <= 128).
__host__ __device__ inline int reduce_threads(int out_size,
                                              int chunk_size) {
  return (kLanes * out_size * chunk_size + 31) / 32 * 32;
}

// Shared memory of a block beside its two stages: each roi's caller
// index, and per sample row and column (out_size * ratio of each) its
// two corners and the weight of the second.
__host__ __device__ inline int plan_bytes(int chunk_size, int out_size,
                                          int ratio) {
  return 4 * chunk_size * (1 + 6 * out_size * ratio);
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
    roi_align_bandx_kernel(Levels lv, int channels,
                           const float* __restrict__ rois,
                           const int* __restrict__ bidx,
                           const int* __restrict__ lvls,
                           const int* __restrict__ perm,
                           const int* __restrict__ chunks, int chunk_size,
                           int stage_bytes, int out_size, int ratio,
                           int aligned, T* __restrict__ out) {
  constexpr int H = Lane<T>::kN;   // channels of a lane
  constexpr int kSliceCh = kSlice / static_cast<int>(sizeof(T));
  extern __shared__ uint4 smem[];

  const int* row = chunks + blockIdx.x * kChunkInts;
  const int count = row[1];
  if (count == 0) return;
  const int start = row[0];
  const int by0 = row[3];
  const int nrows = row[4];
  const int bx0 = row[5];
  const int ncols = min(row[6], stage_bytes / kSlice / max(nrows, 1));
  const int cells = nrows * ncols;
  const int first = perm[start];
  const int l = lvls[first];
  const int height = lv.h[l];
  const int width = lv.w[l];
  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(bidx[first]) * height * width *
                      channels;
  // the ring (its pointers derive from the shared array alone, so that
  // its loads are ld.shared), then the plans
  unsigned char* const ring = reinterpret_cast<unsigned char*>(smem);
  const int n = out_size * ratio;
  int* const roi_of = reinterpret_cast<int*>(ring + 2 * stage_bytes);
  int* const ya_of = roi_of + chunk_size;    // [chunk_size][n] each
  int* const yb_of = ya_of + chunk_size * n;
  float* const ly_of = reinterpret_cast<float*>(yb_of + chunk_size * n);
  int* const xa_of = reinterpret_cast<int*>(ly_of + chunk_size * n);
  int* const xb_of = xa_of + chunk_size * n;
  float* const lx_of = reinterpret_cast<float*>(xb_of + chunk_size * n);

  // the copies of the slice at channel c0 into stage s: thread t copies
  // 16-byte piece t % 2 of every (threads / 2)-th cell
  const int t = threadIdx.x;
  const int piece = t & 1;
  const int step = blockDim.x / 2;
  const int dy = step / max(ncols, 1);
  const int dx = step - dy * max(ncols, 1);
  auto stage = [&](int s, int c0) {
    const int c = c0 + piece * (16 / static_cast<int>(sizeof(T)));
    if (c < channels) {
      int cell = t / 2;
      int y = cell / max(ncols, 1);
      int x = cell - y * max(ncols, 1);
      for (; cell < cells; cell += step) {
        cp_async16(ring + s * stage_bytes + swizzle(cell) * kSlice +
                       piece * 16,
                   feat + (static_cast<size_t>(by0 + y) * width + bx0 + x) *
                              channels + c);
        x += dx;
        y += dy;
        if (x >= ncols) {
          x -= ncols;
          ++y;
        }
      }
    }
    cp_async_commit();
  };
  // this block's slices of the chunk: p0 .. p1 - 1
  const int passes = (channels + kSliceCh - 1) / kSliceCh;
  const int p0 = blockIdx.y * kSlicesPerBlock;
  const int p1 = min(passes, p0 + kSlicesPerBlock);
  stage(0, p0 * kSliceCh);

  // the plans, while the first slice arrives: each roi's sample rows and
  // columns, their corners (-1: outside the map) and weights
  for (int e = t; e < count * n; e += blockDim.x) {
    const int r = e / n;
    const int j = e - r * n;
    const int k = perm[start + r];
    if (j == 0) roi_of[r] = k;
    float x1, bin_w, y1, bin_h;
    roi_axes(rois + 4 * k, lv.stride[l], out_size, aligned, x1, bin_w, y1,
             bin_h);
    int c0, c1;
    float w;
    const int at = r * n + j;
    if (axis_corners(axis_sample(y1, bin_h, j, ratio), height, c0, c1, w)) {
      ya_of[at] = c0;
      yb_of[at] = c1;
      ly_of[at] = w;
    } else {
      ya_of[at] = -1;
    }
    if (axis_corners(axis_sample(x1, bin_w, j, ratio), width, c0, c1, w)) {
      xa_of[at] = c0;
      xb_of[at] = c1;
      lx_of[at] = w;
    } else {
      xa_of[at] = -1;
    }
  }

  // this thread's (roi of the chunk, bin column, half of the slice)
  const int r = t / (kLanes * out_size);
  const int px = (t / kLanes) % out_size;
  const int half = t % kLanes;
  const float inv_count = 1.0f / static_cast<float>(ratio * ratio);
  for (int pass = p0; pass < p1; ++pass) {
    const int c0 = pass * kSliceCh;
    if (pass + 1 < p1) {
      stage((pass - p0 + 1) & 1, c0 + kSliceCh);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int c = c0 + half * H;
    if (r < count && c < channels) {
      const unsigned char* st =
          ring + ((pass - p0) & 1) * stage_bytes + half * 16;
      const T* gl = feat + c;
      const int at = r * n + px * ratio;
      int xa_k[kKept], xb_k[kKept];
      float lx_k[kKept];
#pragma unroll
      for (int ix = 0; ix < kKept; ++ix) {
        xa_k[ix] = ix < ratio ? xa_of[at + ix] : -1;
        xb_k[ix] = ix < ratio ? xb_of[at + ix] : 0;
        lx_k[ix] = ix < ratio ? lx_of[at + ix] : 0.0f;
      }
      // t of one row for this bin column: x samples, 2 corners each, each
      // corner one load, from the stage where the box holds it, else
      // from global memory; the row's loads issue before its FMAs.
      auto row_t = [&](int y, float* acc) {
#pragma unroll
        for (int j = 0; j < H; ++j) acc[j] = 0.0f;
        const bool in_rows =
            static_cast<unsigned>(y - by0) < static_cast<unsigned>(nrows);
        const int base = (y - by0) * ncols - bx0;
        const T* grow = gl + static_cast<size_t>(y) * width * channels;
        auto load = [&](int x) {
          return in_rows && static_cast<unsigned>(x - bx0) <
                                static_cast<unsigned>(ncols)
                     ? *reinterpret_cast<const uint4*>(
                           st + swizzle(base + x) * kSlice)
                     : __ldg(reinterpret_cast<const uint4*>(
                           grow + static_cast<size_t>(x) * channels));
        };
        if (ratio <= kKept) {
          uint4 qa[kKept], qb[kKept];
#pragma unroll
          for (int ix = 0; ix < kKept; ++ix) {
            if (xa_k[ix] >= 0) {
              qa[ix] = load(xa_k[ix]);
              qb[ix] = load(xb_k[ix]);
            }
          }
#pragma unroll
          for (int ix = 0; ix < kKept; ++ix) {
            if (xa_k[ix] >= 0) {
              Lane<T>::fma(qa[ix], 1.0f - lx_k[ix], acc);
              Lane<T>::fma(qb[ix], lx_k[ix], acc);
            }
          }
          return;
        }
        for (int ix = 0; ix < ratio; ++ix) {
          const int xa = xa_of[at + ix];
          if (xa < 0) continue;
          Lane<T>::fma(load(xa), 1.0f - lx_of[at + ix], acc);
          Lane<T>::fma(load(xb_of[at + ix]), lx_of[at + ix], acc);
        }
      };
      float ta[H], tb[H];
      int ra = -1, rb = -1;
      T* dst = out + (static_cast<size_t>(roi_of[r]) * out_size * out_size +
                      px) * channels + c;
      for (int py = 0; py < out_size; ++py) {
        float acc[H];
#pragma unroll
        for (int j = 0; j < H; ++j) acc[j] = 0.0f;
        for (int iy = 0; iy < ratio; ++iy) {
          const int i = r * n + py * ratio + iy;
          const int ya = ya_of[i];
          if (ya < 0) continue;
          const int yb = yb_of[i];
          const float ly = ly_of[i];
          if (ya != ra) {
            if (ya == rb) {
#pragma unroll
              for (int j = 0; j < H; ++j) ta[j] = tb[j];
            } else {
              row_t(ya, ta);
            }
            ra = ya;
          }
          if (yb != rb) {
            if (yb == ra) {
#pragma unroll
              for (int j = 0; j < H; ++j) tb[j] = ta[j];
            } else {
              row_t(yb, tb);
            }
            rb = yb;
          }
#pragma unroll
          for (int j = 0; j < H; ++j) {
            acc[j] += (1.0f - ly) * ta[j] + ly * tb[j];
          }
        }
#pragma unroll
        for (int j = 0; j < H; ++j) acc[j] *= inv_count;
        Lane<T>::store(dst + static_cast<size_t>(py) * out_size * channels,
                       acc);
      }
    }
    __syncthreads();
  }
}

template <typename T>
const void* reduction() {
  return reinterpret_cast<const void*>(roi_align_bandx_kernel<T>);
}

template <typename T>
int launch(const Levels& lv, int channels, const float* rois,
           const int* bidx, const int* lvls, const int* perm,
           const int* chunks, int num_chunks, int chunk_size,
           int stage_bytes, int out_size, int ratio, int aligned, void* out,
           cudaStream_t stream) {
  const int smem =
      2 * stage_bytes + plan_bytes(chunk_size, out_size, ratio);
  const cudaError_t attr = cudaFuncSetAttribute(
      reduction<T>(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int passes = (channels * static_cast<int>(sizeof(T)) + kSlice - 1) /
                     kSlice;
  const dim3 grid(num_chunks,
                  (passes + kSlicesPerBlock - 1) / kSlicesPerBlock);
  roi_align_bandx_kernel<T>
      <<<grid, reduce_threads(out_size, chunk_size), smem,
         stream>>>(lv, channels, rois, bidx, lvls, perm, chunks, chunk_size,
                   stage_bytes, out_size, ratio, aligned,
                   static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan.  h*, w*, st*: the levels' sizes and strides in pixels
// (unused levels 0, 0, 1).  rois [K, 4] float32, bidx and lvls [K]
// int32 in the caller's order, bidx < num_images.  chunk_size rois at
// most per chunk (2 * out_size * chunk_size <= 256), stage_cells the
// cells a staged box may hold.  segs (1..32) warps count and place the
// sort's segments; smem_bytes = 4 * (max(groups, widest level) * segs
// + 2 * (groups + 1) + 32), groups = num_images * num_levels *
// (ceil(max H / 16) + 1), which the caller computes.  work: 7 * K int32
// of scratch; perm [K] int32 receives the caller's roi index of each
// sorted position; chunks [num_chunks, 8] int32 the chunk table (see
// kChunkInts); num_chunks is the static bound ceil(K / chunk_size) +
// num_images * sum(ceil(H_l / 16)).  All device pointers 16-byte
// aligned.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int aidet_roi_align_bandx_plan(
    int device, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
    int w3, int st0, int st1, int st2, int st3, int num_levels,
    const void* rois, const void* bidx, const void* lvls, int num_rois,
    int num_images, int out_size, int sampling_ratio, int aligned,
    int chunk_size, int stage_cells, int segs, int smem_bytes, void* work,
    void* perm, void* chunks, int num_chunks, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || num_rois < 0 || num_images < 1 ||
      chunk_size < 1 ||
      stage_cells < kBandRows || segs < 1 || segs > 32 || num_chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_chunks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Levels lv = make_levels(nullptr, nullptr, nullptr, nullptr, h0, w0,
                                h1, w1, h2, w2, h3, w3, st0, st1, st2, st3);
  const cudaError_t attr = cudaFuncSetAttribute(
      roi_align_bandx_plan_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  roi_align_bandx_plan_kernel<<<1, kPlanThreads, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(
      lv, num_levels, static_cast<const float*>(rois),
      static_cast<const int*>(bidx), static_cast<const int*>(lvls),
      num_rois, num_images, out_size, sampling_ratio, aligned, chunk_size,
      stage_cells, segs, static_cast<int*>(work), static_cast<int*>(perm),
      static_cast<int*>(chunks), num_chunks);
  return static_cast<int>(cudaGetLastError());
}

// The reduction.  dtype: 0 = float32, 1 = bfloat16.  f0..f3 are the
// level maps [B, H_l, W_l, C] (unused ones may be null), st* their
// strides in pixels.  rois [K, 4] float32, bidx and lvls [K] int32, all
// in the caller's order; perm and chunks [num_chunks, 8] from the plan
// on the same rois with the same chunk_size, its stage_cells at most
// stage_bytes / 32.  The cells' 32-byte channel slices are staged
// through two stages of stage_bytes (a multiple of 16); with the plans
// the block takes 2 * stage_bytes + 4 * chunk_size * (1 + 6 * out_size
// * ratio) bytes of shared memory, at most 227 KB.  out [K, out_size,
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
    int num_rois, const void* perm, const void* chunks, int num_chunks,
    int chunk_size, int stage_bytes, int out_size, int sampling_ratio,
    int aligned, void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      out_size > 32 || sampling_ratio < 1 || channels < 1 ||
      num_rois < 0 || num_chunks < 0 || chunk_size < 1 ||
      stage_bytes % 16 || stage_bytes < kBandRows * kSlice ||
      2 * stage_bytes + plan_bytes(chunk_size, out_size, sampling_ratio) >
          227 * 1024) {
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
  const int* ch = static_cast<const int*>(chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && channels % Vec<__nv_bfloat16>::kN == 0) {
    return launch<__nv_bfloat16>(lv, channels, r, b, l, p, ch, num_chunks,
                                 chunk_size, stage_bytes, out_size,
                                 sampling_ratio, aligned, out, s);
  }
  if (dtype == 0 && channels % Vec<float>::kN == 0) {
    return launch<float>(lv, channels, r, b, l, p, ch, num_chunks,
                         chunk_size, stage_bytes, out_size, sampling_ratio,
                         aligned, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the reduction that fit on one SM at once for the dtype (0 =
// float32, 1 = bfloat16) and the chunk_size, stage_bytes, out_size and
// sampling_ratio of a launch (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *blocks.
extern "C" int aidet_roi_align_bandx_occupancy(int device, int dtype,
                                               int chunk_size,
                                               int stage_bytes, int out_size,
                                               int sampling_ratio,
                                               int* blocks) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const void* fn =
      dtype == 1 ? reduction<__nv_bfloat16>() : reduction<float>();
  const int smem =
      2 * stage_bytes + plan_bytes(chunk_size, out_size, sampling_ratio);
  const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, reduce_threads(out_size, chunk_size), smem));
}
