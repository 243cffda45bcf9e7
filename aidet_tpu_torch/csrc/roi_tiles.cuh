// The tile lists shared by the RoIAlign backward kernels of this
// directory (roi_align_backward.cu, K2's; rroi_align_backward.cu, K4's):
// a gather, tile by tile, in shared memory, with no float atomics.
//
// Each level's [B, H, W] cells are cut into kTile x kTile-cell tiles.
// A kernel's binning pass (its own: it depends on the roi's geometry)
// lists every (roi, bin) once in each tile that a corner of one of the
// bin's samples falls in, in four passes on one stream:
//   zero   counts and the running total;
//   count  one integer atomic per (bin, tile) on the tile's count;
//   place  each warp places 32 lists at once with one atomic on the
//          running total (lists are contiguous, in no fixed order);
//   fill   the same threads as count write each bin index
//          (roi * out_size^2 + bin) at its tile's cursor.
// Its accumulate pass then runs one warp per (tile, 32 16-byte channel
// vectors): lane j owns vector j of all the tile's cells, float32 sums
// in shared memory that no other thread touches, and the warp writes
// the whole tile once, in the gradient's dtype, zeros where no sample
// fell.  The lists live in a scratch buffer sized on the host by the
// upper bound 4 * K * n^2 entries (n = out_size * ratio: every corner
// of every sample in a tile of its own), so no count goes back to the
// host.
//
// Each kernel file defines its own __global__ kernels around these
// bodies, so that a profile names every kernel by its file
// (roi_align_bwd_*, rroi_align_bwd_*).

#pragma once

#include "roi_common.cuh"

namespace {

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

// The scratch buffer's int32 bookkeeping:
//   counts [T] | used [1] | offsets [T] | cursor [T] | entries [bound]
struct Lists {
  int* counts;
  int* used;
  int* offsets;
  int* cursor;
  int* entries;
};

// A backward launch's layout from the C interface's arguments, or
// false for arguments it cannot take: the tiles of num_levels levels
// of `batch` images, the gradient's grad_elems values and the
// scratch's scratch_ints values (3 T + 1 + 4 K n^2) checked against
// them; `lists` receives the scratch's parts.
inline bool tile_layout(const int* hs, const int* ws, const int* sts,
                        int num_levels, int batch, int channels,
                        int num_rois, int out_size, int ratio,
                        long long grad_elems, void* scratch,
                        long long scratch_ints, Tiles& tb, Lists& lists) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1 ||
      out_size > 32 || ratio < 1 || channels < 4 || num_rois < 0 ||
      batch < 1) {
    return false;
  }
  const long long n = static_cast<long long>(out_size) * ratio;
  const long long bound = 4LL * num_rois * n * n;
  if (bound > kMaxInt ||
      static_cast<long long>(num_rois) * out_size * out_size > kMaxInt) {
    return false;
  }
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
      if (hs[i] < 1 || ws[i] < 1) return false;
      elems += static_cast<long long>(batch) * hs[i] * ws[i] * channels;
      tiles += static_cast<long long>(batch) * tb.per_image[i];
    }
  }
  tb.first[num_levels] = static_cast<int>(tiles);
  if (elems != grad_elems || tiles > kMaxInt / 4 ||
      scratch_ints != 3 * tiles + 1 + bound) {
    return false;
  }
  const int nt = static_cast<int>(tiles);
  lists.counts = static_cast<int*>(scratch);
  lists.used = lists.counts + nt;
  lists.offsets = lists.used + 1;
  lists.cursor = lists.offsets + nt;
  lists.entries = lists.cursor + nt;
  return true;
}

// zero: p[0 .. n - 1] = 0, one thread each
__device__ __forceinline__ void zero_ints(int* __restrict__ p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = 0;
}

// count (kFill false) or fill (true) one entry e of tile `tile`
template <bool kFill>
__device__ __forceinline__ void list_entry(int tile, int e,
                                           int* __restrict__ counts,
                                           int* __restrict__ cursor,
                                           int* __restrict__ entries) {
  if (kFill) {
    entries[atomicAdd(cursor + tile, 1)] = e;
  } else {
    atomicAdd(counts + tile, 1);
  }
}

// place: offsets[t] and cursor[t] get the start of a run of counts[t]
// entries.  The lanes of a warp take consecutive runs with one atomic
// on the running total (*used, zeroed before), so the lists are
// contiguous but not in tile order.
__device__ __forceinline__ void place_lists(const int* __restrict__ counts,
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

// The zero, count, place and fill passes on stream s, with the calling
// file's kernels: zero(int*, int) and place(counts, n, used, offsets,
// cursor) wrap the bodies above, bins(fill) launches its binning
// kernel (nothing when there are no rois).  Returns the first error.
template <typename Bins>
cudaError_t build_lists(const Lists& ls, int nt,
                        void (*zero)(int*, int),
                        void (*place)(const int*, int, int*, int*, int*),
                        Bins bins, cudaStream_t s) {
  const int tile_blocks = (nt + 256) / 256;
  zero<<<tile_blocks, 256, 0, s>>>(ls.counts, nt + 1);
  bins(false);
  place<<<tile_blocks, 256, 0, s>>>(ls.counts, nt, ls.used, ls.offsets,
                                    ls.cursor);
  bins(true);
  return cudaGetLastError();
}

// The tile of accumulate block t: its level l, image b, and first row
// and column ty0, tx0 in cells.
__device__ __forceinline__ void tile_at(const Tiles& tb, int num_levels,
                                        int t, int& l, int& b, int& ty0,
                                        int& tx0) {
  l = 0;
  while (l + 1 < num_levels && t >= tb.first[l + 1]) ++l;
  const int local = t - tb.first[l];
  b = local / tb.per_image[l];
  const int r = local % tb.per_image[l];
  ty0 = (r / tb.across[l]) * kTile;
  tx0 = (r % tb.across[l]) * kTile;
}

// The warp's float32 sums: lane j's vector of cell `cell` is the Q =
// V / 4 float4s at tile_sums[(cell * Q + q) * 32 + j], consecutive
// lanes on consecutive banks.
template <typename T>
__device__ __forceinline__ void zero_tile(float4* tile_sums, int lane) {
  constexpr int Q = Vec<T>::kN / 4;
#pragma unroll
  for (int i = 0; i < kCells * Q; ++i) {
    tile_sums[i * 32 + lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Adds w times the lane's vector f into cell `cell`'s sums.
template <typename T>
__device__ __forceinline__ void add_to_cell(float4* tile_sums, int cell,
                                            float w, const float* f,
                                            int lane) {
  constexpr int Q = Vec<T>::kN / 4;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    float4* p = tile_sums + (cell * Q + j) * 32 + lane;
    float4 v = *p;
    v.x += w * f[4 * j];
    v.y += w * f[4 * j + 1];
    v.z += w * f[4 * j + 2];
    v.w += w * f[4 * j + 3];
    *p = v;
  }
}

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

// The warp writes its tile once: every cell inside the map, the lane's
// vector at channel c, in the gradient's dtype.
template <typename T>
__device__ __forceinline__ void write_tile(const Tiles& tb, int l, int b,
                                           int ty0, int tx0, int channels,
                                           int c, const float4* tile_sums,
                                           int lane, T* __restrict__ grad) {
  constexpr int V = Vec<T>::kN;
  constexpr int Q = V / 4;
  const int height = tb.h[l];
  const int width = tb.w[l];
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
    Vec<T>::store(out + (static_cast<size_t>(y) * width + x) * channels, v);
  }
}

}  // namespace
