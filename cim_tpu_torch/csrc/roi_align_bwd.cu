// RoIAlign backward for NVIDIA Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel cim_tpu/ops/pallas/roi_align_kernel.py:_bwd_kernel
// (:169, reached through _bwd_rule, the custom_vjp of roi_align_pallas). It
// computes the transposed map of the forward, summed over all ROIs:
//
//   dF[h, w, :] = sum_(n, y, x) Ay[n, y, h] * Ax[n, x, w] * g[n, y, x, :]
//
// where Ay / Ax are the per-axis bilinear weights of the ROI's sample grid,
// the rows' divided by the sample count. The TPU kernel keeps a channel
// slice of dF resident in VMEM and runs the ROIs past it on a sequential
// grid (:179-187). This kernel does the same with the sequential grid
// turned into a loop inside the block, and the slice of dF held on chip in
// registers:
//
//   - a first kernel (bwd_taps_kernel, one block per ROI) writes each ROI's
//     merged taps, transposed: for every feature row h the weights of the
//     ROI's bins y on it (Ay[n, :, h]) with the first and the count of
//     those bins, the same for every column, and the ROI's rectangle of
//     tapped cells. Its samples come from roi_align_common.cuh, as the
//     forward's do, so the backward scatters to exactly the cells, with
//     exactly the coordinates, that the forward gathers;
//   - the main kernel (bwd_tile_kernel) gives each block a 4 x 4 tile of
//     cells x a slice of 1024 channels. Each of its 8 warps holds two
//     cells, each lane 32 channels of both, as f32 sums in registers, so no
//     two threads ever add into the same place: there are no atomics. The
//     block lists the ROIs whose rectangle meets its tile, in ROI order,
//     and runs them through a ring of cp.async stages in shared memory,
//     each holding the ROI's bins of g that tap the tile (found from the
//     tap tables) and the tile's rows and columns of the tables. A warp
//     then adds, for each of its cells, the bins that tap it;
//   - the epilogue writes the tile once, in the output dtype, with 16-byte
//     stores; cells of a padded bucket beyond the valid extent are never
//     tapped and are written as zero. The wrapper allocates dF with
//     torch.empty: no zero fill and no cast pass. Where there are too few
//     tiles to fill the card, the plan splits the ROIs into runs whose f32
//     partial sums a last small kernel adds up, in order.
// Each cell's sum runs in ROI order, then bin order, so the result is the
// same from run to run, bit for bit; it differs from the plain version's
// index_add_ order by f32 rounding only.
//
// What bounds it on this card (H100 80GB HBM3, 700 W; the train shape of
// chip_smoke.py, 60x76x1024 bf16, N 2048, cap 4: 0.44-0.49 ms there and in
// scripts/roi_align_bwd_bench.py, against 1.74-1.77 ms for the atomic-add
// kernel this replaces): the add loop, whose shared-memory loads and FMAs
// run in warps that meet at a barrier once per ROI (0.40 ms with g left
// unstaged), then the staging of g from the L2 (0.22 ms with the adds left
// out), which mostly hides under it. The function itself needs one read of
// g and one write of dF, 0.0641 ms at the HBM rate.
//
// Interface: plain extern "C" launcher, loaded with ctypes. It launches its
// kernels on the given stream, allocates nothing (the caller passes the
// scratch for the tap tables and partial sums) and returns the first CUDA
// error (0 = ok).

#include "roi_align_common.cuh"

namespace {

using roi_align::AxisSample;
using roi_align::cp_async16;
using roi_align::cp_async_commit;
using roi_align::cp_async_wait;
using roi_align::Cvt;
using roi_align::kMaxGrid;

constexpr int kMaxR = 7;      // bins per axis the tap tables hold
constexpr int kEntry = 8;     // words of a table entry: kMaxR weights, then the bin range
constexpr int kTile = 4;      // a block's tile of dF: kTile x kTile cells
constexpr int kWarps = 8;     // warps of a block, two cells each
constexpr int kLaneCh = 32;   // channels a lane sums for each of its cells
constexpr int kSlice = 32 * kLaneCh;  // channels of a block's slice
constexpr int kSlotBytes = 28 * 1024;  // bins of g a stage holds: 14 bf16, 7 f32
constexpr int kStages = 3;            // cp.async ring depth
constexpr int kListCap = 2048;       // list entries a block holds

// Measurement switches, never set by the package's build:
// scripts/roi_align_bwd_bench.py defines ROI_ALIGN_BWD_NO_ADD (stage g, add
// nothing) or ROI_ALIGN_BWD_NO_STAGE (add from shared memory that holds no
// g) to time the kernel without one of its two halves.

// ---------------------------------------------------------------- taps

// One block per ROI. rows[(n * height + h) * kEntry + y] = Ay[n, y, h] /
// (gh * gw) for bins y < r, and word kMaxR = first tapping bin | count << 8
// (count 0: no bin taps row h); cols the same for columns, without the
// division. rects[n] = (first row, last row, first column, last column)
// with any tap; first > last when there is none.
__global__ void bwd_taps_kernel(const float* __restrict__ rois,
                                float* __restrict__ rows,
                                float* __restrict__ cols,
                                int4* __restrict__ rects, int height,
                                int width, int vh, int vw, int r, float scale,
                                int sampling_ratio, int cap) {
  __shared__ AxisSample ys[kMaxR * kMaxGrid];
  __shared__ AxisSample xs[kMaxR * kMaxGrid];
  __shared__ int lo[2], hi[2];

  const int n = blockIdx.x;
  const roi_align::RoiGeom geom = roi_align::roi_geom(
      rois + 4 * static_cast<int64_t>(n), scale, r, sampling_ratio, cap);
  const int gh = geom.gh, gw = geom.gw;
  for (int i = threadIdx.x; i < r * (gh + gw); i += blockDim.x) {
    if (i < r * gh) {
      ys[i] = roi_align::axis_sample(geom.y1, geom.bin_h, gh, i % gh, i / gh, vh);
    } else {
      const int j = i - r * gh;
      xs[j] = roi_align::axis_sample(geom.x1, geom.bin_w, gw, j % gw, j / gw, vw);
    }
  }
  if (threadIdx.x < 2) {
    lo[threadIdx.x] = 0x7fffffff;
    hi[threadIdx.x] = -1;
  }
  __syncthreads();

  const float inv_count = 1.0f / static_cast<float>(gh * gw);
  for (int i = threadIdx.x; i < height + width; i += blockDim.x) {
    const bool is_row = i < height;
    const int idx = is_row ? i : i - height;
    const int g = is_row ? gh : gw;
    const AxisSample* s = is_row ? ys : xs;
    float w[kMaxR];
    int first = r, last = -1;
#pragma unroll
    for (int p = 0; p < kMaxR; ++p) {
      w[p] = 0.0f;
      if (p >= r) continue;
      // the bin's taps on idx, summed in sample order as merge_axis did
      bool tapped = false;
      for (int k = 0; k < g; ++k) {
        const AxisSample a = s[p * g + k];
        if (a.wlo != 0.0f && a.lo == idx) {
          w[p] += a.wlo;
          tapped = true;
        }
        if (a.whi != 0.0f && a.hi == idx) {
          w[p] += a.whi;
          tapped = true;
        }
      }
      if (tapped) {
        first = min(first, p);
        last = p;
      }
      if (is_row) w[p] *= inv_count;
    }
    const int count = last >= first ? last - first + 1 : 0;
    float4* e = reinterpret_cast<float4*>(
        (is_row ? rows + (static_cast<int64_t>(n) * height + idx) * kEntry
                : cols + (static_cast<int64_t>(n) * width + idx) * kEntry));
    e[0] = make_float4(w[0], w[1], w[2], w[3]);
    e[1] = make_float4(w[4], w[5], w[6], __int_as_float(first | (count << 8)));
    if (count > 0) {
      atomicMin(&lo[is_row ? 0 : 1], idx);  // shared memory
      atomicMax(&hi[is_row ? 0 : 1], idx);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) rects[n] = make_int4(lo[0], hi[0], lo[1], hi[1]);
}

// ---------------------------------------------------------------- tiles

// The bins p of one axis whose samples can tap a cell of [t0, t1], as
// first | last << 8, or -1 if none: a superset of the exact taps, from the
// bin's extent [start, start + bin] widened by one cell on each side
// against the rounding of the sample coordinates.
__device__ int bin_span(float start, float bin, int r, int valid, int t0,
                        int t1) {
  int first = r, last = -1;
  const float top = static_cast<float>(valid - 1);
  for (int p = 0; p < r; ++p) {
    const float a = start + static_cast<float>(p) * bin;
    const float b = a + bin;
    const float lo = fminf(floorf(fmaxf(fminf(a, b), 0.0f)), top) - 1.0f;
    const float hi = fminf(floorf(fmaxf(fmaxf(a, b), 0.0f)) + 1.0f, top) + 1.0f;
    if (lo <= static_cast<float>(t1) && hi >= static_cast<float>(t0)) {
      first = min(first, p);
      last = p;
    }
  }
  return first <= last ? first | (last << 8) : -1;
}

// The bins that tap cells [a, b] of one axis, as first | last << 8, from
// the tap table of one ROI: the samples run in order along the axis (the
// other way for a box drawn backwards), so the bins of the cells between
// lie between those of a and b. -1 if a or b is tapped by none (a gap
// between the samples of a wide bin).
__device__ __forceinline__ int table_span(const float* table, int a, int b) {
  const int ea = __float_as_int(table[a * kEntry + kMaxR]);
  const int eb = __float_as_int(table[b * kEntry + kMaxR]);
  if ((ea >> 8) == 0 || (eb >> 8) == 0) return -1;
  const int first = min(ea & 0xff, eb & 0xff);
  const int last = max((ea & 0xff) + (ea >> 8) - 1, (eb & 0xff) + (eb >> 8) - 1);
  return first | (last << 8);
}

// A block's tile: kTile x kTile cells x kSlice channels. Warp i holds two
// cells of it, (i / 4, i % 4) and (i / 4 + 2, (i % 4 + 2) % 4): one in each
// half of the rows and one in each half of the columns, so a ROI that
// covers part of the tile gives the warps about the same work. Lane l holds
// kLaneCh channels of each cell, in 16-byte vectors j at channel
// (32 j + l) * kVec of the slice, so a warp's loads and stores of a vector
// are contiguous.
template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);     // channels of a vector
  static constexpr int kVecs = kLaneCh / kVec;    // vectors a lane and cell
  static constexpr int kBins = kSlotBytes / (kSlice * sizeof(T));  // bins a stage
  static_assert(kBins >= kMaxR, "a stage holds a whole row of bins");
  __device__ static int row(int k, int warp) { return warp / 4 + 2 * k; }
  __device__ static int col(int k, int warp) { return (warp % 4 + 2 * k) % 4; }
};

__host__ __device__ constexpr int stage_bytes() {
  return kSlotBytes + 2 * kTile * kEntry * 4;
}

__host__ __device__ constexpr int tile_smem() {
  return kListCap * 8 + kStages * stage_bytes();
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Tile<T>::kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {  // bf16 pairs: the low half is the even channel
    const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// grid.x = splits x slices x tiles; blockDim.x = 32 x kWarps. A block adds
// the ROIs of its split, the split-th of `splits` equal runs of them: with
// one split it writes dF, with more its f32 partial sum, which
// bwd_sum_kernel adds up. kVecIO: C is a multiple of kVec and the pointers
// are 16-byte aligned, so g is staged with cp.async and dF written with
// 16-byte stores; otherwise element by element.
template <typename T, bool kVecIO>
__global__ void __launch_bounds__(32 * kWarps, 2)
    bwd_tile_kernel(const T* __restrict__ grad, const float* __restrict__ rois,
                    const int4* __restrict__ rects,
                    const float* __restrict__ rows,
                    const float* __restrict__ cols, T* __restrict__ dfeat,
                    float* __restrict__ partial, int splits, int n,
                    int height, int width, int c, int vh, int vw, int r,
                    float scale, int sampling_ratio, int cap) {
  constexpr int V = Tile<T>::kVec, NV = Tile<T>::kVecs, B = Tile<T>::kBins;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kWarps];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_w = (width + kTile - 1) / kTile;
  const int tiles = (height + kTile - 1) / kTile * tiles_w;
  const int slices = (c + kSlice - 1) / kSlice;
  const int tile = blockIdx.x % tiles;
  const int slice = blockIdx.x / tiles % slices;
  const int split = blockIdx.x / tiles / slices;
  const int h0 = tile / tiles_w * kTile, w0 = tile % tiles_w * kTile;
  const int h1 = min(h0 + kTile, height) - 1, w1 = min(w0 + kTile, width) - 1;
  const int c0 = slice * kSlice;
  const int rr = r * r;

  int2* list = reinterpret_cast<int2*>(smem);
  auto slots = [&](int buf) {
    return reinterpret_cast<T*>(smem + kListCap * 8 + buf * stage_bytes());
  };
  auto row_tab = [&](int buf) {
    return reinterpret_cast<float*>(smem + kListCap * 8 + buf * stage_bytes() + kSlotBytes);
  };
  auto col_tab = [&](int buf) { return row_tab(buf) + kTile * kEntry; };

  // Copy list entry j, its ROI's tap table entries for the tile and its
  // bins (y0..y1) x (x0..x1) of g, into stage buf.
  auto fetch = [&](int j, int buf) {
    const int roi = list[j].x, span = list[j].y;
    const int y0 = span & 0xff, y1 = (span >> 8) & 0xff;
    const int x0 = (span >> 16) & 0xff, x1 = (span >> 24) & 0xff;
    if (threadIdx.x < 4 * kTile) {
      const int e = threadIdx.x / 2, half = threadIdx.x % 2;
      if (e < kTile) {
        if (h0 + e < height)
          cp_async16(row_tab(buf) + e * kEntry + 4 * half,
                     rows + (static_cast<int64_t>(roi) * height + h0 + e) * kEntry + 4 * half);
      } else if (w0 + e - kTile < width) {
        cp_async16(col_tab(buf) + (e - kTile) * kEntry + 4 * half,
                   cols + (static_cast<int64_t>(roi) * width + w0 + e - kTile) * kEntry + 4 * half);
      }
    }
#ifdef ROI_ALIGN_BWD_NO_STAGE
    return;
#endif
    const int nx = x1 - x0 + 1, nbins = (y1 - y0 + 1) * nx;
    for (int b = warp; b < nbins; b += kWarps) {
      const int bin = (y0 + b / nx) * r + x0 + b % nx;
      const T* src = grad + (static_cast<int64_t>(roi) * rr + bin) * c + c0;
      T* dst = slots(buf) + b * kSlice;
      for (int ch = lane * V; ch < kSlice; ch += 32 * V) {
        if constexpr (kVecIO) {
          if (c0 + ch < c) cp_async16(dst + ch, src + ch);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            dst[ch + i] = c0 + ch + i < c ? src[ch + i] : Cvt<T>::from_f(0.0f);
        }
      }
    }
  };

  float acc[2][NV][V];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][j][i] = 0.0f;

  // Add list entry j, in stage buf, into this warp's two cells.
  auto add = [&](int j, int buf) {
#ifdef ROI_ALIGN_BWD_NO_ADD
    return;
#endif
    const int span = list[j].y;
    const int ey0 = span & 0xff, ey1 = (span >> 8) & 0xff;
    const int ex0 = (span >> 16) & 0xff, enx = ((span >> 24) & 0xff) - ex0 + 1;
    const T* gs = slots(buf) + lane * V;
    int yr[2], xr[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      yr[k] = __float_as_int(row_tab(buf)[Tile<T>::row(k, warp) * kEntry + kMaxR]);
      xr[k] = __float_as_int(col_tab(buf)[Tile<T>::col(k, warp) * kEntry + kMaxR]);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = Tile<T>::row(k, warp), col = Tile<T>::col(k, warp);
      // entries of rows or columns beyond the map were not copied
      if (h0 + row >= height || w0 + col >= width) continue;
      const int ya = max(yr[k] & 0xff, ey0);
      const int yb = min((yr[k] & 0xff) + (yr[k] >> 8) - 1, ey1);
      const int xa = xr[k] & 0xff, nx = xr[k] >> 8;
      const float* wy = row_tab(buf) + row * kEntry;
      const float* wx = col_tab(buf) + col * kEntry + xa;
      for (int y = ya; y <= yb; ++y) {
        const T* g = gs + ((y - ey0) * enx + xa - ex0) * kSlice;
        for (int x = 0; x < nx; ++x) {
          const float wt = wy[y] * wx[x];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float val[V];
            load_vec<T>(g + x * kSlice + v * 32 * V, val);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[k][v][i] = fmaf(wt, val[i], acc[k][v][i]);
          }
        }
      }
    }
  };

  const int first = static_cast<int>(static_cast<int64_t>(split) * n / splits);
  const int last = static_cast<int>(static_cast<int64_t>(split + 1) * n / splits);
  int next = first;
  while (next < last) {
    // list the ROIs that reach the tile, in ROI order, a round of 256 at a
    // time while the list has room; a ROI with more bins than a stage holds
    // takes one entry for each run of bin rows that fits
    int m = 0;
    while (next < last) {
      const int i = next + threadIdx.x;
      int span = -1, entries = 0, rows_per = 1;
      if (i < last) {
        const int4 rc = rects[i];
        if (rc.x <= h1 && rc.y >= h0 && rc.z <= w1 && rc.w >= w0) {
          int sy = table_span(rows + static_cast<int64_t>(i) * height * kEntry,
                              max(h0, rc.x), min(h1, rc.y));
          int sx = table_span(cols + static_cast<int64_t>(i) * width * kEntry,
                              max(w0, rc.z), min(w1, rc.w));
          if (sy < 0 || sx < 0) {
            const roi_align::RoiGeom geom = roi_align::roi_geom(
                rois + 4 * static_cast<int64_t>(i), scale, r, sampling_ratio, cap);
            if (sy < 0) sy = bin_span(geom.y1, geom.bin_h, r, vh, h0, h1);
            if (sx < 0) sx = bin_span(geom.x1, geom.bin_w, r, vw, w0, w1);
          }
          if (sy >= 0 && sx >= 0) {
            span = sy | (sx << 16);
            rows_per = B / ((sx >> 8) - (sx & 0xff) + 1);
            entries = ((sy >> 8) - (sy & 0xff) + rows_per) / rows_per;
          }
        }
      }
      // block-wide exclusive prefix sum of the entries, in ROI order
      int incl = entries;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      int at = m + incl - entries, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += warp_sum[w];
        total += warp_sum[w];
      }
      __syncthreads();
      if (m + total > kListCap) break;  // the same for every thread
      for (int e = 0; e < entries; ++e) {
        const int ya = (span & 0xff) + e * rows_per;
        const int yb = min(ya + rows_per - 1, (span >> 8) & 0xff);
        list[at + e] = make_int2(i, ya | (yb << 8) | (span & 0xffff0000));
      }
      m += total;
      next += 32 * kWarps;
    }
    __syncthreads();

    // run the listed entries through the ring
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < m) fetch(j, j);
      cp_async_commit();
    }
    for (int j = 0; j < m; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage j is in; every warp is done with stage j - 1
      if (j + kStages - 1 < m) fetch(j + kStages - 1, (j + kStages - 1) % kStages);
      cp_async_commit();
      add(j, j % kStages);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next list overwrites this one
  }

  // write the tile once: dF in the output dtype, or the split's f32 sum
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int h = h0 + Tile<T>::row(k, warp), w = w0 + Tile<T>::col(k, warp);
    if (h >= height || w >= width) continue;
    const int64_t cell = (static_cast<int64_t>(h) * width + w) * c;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int ch = c0 + (v * 32 + lane) * V;
      if (ch >= c) continue;
      if (splits == 1) {
        T* dst = dfeat + cell + ch;
        if constexpr (kVecIO) {
          uint4 raw;
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int i = 0; i < V; ++i) e[i] = Cvt<T>::from_f(acc[k][v][i]);
          *reinterpret_cast<uint4*>(dst) = raw;
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (ch + i < c) dst[i] = Cvt<T>::from_f(acc[k][v][i]);
        }
      } else {
        float* dst = partial + static_cast<int64_t>(split) * height * width * c + cell + ch;
        if constexpr (kVecIO) {
#pragma unroll
          for (int i = 0; i < V; i += 4)
            *reinterpret_cast<float4*>(dst + i) = make_float4(
                acc[k][v][i], acc[k][v][i + 1], acc[k][v][i + 2], acc[k][v][i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (ch + i < c) dst[i] = acc[k][v][i];
        }
      }
    }
  }
}

// dF = the sum of the splits' partial sums, in split order, in the output
// dtype.
template <typename T>
__global__ void bwd_sum_kernel(const float* __restrict__ partial,
                               T* __restrict__ dfeat, int64_t count,
                               int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    float s = partial[i];
    for (int k = 1; k < splits; ++k) s += partial[k * count + i];
    dfeat[i] = Cvt<T>::from_f(s);
  }
}

template <typename T, bool kVecIO>
int launch(const void* grad, const float* rois, void* dfeat, void* scratch,
           int n, int height, int width, int c, int vh, int vw, int r,
           float scale, int sampling_ratio, int cap, int splits, int smem,
           cudaStream_t stream) {
  if (smem != tile_smem())
    return static_cast<int>(cudaErrorInvalidValue);
  int4* rects = static_cast<int4*>(scratch);
  float* rows = reinterpret_cast<float*>(rects + n);
  float* cols = rows + static_cast<int64_t>(n) * height * kEntry;
  float* partial = cols + static_cast<int64_t>(n) * width * kEntry;
  if (n > 0) {
    bwd_taps_kernel<<<n, 128, 0, stream>>>(rois, rows, cols, rects, height,
                                            width, vh, vw, r, scale,
                                            sampling_ratio, cap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = bwd_tile_kernel<T, kVecIO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = splits * ((c + kSlice - 1) / kSlice) *
                     ((height + kTile - 1) / kTile) * ((width + kTile - 1) / kTile);
  kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(grad), rois, rects, rows, cols,
      static_cast<T*>(dfeat), partial, splits, n, height, width, c, vh, vw,
      r, scale, sampling_ratio, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t count = static_cast<int64_t>(height) * width * c;
  const int64_t sum_blocks = (count + 255) / 256;
  bwd_sum_kernel<T><<<static_cast<int>(sum_blocks < 4096 ? sum_blocks : 4096), 256, 0,
                      stream>>>(partial, static_cast<T*>(dfeat), count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of grad and dfeat): 0 = float32, 1 = bfloat16. grad (N, R, R, C)
// contiguous; rois (N, 4) float32 xyxy in image coordinates; dfeat
// (H, W, C) receives the gradient, every element written. scratch, 16-byte
// aligned, holds the tap tables, N * (4 + (H + W) * 8) 32-bit words, then,
// with more than one split, the splits' partial sums, splits * H * W * C
// floats. splits (runs of ROIs summed apart) and smem (a block's dynamic
// shared memory in bytes) are the plan of
// cim_tpu_torch.ops.roi_align._bwd_plan; a plan that does not match this
// build's tiles is refused. R <= 7. Returns the first CUDA error of
// the launches (0 = ok).
extern "C" int roi_align_bwd(const void* grad, const void* rois, void* dfeat,
                             int n, int height, int width, int c, int vh,
                             int vw, int r, float spatial_scale,
                             int sampling_ratio, int cap, int dtype,
                             void* stream, void* scratch, int splits,
                             int smem) {
  if (c == 0) return static_cast<int>(cudaGetLastError());
  if (r < 1 || r > kMaxR || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = roi_align::aligned16(grad) && roi_align::aligned16(dfeat);
  int (*fn)(const void*, const float*, void*, void*, int, int, int, int, int,
            int, int, float, int, int, int, int, cudaStream_t);
  if (dtype == 0) {
    fn = aligned && c % Tile<float>::kVec == 0 ? launch<float, true>
                                               : launch<float, false>;
  } else if (dtype == 1) {
    fn = aligned && c % Tile<__nv_bfloat16>::kVec == 0
             ? launch<__nv_bfloat16, true>
             : launch<__nv_bfloat16, false>;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(grad, static_cast<const float*>(rois), dfeat, scratch, n, height,
            width, c, vh, vw, r, spatial_scale, sampling_ratio, cap, splits,
            smem, static_cast<cudaStream_t>(stream));
}
