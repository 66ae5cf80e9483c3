// RoIAlign forward for NVIDIA Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel cim_tpu/ops/pallas/roi_align_kernel.py:_fwd_kernel
// (:151, with its helpers _build_m :108 and _sep_weight :67, reached through
// _forward :269 from roi_align_pallas). It computes
//
//   out[n, y, x, :] = sum_(h, w) Ay[n, y, h] * Ax[n, x, w] * F[h, w, :]
//
// where Ay / Ax are the per-axis bilinear weights of the ROI's sample grid,
// the rows' divided by the sample count. The TPU kernel keeps an (H*W, bc)
// channel block of F in VMEM and runs blocks of ROIs past it on a
// sequential grid (:284-298). This kernel does the same, with the sequential
// grid turned into a loop inside the block and the channel slice held in
// shared memory:
//
//   - a first kernel (fwd_taps_kernel, one block per ROI) writes each ROI's
//     merged per-axis taps: for each bin row the feature rows it taps with
//     their summed weights, the same for each bin column. Its samples come
//     from roi_align_common.cuh, as the backward's do, so the coordinates
//     are bit-identical with the backward's and the plain version's, and
//     the slice blocks of a ROI read them instead of computing them again;
//   - the main kernel (fwd_slice_kernel) gives each block a slice of cs
//     channels (up to 128 bytes a cell) and a group of ROIs (every
//     groups-th, so that large ROIs spread over the groups); the plan is
//     cim_tpu_torch.ops.roi_align._fwd_plan. The block (1024 threads)
//     copies the slice of the valid map, F[0:vh, 0:vw, slice], into shared
//     memory once, with cp.async, and then loops over its ROIs' bins: the
//     lanes of a bin take 16 bytes of its slice each (one lane the whole
//     slice where it is 8 bytes), sum its merged taps from shared memory
//     in f32, in a fixed order, and write the bin's slice once, in the
//     output dtype.
// The row weights carry the division by the sample count, so the result
// differs from the plain version's by f32 rounding only, and is the same
// from run to run, bit for bit.
//
// A batch of B images (the TPU path's vmap over _forward, evaluation's
// cross-image stacks) is a grid dimension: features (B, H, W, C), rois
// (B, N, 4), one valid extent per image, passed by value in the kernels'
// parameters (Extents), and one launch of each kernel whatever B is. A
// slice block stages the valid map of its own image; the plan is that of
// the largest map of the stack. A bin's sum runs over the same taps in the
// same order whichever block computes it, and a warp's extra taps of
// weight zero leave an f32 sum that starts at +0 unchanged, so each image
// gets the bits of a call of its own.
//
// What bounds it on this card (H100 80GB HBM3, 700 W; chip_smoke.py and
// scripts/roi_align_fwd_bench.py): at the eval path's 1200-pass shape,
// 60x76x1024 bf16 (57x75 valid), N 2048, cap 4, it takes 0.35 ms of device
// time (0.42 ms a call with the wrapper's host time, 0.37 back to back)
// against 0.60 for the raw-tap gather it replaces; the function needs one
// read of F's valid cells and one write of the output, 0.0640 ms at the
// HBM rate. Staging and writing alone take 0.10 ms (the bench's copy that
// sums nothing; the output goes out in 32-byte pieces). The sums take the
// rest: 2.6 GB of shared-memory reads, one 16-byte load a lane per tap
// with, around it, an address add, eight integer ops to widen bf16, the
// weight product and eight FMAs; the shared-memory reads and the
// instruction issue bound it together, and bank conflicts cost 3 % (the
// bench's copy that reads neighbouring cells). A warp runs to its largest tap counts, so 78 %
// of its lanes' loads are their own (scripts/roi_align_fwd_counts.py).
// Where a cell's slice is under 32 bytes (stride 8, or f32 at 75x100) every
// piece of the output is a partial sector, and the write dominates.
//
// Interface: plain extern "C" launcher, loaded with ctypes. It launches its
// kernels on the given stream, allocates nothing (the caller passes the
// scratch for the tap tables) and returns the first CUDA error (0 = ok).

#include "roi_align_common.cuh"

namespace {

using roi_align::cp_async16;
using roi_align::cp_async_commit;
using roi_align::cp_async_wait;
using roi_align::Cvt;
using roi_align::kMaxGrid;

// threads of a slice block: one block an SM, its 64 registers a thread
// filling the SM, and as many warps as they allow to hide the latency of
// the loads from shared memory
constexpr int kThreads = 1024;
constexpr int kTapRegs = 8;  // column taps a lane holds in registers at a time
constexpr int kMaxBatch = 32;  // images of a call (the wrapper cuts larger stacks)

// the valid extent (vh, vw) of each image of a call, as a kernel parameter
struct Extents {
  int2 hw[kMaxBatch];
};

// ---------------------------------------------------------------- taps

// One block per ROI, grid.y the image, a thread per (axis, bin), the valid
// extent that of the ROI's image. The table of ROI n of the batch, axis a
// (0 rows, 1 columns) and bin p is the k + 1 entries at
// taps + ((n * 2 + a) * r + p) * (k + 1): entry 0 holds the count of taps,
// entries 1.. each tap as the offset, in bytes, of its row
// (h * vw * cell) or column (w * cell) in a block's staged slice of cell
// bytes a cell, and its weight as float bits. The taps of a bin on one row
// are summed in sample order; taps of zero weight are left out; the rows'
// weights are divided by gh * gw.
__global__ void fwd_taps_kernel(const float* __restrict__ rois,
                                int2* __restrict__ taps, Extents ext, int r,
                                float scale, int sampling_ratio, int cap,
                                int k, int cell) {
  const int n = blockIdx.y * gridDim.x + blockIdx.x;  // the ROI's index in the batch
  const int vh = ext.hw[blockIdx.y].x, vw = ext.hw[blockIdx.y].y;
  const roi_align::RoiGeom geom = roi_align::roi_geom(
      rois + 4 * static_cast<int64_t>(n), scale, r, sampling_ratio, cap);
  for (int t = threadIdx.x; t < 2 * r; t += blockDim.x) {
    const bool is_row = t < r;
    const int p = is_row ? t : t - r;
    const int g = is_row ? geom.gh : geom.gw;
    int idx[2 * kMaxGrid];
    float wt[2 * kMaxGrid];
    int count = 0;
    for (int s = 0; s < g; ++s) {
      const roi_align::AxisSample a =
          is_row ? roi_align::axis_sample(geom.y1, geom.bin_h, g, s, p, vh)
                 : roi_align::axis_sample(geom.x1, geom.bin_w, g, s, p, vw);
      const int ai[2] = {a.lo, a.hi};
      const float aw[2] = {a.wlo, a.whi};
      for (int i = 0; i < 2; ++i) {
        if (aw[i] == 0.0f) continue;
        int j = 0;
        while (j < count && idx[j] != ai[i]) ++j;
        if (j == count) {
          idx[j] = ai[i];
          wt[j] = aw[i];
          ++count;
        } else {
          wt[j] += aw[i];
        }
      }
    }
    const float inv_count = 1.0f / static_cast<float>(geom.gh * geom.gw);
    const int stride = is_row ? vw * cell : cell;
    int2* e = taps + (static_cast<int64_t>(n) * 2 * r + t) * (k + 1);
    e[0] = make_int2(count, 0);
    for (int j = 0; j < count; ++j)
      e[1 + j] = make_int2(idx[j] * stride, __float_as_int(is_row ? wt[j] * inv_count : wt[j]));
  }
}

// ---------------------------------------------------------------- slices

template <int B>
struct Bytes;
template <>
struct Bytes<16> { using type = uint4; };
template <>
struct Bytes<8> { using type = uint2; };

// The VB / sizeof(T) values at p, VB-byte aligned, as floats; a bf16 pair
// takes one integer operation a value (its low half is the even channel).
template <typename T, int VB>
__device__ __forceinline__ void load_vec(const unsigned char* p, float (&v)[VB / sizeof(T)]) {
  using Vec = typename Bytes<VB>::type;
  const Vec raw = *reinterpret_cast<const Vec*>(p);
  const unsigned* u = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
  for (int i = 0; i < VB / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(u[i]);
    } else {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VB>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VB / sizeof(T)]) {
  using Vec = typename Bytes<VB>::type;
  Vec raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VB / static_cast<int>(sizeof(T)); ++i) e[i] = Cvt<T>::from_f(v[i]);
  *reinterpret_cast<Vec*>(p) = raw;
}

// grid.x = slices x groups, the slice fastest, so that the slices of a ROI
// write neighbouring pieces of its output rows at about the same time;
// grid.y = the image of the batch; blockDim.x = kThreads. Block (slice,
// group) of image b reads that image's features, taps and output, with its
// valid extent, and holds channels [c0, c0 + cs)
// of every valid cell in shared memory, cell after cell (channels beyond c
// as zero), and computes them for the bins of ROIs group, group + groups,
// ... A bin takes cs * sizeof(T) / VB neighbouring lanes, each summing
// V = VB / sizeof(T) channels. kVecIO: C * sizeof(T) is a multiple of 16 and
// the pointers are 16-byte aligned, so a slice of 16 bytes or more a cell
// is staged with 16-byte cp.async copies and out is written with VB-byte
// stores; otherwise element by element. kBatch: more than one image. The
// call of one image takes the image as the constant 0, so that its ROI
// loop carries no image index: that index costs the loop 1.4 % of device
// time at the eval 1200 pass, and 3.3 % as offsets of the base pointers
// (H100, scripts/roi_align_fwd_bench.py --profile).
template <typename T, int VB, bool kVecIO, bool kBatch>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_slice_kernel(const T* __restrict__ feat, const int2* __restrict__ taps,
                     T* __restrict__ out, Extents ext, int n, int height,
                     int width, int c, int r, int k, int cs, int groups) {
  constexpr int V = VB / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* fs = reinterpret_cast<T*>(smem);

  const int image = kBatch ? static_cast<int>(blockIdx.y) : 0;
  const int vh = ext.hw[image].x, vw = ext.hw[image].y;
  feat += static_cast<int64_t>(image) * height * width * c;

  const int slices = (c + cs - 1) / cs;
  const int slice = blockIdx.x % slices, group = blockIdx.x / slices;
  const int c0 = slice * cs;
  const int cells = vh * vw;

  if constexpr (kVecIO && VB == 16) {
    const int vecs = cs / V;  // 16-byte vectors of a cell's slice
    for (int i = threadIdx.x; i < cells * vecs; i += blockDim.x) {
      const int cell = i / vecs, ch = c0 + i % vecs * V;
      T* dst = fs + cell * cs + i % vecs * V;
      if (ch < c)
        cp_async16(dst, feat + (static_cast<int64_t>(cell / vw) * width + cell % vw) * c + ch);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < cells * cs; i += blockDim.x) {
      const int cell = i / cs, ch = c0 + i % cs;
      fs[i] = ch < c ? feat[(static_cast<int64_t>(cell / vw) * width + cell % vw) * c + ch]
                     : Cvt<T>::from_f(0.0f);
    }
  }
  __syncthreads();

  const int lanes = cs * static_cast<int>(sizeof(T)) / VB;  // 1, 2, 4 or 8
  const int q = threadIdx.x % lanes;
  const int rr = r * r;
  const int items = group < n ? (n - group + groups - 1) / groups * rr : 0;
  const int step = kThreads / lanes;  // items a round
  const unsigned char* fq = smem + q * VB;  // this lane's piece of the first cell
  // this thread's item as (nth ROI of the group, bin row, bin column),
  // moved on by step items a round without a division
  int nth = threadIdx.x / lanes / rr, py = threadIdx.x / lanes % rr / r, px = threadIdx.x / lanes % r;
  const int dn = step / rr, dpy = step % rr / r, dpx = step % r;
  // every lane runs every round, so that the warp's lanes can agree on
  // their loop bounds; a lane past the last item sums nothing and stores
  // nothing
  for (int base = 0, it = threadIdx.x / lanes; base < items; base += step, it += step) {
    const bool active = it < items;
    // the ROI's index in the batch, which indexes the taps and the output
    const int roi = image * n + group + (active ? nth : 0) * groups;
    const int2* ty = taps + (static_cast<int64_t>(roi) * 2 * r + py) * (k + 1);
    const int2* tx = taps + (static_cast<int64_t>(roi) * 2 * r + r + px) * (k + 1);
    const int bin = py * r + px;
    px += dpx;
    if (px >= r) {
      px -= r;
      ++py;
    }
    py += dpy;
    if (py >= r) {
      py -= r;
      ++nth;
    }
    nth += dn;
    // the counts, the first row and the first kTapRegs columns, in one
    // round trip
    const int ny = active ? __ldg(ty).x : 0, nx = active ? __ldg(tx).x : 0;
    int2 ey = __ldg(ty + 1);
    int2 ex[kTapRegs];
#pragma unroll
    for (int u = 0; u < kTapRegs; ++u) ex[u] = u < k ? __ldg(tx + 1 + u) : make_int2(0, 0);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    // The warp runs to its largest counts; a lane's taps beyond its own
    // count read the slice's first cell with weight zero. Columns in
    // chunks of kTapRegs held in registers, then rows, then the chunk's
    // columns, four at a time while four are left so that their loads are
    // in flight together, then one at a time.
    const int wy_n = __reduce_max_sync(0xffffffffu, ny);
    const int wx_n = __reduce_max_sync(0xffffffffu, nx);
    for (int x0 = 0; x0 < wx_n; x0 += kTapRegs) {
#pragma unroll
      for (int u = 0; u < kTapRegs; ++u) {
        if (x0 > 0) ex[u] = x0 + u < k ? __ldg(tx + 1 + x0 + u) : make_int2(0, 0);
        if (x0 + u >= nx) ex[u] = make_int2(0, 0);
      }
      const int mx = min(wx_n - x0, kTapRegs), quads = mx & ~3;
      if (x0 > 0) ey = __ldg(ty + 1);
      if (ny == 0) ey = make_int2(0, 0);
      for (int i = 0; i < wy_n; ++i) {
        const unsigned char* row = fq + ey.x;
        const float wy = __int_as_float(ey.y);
        ey = i + 1 < ny ? __ldg(ty + 2 + i) : make_int2(0, 0);  // the next row's, in flight
#pragma unroll
        for (int u0 = 0; u0 < kTapRegs; u0 += 4) {
          if (u0 >= quads) break;
          float v[4][V];
#pragma unroll
          for (int u = 0; u < 4; ++u) load_vec<T, VB>(row + ex[u0 + u].x, v[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float w = wy * __int_as_float(ex[u0 + u].y);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(w, v[u][j], acc[j]);
          }
        }
#pragma unroll
        for (int u = 0; u < kTapRegs; ++u) {
          if (u >= mx) break;
          if (u < quads) continue;
          float v[V];
          load_vec<T, VB>(row + ex[u].x, v);
          const float w = wy * __int_as_float(ex[u].y);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(w, v[j], acc[j]);
        }
      }
    }
    if (!active) continue;
    const int ch = c0 + q * V;
    T* dst = out + (static_cast<int64_t>(roi) * rr + bin) * c + ch;
    if constexpr (kVecIO) {
      if (ch < c) store_vec<T, VB>(dst, acc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (ch + j < c) dst[j] = Cvt<T>::from_f(acc[j]);
    }
  }
}

using LaunchFn = int (*)(const void*, const float*, void*, int2*, const Extents&,
                         int, int, int, int, int, int, float, int, int, int,
                         int, int, int, cudaStream_t);

template <typename T, int VB, bool kVecIO>
int launch(const void* feat, const float* rois, void* out, int2* taps,
           const Extents& ext, int batch, int n, int height, int width, int c,
           int r, float scale, int sampling_ratio, int cap, int k, int cs,
           int groups, int smem, cudaStream_t stream) {
  fwd_taps_kernel<<<dim3(n, batch), 32, 0, stream>>>(rois, taps, ext, r, scale,
                                                     sampling_ratio, cap, k,
                                                     cs * static_cast<int>(sizeof(T)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = batch > 1 ? fwd_slice_kernel<T, VB, kVecIO, true>
                          : fwd_slice_kernel<T, VB, kVecIO, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (c + cs - 1) / cs;
  kernel<<<dim3(slices * groups, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(feat), taps, static_cast<T*>(out), ext, n, height,
      width, c, r, k, cs, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
LaunchFn pick_io(bool vec) {
  return vec ? launch<T, VB, true> : launch<T, VB, false>;
}

template <typename T>
LaunchFn pick(int vb, bool vec) {
  return vb == 16 ? pick_io<T, 16>(vec) : pick_io<T, 8>(vec);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. features (B, H, W, C) contiguous;
// rois (B, N, 4) float32 xyxy in image coordinates; valid_hw, in host
// memory, the 2 * B ints vh_0, vw_0, vh_1, ... of the images' valid
// extents (1 <= vh <= H, 1 <= vw <= W), copied into the kernels'
// parameters; out (B, N, R, R, C) in the feature dtype, every element
// written. scratch, 8-byte aligned, holds the tap tables: B * N * 2 * R *
// (2 * grid + 1) pairs of 32-bit words, grid the samples a bin and axis
// (sampling_ratio, or cap when it is 0). cs (channels of a slice, a power
// of two of 8 to 128 bytes), groups (of ROIs) and smem (the largest
// vh * vw of the batch times cs times the element size, bytes) are the plan
// of cim_tpu_torch.ops.roi_align._fwd_plan; a plan that does not fit this
// build is refused. Returns the first CUDA error of the launches (0 = ok).
extern "C" int roi_align_fwd_batched(const void* feat, const void* rois,
                                     void* out, int batch, int n, int height,
                                     int width, int c, const int* valid_hw,
                                     int r, float spatial_scale,
                                     int sampling_ratio, int cap, int dtype,
                                     void* stream, void* scratch, int cs,
                                     int groups, int smem) {
  if (batch < 1 || batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const int grid = sampling_ratio > 0 ? sampling_ratio : cap;
  const int cell = cs * size;
  Extents ext{};
  int cells = 0;
  for (int b = 0; b < batch; ++b) {
    const int vh = valid_hw[2 * b], vw = valid_hw[2 * b + 1];
    if (vh < 1 || vh > height || vw < 1 || vw > width)
      return static_cast<int>(cudaErrorInvalidValue);
    ext.hw[b] = make_int2(vh, vw);
    cells = max(cells, vh * vw);
  }
  if (size == 0 || r < 1 || groups < 1 || cs < 1 || (cs & (cs - 1)) != 0 ||
      cell < 8 || cell > 128 || grid < 1 || grid > kMaxGrid || smem != cells * cell)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = roi_align::aligned16(feat) && roi_align::aligned16(out) &&
                   (c * size) % 16 == 0;
  const int vb = cell < 16 ? cell : 16;
  const LaunchFn fn = dtype == 0 ? pick<float>(vb, vec) : pick<__nv_bfloat16>(vb, vec);
  return fn(feat, static_cast<const float*>(rois), out, static_cast<int2*>(scratch), ext,
            batch, n, height, width, c, r, spatial_scale, sampling_ratio, cap, 2 * grid,
            cs, groups, smem, static_cast<cudaStream_t>(stream));
}

// The call of one image: features (H, W, C), rois (N, 4), out (N, R, R, C)
// and its valid extent (vh, vw); otherwise as roi_align_fwd_batched. The
// package makes every call through roi_align_fwd_batched; this is the
// interface of earlier builds, through which scripts/roi_align_fwd_bench.py
// times them beside this one.
extern "C" int roi_align_fwd(const void* feat, const void* rois, void* out,
                             int n, int height, int width, int c, int vh,
                             int vw, int r, float spatial_scale,
                             int sampling_ratio, int cap, int dtype,
                             void* stream, void* scratch, int cs, int groups,
                             int smem) {
  const int valid_hw[2] = {vh, vw};
  return roi_align_fwd_batched(feat, rois, out, 1, n, height, width, c, valid_hw, r,
                               spatial_scale, sampling_ratio, cap, dtype, stream,
                               scratch, cs, groups, smem);
}
