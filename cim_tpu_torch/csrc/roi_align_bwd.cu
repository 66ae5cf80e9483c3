// RoIAlign backward for NVIDIA Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel cim_tpu/ops/pallas/roi_align_kernel.py:_bwd_kernel
// (reached through _bwd_rule, the custom_vjp of roi_align_pallas). It
// computes the transposed map of the forward, summed over all ROIs:
//
//   dF[h, w, :] = sum_(n, y, x) Ay[n, y, h] * Ax[n, x, w] * g[n, y, x, :]
//
// where Ay / Ax are the per-axis bilinear weights of the ROI's sample grid,
// divided by the sample count. The TPU kernel runs this as one transposed
// (H*W, BN*49) @ (BN*49, C) matmul per ROI block and carries dF across the
// sequential grid in its output block. Blocks on this card run in parallel
// and in no order, so the sum across ROIs is taken with atomics instead.
//
// What bounds it on this card: the atomic adds. The function itself needs
// one read of g (N*49*C values) and one write of dF (H*W*C), ~0.2 GB in
// bf16 at the train shape (N = 2048, C = 1024). But every (ROI, bin) adds
// into up to (2*cap)^2 cells per channel, so the kernel issues ~25 f32
// atomic adds per element of g at cap 4, all into a dF of only a few MB
// that lives in the 50 MB L2; their throughput in the L2, not HBM, sets
// the time.
//
// What the design does about it:
//   - one block per (ROI, output bin), as the forward; the block computes
//     its sample rows and columns once in shared memory, with the same
//     code as the forward (roi_align_common.cuh), so the scatter hits the
//     cells the forward gathered, bit for bit in the coordinates;
//   - taps that land on the same row (or column) within a bin are merged
//     per axis before any add: the bilinear weight factors per axis, so
//     the bin's contribution to cell (h, w) is Wy[h] * Wx[w] * g with
//     Wy, Wx the summed per-axis weights. That cuts the adds of a bin from
//     4 * gh * gw to (distinct rows) * (distinct columns), about 25 instead
//     of 64 at cap 4, and drops taps of weight zero;
//   - threads run across channels, one channel per thread and step, so a
//     warp's 32 adds hit one contiguous 128-byte line of dF;
//   - the adds go into a zeroed (H*W, C) f32 scratch that the wrapper
//     allocates and casts once to the feature dtype afterwards, so bf16
//     features get one rounding (the TPU kernel accumulates in bf16).
// The order of the atomic adds varies from run to run, so the f32 sums do
// too, by a few ulp of the sum of the terms' magnitudes.
//
// Interface: plain extern "C" launcher, loaded with ctypes. It launches on
// the given stream, allocates nothing and returns cudaGetLastError().

#include "roi_align_common.cuh"

namespace {

using roi_align::AxisSample;
using roi_align::Cvt;
using roi_align::kMaxGrid;

struct AxisTap {
  int idx;  // feature row (or column)
  float w;  // summed bilinear weight of the bin's samples on it
};

// Merge the taps of one axis: sample s adds (lo, wlo) and (hi, whi); taps
// on the same row are summed and taps of weight zero dropped. Returns the
// number of distinct taps written to out (at most 2 * g).
__device__ int merge_axis(const AxisSample* s, int g, AxisTap* out) {
  int n = 0;
  for (int i = 0; i < g; ++i) {
    const int idx[2] = {s[i].lo, s[i].hi};
    const float w[2] = {s[i].wlo, s[i].whi};
    for (int t = 0; t < 2; ++t) {
      if (w[t] == 0.0f) continue;
      int j = 0;
      while (j < n && out[j].idx != idx[t]) ++j;
      if (j == n) {
        out[n].idx = idx[t];
        out[n].w = 0.0f;
        ++n;
      }
      out[j].w += w[t];
    }
  }
  return n;
}

// grid.x = N * R * R, one block per (ROI, output bin); thread t handles
// channels t, t + blockDim.x, ...
template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad,
                                     const float* __restrict__ rois,
                                     float* __restrict__ dfeat, int width,
                                     int c, int vh, int vw, int r,
                                     float scale, int sampling_ratio,
                                     int cap) {
  __shared__ AxisSample ys[kMaxGrid];
  __shared__ AxisSample xs[kMaxGrid];
  __shared__ AxisTap ty[2 * kMaxGrid];
  __shared__ AxisTap tx[2 * kMaxGrid];
  __shared__ int ny, nx;

  const int bin = blockIdx.x % (r * r);
  const int n = blockIdx.x / (r * r);
  const int py = bin / r;
  const int px = bin % r;

  const roi_align::RoiGeom geom = roi_align::roi_geom(
      rois + 4 * static_cast<int64_t>(n), scale, r, sampling_ratio, cap);
  roi_align::bin_samples(geom, py, px, vh, vw, ys, xs);
  __syncthreads();
  if (threadIdx.x == 0) ny = merge_axis(ys, geom.gh, ty);
  if (threadIdx.x == (blockDim.x > 32 ? 32 : 0)) nx = merge_axis(xs, geom.gw, tx);
  __syncthreads();

  const float inv_count = 1.0f / static_cast<float>(geom.gh * geom.gw);
  const T* src = grad + static_cast<int64_t>(blockIdx.x) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float gv = Cvt<T>::to_f(src[ch]) * inv_count;
    if (gv == 0.0f) continue;  // padding ROIs carry zero gradient
    for (int iy = 0; iy < ny; ++iy) {
      const AxisTap sy = ty[iy];
      const float gy = gv * sy.w;
      float* row = dfeat + static_cast<int64_t>(sy.idx) * width * c + ch;
      for (int ix = 0; ix < nx; ++ix) {
        const AxisTap sx = tx[ix];
        atomicAdd(row + static_cast<int64_t>(sx.idx) * c, gy * sx.w);
      }
    }
  }
}

template <typename T>
void launch(const void* grad, const float* rois, float* dfeat, int n,
            int width, int c, int vh, int vw, int r, float scale,
            int sampling_ratio, int cap, cudaStream_t stream) {
  int threads = ((c + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  dim3 grid(static_cast<unsigned>(n) * r * r);
  roi_align_bwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(grad), rois, dfeat, width, c, vh, vw, r, scale,
      sampling_ratio, cap);
}

}  // namespace

// dtype (of grad): 0 = float32, 1 = bfloat16. grad (N, R, R, C)
// contiguous; rois (N, 4) float32 xyxy in image coordinates; dfeat
// (H, W, C) float32, zeroed by the caller, receives the sum. Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int roi_align_bwd(const void* grad, const void* rois, void* dfeat,
                             int n, int height, int width, int c, int vh,
                             int vw, int r, float spatial_scale,
                             int sampling_ratio, int cap, int dtype,
                             void* stream) {
  (void)height;
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  float* df = static_cast<float*>(dfeat);
  if (dtype == 0) {
    launch<float>(grad, rf, df, n, width, c, vh, vw, r, spatial_scale,
                  sampling_ratio, cap, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(grad, rf, df, n, width, c, vh, vw, r,
                          spatial_scale, sampling_ratio, cap, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
