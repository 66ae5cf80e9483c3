// RoIAlign forward for NVIDIA Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel cim_tpu/ops/pallas/roi_align_kernel.py:_fwd_kernel
// (with its helpers _build_m and _sep_weight, entry roi_align_pallas). It
// computes the same function, not the same blocks: the TPU kernel builds a
// Kronecker weight matrix and runs one (BN*49, H*W) @ (H*W, C) matmul per
// ROI block because the MXU wants matmuls. Here each output value is a
// direct weighted sum of at most cap^2 * 4 feature taps.
//
// Semantics: those of roi_align_common.cuh (mmcv RoIAlign, aligned=True,
// as cim_tpu.ops.roi_align); sums are f32, the output takes the feature
// dtype (f32 or bf16).
//
// What bounds it on this card: reads of the feature map. A bin reads up to
// 16 samples x 4 taps x C values, so at the eval shape (N = 2048 ROIs,
// C = 1024, cap 4) the kernel gathers up to ~13 GB in bf16 while writing
// only N*49*C values (0.2 GB). The map itself is small: 60x76x1024 bf16 is
// 9.3 MB, which stays resident in the 50 MB L2, so the gathers are served
// from L2 rather than HBM.
//
// What the design does about it: one block per (ROI, output bin); the
// block computes its sample rows and columns once, in shared memory
// (bilinear weights factor per axis, so gh + gw entries describe all
// gh * gw samples); threads run across channels of the HWC map with
// 16-byte loads where C allows, so a warp reads contiguous 512-byte rows
// of each tap. Tiles in shared memory, TMA and wgmma are for later work.
//
// Interface: plain extern "C" launcher, loaded with ctypes. It launches on
// the given stream, allocates nothing and returns cudaGetLastError().

#include "roi_align_common.cuh"

namespace {

using roi_align::AxisSample;
using roi_align::Cvt;
using roi_align::kMaxGrid;

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = Cvt<T>::to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = Cvt<T>::to_f(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = Cvt<T>::from_f(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = Cvt<T>::from_f(v[i]);
  }
}

// grid.x = N * R * R, one block per (ROI, output bin); each thread owns V
// consecutive channels and strides over C by blockDim.x * V.
template <typename T, int V>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int width, int c,
                                     int vh, int vw, int r, float scale,
                                     int sampling_ratio, int cap) {
  __shared__ AxisSample ys[kMaxGrid];
  __shared__ AxisSample xs[kMaxGrid];

  const int bin = blockIdx.x % (r * r);
  const int n = blockIdx.x / (r * r);
  const int py = bin / r;
  const int px = bin % r;

  const roi_align::RoiGeom geom = roi_align::roi_geom(
      rois + 4 * static_cast<int64_t>(n), scale, r, sampling_ratio, cap);
  const int gh = geom.gh, gw = geom.gw;
  roi_align::bin_samples(geom, py, px, vh, vw, ys, xs);
  __syncthreads();

  const float count = static_cast<float>(gh * gw);
  T* dst = out + static_cast<int64_t>(blockIdx.x) * c;
  for (int c0 = threadIdx.x * V; c0 < c; c0 += blockDim.x * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int iy = 0; iy < gh; ++iy) {
      const AxisSample sy = ys[iy];
      const int64_t row_lo = static_cast<int64_t>(sy.lo) * width;
      const int64_t row_hi = static_cast<int64_t>(sy.hi) * width;
      for (int ix = 0; ix < gw; ++ix) {
        const AxisSample sx = xs[ix];
        const int64_t tap[4] = {row_lo + sx.lo, row_lo + sx.hi,
                                row_hi + sx.lo, row_hi + sx.hi};
        const float w[4] = {sy.wlo * sx.wlo, sy.wlo * sx.whi,
                            sy.whi * sx.wlo, sy.whi * sx.whi};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v[V];
          load_vec<T, V>(feat + tap[t] * c + c0, v);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += w[t] * v[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] /= count;
    store_vec<T, V>(dst + c0, acc);
  }
}

template <typename T, int V>
void launch(const void* feat, const float* rois, void* out, int n, int width,
            int c, int vh, int vw, int r, float scale, int sampling_ratio,
            int cap, cudaStream_t stream) {
  int groups = (c + V - 1) / V;
  int threads = ((groups + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dim3 grid(static_cast<unsigned>(n) * r * r);
  roi_align_fwd_kernel<T, V><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feat), rois, static_cast<T*>(out), width, c, vh,
      vw, r, scale, sampling_ratio, cap);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. features (H, W, C) contiguous; rois
// (N, 4) float32 xyxy in image coordinates; out (N, R, R, C) in the
// feature dtype. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int roi_align_fwd(const void* feat, const void* rois, void* out,
                             int n, int height, int width, int c, int vh,
                             int vw, int r, float spatial_scale,
                             int sampling_ratio, int cap, int dtype,
                             void* stream) {
  (void)height;
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(rois);
  bool vec = roi_align::aligned16(feat) && roi_align::aligned16(out);
  if (dtype == 0) {
    if (vec && c % 4 == 0)
      launch<float, 4>(feat, rf, out, n, width, c, vh, vw, r, spatial_scale,
                       sampling_ratio, cap, s);
    else
      launch<float, 1>(feat, rf, out, n, width, c, vh, vw, r, spatial_scale,
                       sampling_ratio, cap, s);
  } else if (dtype == 1) {
    if (vec && c % 8 == 0)
      launch<__nv_bfloat16, 8>(feat, rf, out, n, width, c, vh, vw, r,
                               spatial_scale, sampling_ratio, cap, s);
    else
      launch<__nv_bfloat16, 1>(feat, rf, out, n, width, c, vh, vw, r,
                               spatial_scale, sampling_ratio, cap, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
