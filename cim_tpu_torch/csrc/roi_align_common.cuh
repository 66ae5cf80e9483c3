// Shared pieces of the RoIAlign forward and backward kernels
// (roi_align_fwd.cu, roi_align_bwd.cu): the ROI geometry, the per-axis
// bilinear samples, the dtype conversions and cp.async. Both kernels take
// their sample rows, columns and weights from here, so the backward scatters
// to exactly the cells, with exactly the weights, that the forward gathers.
//
// Semantics (mmcv RoIAlign, aligned=True, as cim_tpu.ops.roi_align):
//   - coordinates are roi * spatial_scale - 0.5, no minimum ROI size;
//   - sampling_ratio > 0 takes that many samples per bin and axis;
//     sampling_ratio == 0 takes clip(ceil(bin), 1, cap) of them;
//   - bilinear taps snap to the valid extent (vh, vw) of a zero-padded
//     feature bucket; samples beyond [-1, v] contribute zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align {

constexpr int kMaxGrid = 64;  // samples per bin and axis; checked by the wrapper

struct AxisSample {
  int lo, hi;      // tap rows (or columns), already snapped to the valid extent
  float wlo, whi;  // bilinear weights, zero when the sample is out of range
};

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};

// One ROI's start, bin size and sample count along each axis.
struct RoiGeom {
  float x1, y1, bin_w, bin_h;
  int gh, gw;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* roi, float scale,
                                            int r, int sampling_ratio,
                                            int cap) {
  RoiGeom g;
  g.x1 = __fsub_rn(__fmul_rn(roi[0], scale), 0.5f);
  g.y1 = __fsub_rn(__fmul_rn(roi[1], scale), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), 0.5f);
  g.bin_w = __fdiv_rn(__fsub_rn(x2, g.x1), static_cast<float>(r));
  g.bin_h = __fdiv_rn(__fsub_rn(y2, g.y1), static_cast<float>(r));
  if (sampling_ratio > 0) {
    g.gh = g.gw = sampling_ratio;
  } else {
    g.gh = static_cast<int>(fminf(fmaxf(ceilf(g.bin_h), 1.0f), static_cast<float>(cap)));
    g.gw = static_cast<int>(fminf(fmaxf(ceilf(g.bin_w), 1.0f), static_cast<float>(cap)));
  }
  return g;
}

// One sample along one axis. The explicit _rn intrinsics keep nvcc from
// contracting the coordinate arithmetic into FMAs, so coordinates round
// exactly as the plain PyTorch version's do and a sample on a tap boundary
// falls on the same side in both.
__device__ __forceinline__ AxisSample axis_sample(float lo, float bin, int g,
                                                  int s, int p, int valid) {
  float start = __fadd_rn(lo, __fmul_rn(static_cast<float>(p), bin));
  float step = __fdiv_rn(bin, static_cast<float>(g));
  float coord = __fadd_rn(start, __fmul_rn(static_cast<float>(s) + 0.5f, step));
  AxisSample out;
  bool in_range = !(coord < -1.0f || coord > static_cast<float>(valid));
  coord = fmaxf(coord, 0.0f);
  int low = static_cast<int>(floorf(coord));
  bool at_edge = low >= valid - 1;
  low = min(low, valid - 1);
  out.lo = low;
  out.hi = min(low + 1, valid - 1);
  float l = at_edge ? 0.0f : __fsub_rn(coord, static_cast<float>(low));
  float h = __fsub_rn(1.0f, l);
  out.wlo = in_range ? h : 0.0f;
  out.whi = in_range ? l : 0.0f;
  return out;
}

// 16-byte copies from global to shared memory that complete
// asynchronously (sm_80 and later); a group is committed, then waited for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace roi_align
