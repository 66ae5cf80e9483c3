// Greedy NMS over precomputed IoU matrices for NVIDIA Hopper (sm_90a),
// written by hand in CUDA C++.
//
// Replaces no TPU kernel. cim_tpu resolves CIM mining's per-class seed NMS
// (cim_tpu/ops/nms.py:32, greedy_nms_from_iou; reference
// lib/modeling/heads.py:237-258) with (K, K) reductions inside a
// lax.while_loop, which XLA runs on the TPU without the host. The port's
// plain form of that loop (cim_tpu_torch/ops/nms.py) tests a device value on
// the host once a round, so on the card each round drained the queue, and a
// CUDA graph could not hold it. This kernel decides the whole NMS on the
// card, with no host test, so that mining can be captured as one graph.
//
// One block per batch row (one class of one image), K <= 1024 candidates:
//
//   - the row's overlaps become bits in shared memory: mask[j][w] bit b says
//     iou[32 w + b, j] >= thresh, i.e. a kept j suppresses that candidate
//     (the plain loop's m[..., i, j], row i suppressed by column j). A warp
//     takes a 32 x 32 tile: lane l owns column j = 32 tc + l and reads the
//     tile's 32 rows one after the other, each read coalesced across lanes;
//   - each thread ranks candidates by (score descending, index ascending),
//     the plain loop's stable sort, invalid entries scored -1e30 as there;
//   - one warp walks the ranks in order. Lane w holds word w of the removed
//     bits, starting as the invalid entries; a candidate that is not removed
//     is kept, and its mask row is or-ed into the removed bits. Invalid
//     entries are never kept and so never suppress.
//
// The result is the plain loop's keep mask, bit for bit: both give the
// greedy outcome, in which a valid candidate is kept iff no kept candidate
// of higher rank overlaps it at iou >= thresh. Scores compare as floats
// (-0.0 equals 0.0); NaN ranks below every number, as the sort puts it.
//
// What bounds it on this card (H100 80GB HBM3, 700 W): at K 256 and 20
// classes the rows hold 5.2 MB of IoU, 1.6 us at the HBM rate, read once
// into the bit masks; then one warp's K dependent steps of the walk (a
// shuffle and a shared load each) and the ranks' K^2 compares, in 20
// blocks on 132 SMs. It takes 0.0237 ms on the device (chip_smoke.py
// phase nms, launches captured in a graph), against the plain loop's
// 1.14 ms with its host tests; latency, not bytes, sets that time, and a
// step runs it 12 times inside the mining graphs.
//
// Interface: plain extern "C" launcher, loaded with ctypes. It launches on
// the given stream, allocates nothing and returns the first CUDA error
// (0 = ok).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 1024;  // 32 words of removed bits, one a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool ranks_before(float sj, int j, float si, int i) {
  // j before i in (score descending, index ascending); NaN last
  const bool nj = isnan(sj), ni = isnan(si);
  if (nj || ni) return ni && (!nj || j < i);
  return sj > si || (sj == si && j < i);
}

__global__ void __launch_bounds__(kThreads)
nms_from_iou_kernel(const float* __restrict__ iou, const float* __restrict__ scores,
                    const bool* __restrict__ valid, bool* __restrict__ keep, int k,
                    float thresh) {
  extern __shared__ uint32_t smem[];
  const int words = (k + 31) / 32;
  uint32_t* mask = smem;                      // k x words
  float* s = reinterpret_cast<float*>(mask + k * words);  // k
  int* order = reinterpret_cast<int*>(s + k);             // k: index at each rank
  uint32_t* valid_bits = reinterpret_cast<uint32_t*>(order + k);  // words

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = kThreads / 32;
  const size_t row = blockIdx.x;
  iou += row * k * k;
  scores += row * k;
  valid += row * k;
  keep += row * k;

  for (int i = tid; i < k; i += kThreads) {
    s[i] = valid[i] ? scores[i] : -1e30f;
    keep[i] = false;
  }
  for (int w = warp; w < words; w += warps) {
    const int i = 32 * w + lane;
    const uint32_t bits = __ballot_sync(kFull, i < k && valid[i]);
    if (lane == 0) valid_bits[w] = bits;
  }
  for (int t = warp; t < words * words; t += warps) {
    const int tr = t / words, j = (t % words) * 32 + lane;
    if (j < k) {
      uint32_t bits = 0;
      const int rows = min(32, k - 32 * tr);
      const float* col = iou + static_cast<size_t>(32 * tr) * k + j;
#pragma unroll 8
      for (int b = 0; b < rows; ++b) {
        bits |= static_cast<uint32_t>(col[static_cast<size_t>(b) * k] >= thresh) << b;
      }
      mask[j * words + tr] = bits;
    }
  }
  __syncthreads();

  for (int i = tid; i < k; i += kThreads) {
    const float si = s[i];
    int r = 0;
    for (int j = 0; j < k; ++j) r += ranks_before(s[j], j, si, i);
    order[r] = i;
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t removed = lane < words ? ~valid_bits[lane] : kFull;
    for (int r = 0; r < k; ++r) {
      const int i = order[r];
      const uint32_t word = __shfl_sync(kFull, removed, i >> 5);
      if (!((word >> (i & 31)) & 1u)) {  // the same branch in every lane
        if (lane < words) removed |= mask[i * words + lane];
        if (lane == 0) keep[i] = true;
      }
    }
  }
}

size_t smem_bytes(int k) {
  const int words = (k + 31) / 32;
  return sizeof(uint32_t) * (static_cast<size_t>(k) * words + 2 * k + words);
}

}  // namespace

// iou (batch, k, k) float32, scores (batch, k) float32, valid (batch, k)
// bool, keep (batch, k) bool, all contiguous on the device.
extern "C" int nms_from_iou(const void* iou, const void* scores, const void* valid,
                            void* keep, int batch, int k, float thresh, void* stream) {
  if (batch == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (batch < 0 || k < 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  // above the default 48 KB a block must opt in; done once, at the largest K
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_from_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxK)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem_bytes(kMaxK);
  }
  nms_from_iou_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<const bool*>(valid), static_cast<bool*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
