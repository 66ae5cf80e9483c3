// Host-side native kernels for cim_tpu (C++17, no external deps).
//
// TPU-native replacement for the reference's Cython kernels:
//  - nms / soft_nms: lib/utils/cython_nms.c behavior (detectron +1 area
//    convention, suppression at ovr >= thresh), used by eval-time
//    post-processing where the data lives on host anyway;
//  - bbox_overlaps: lib/utils/cython_bbox.c pairwise IoU;
//  - rle_encode: column-major run-length counts (pycocotools maskApi
//    rleEncode), the hot inner loop of instance-seg result export.
//
// Bound via ctypes (cim_tpu_torch/native/__init__.py); compiled on first use
// with g++ -O3 -march=native.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// dets: (n, 5) [x1,y1,x2,y2,score]; out_keep: capacity n; returns count.
int nms(const float* dets, int n, float thresh, int* out_keep) {
  if (n == 0) return 0;
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + 1.f) * (d[3] - d[1] + 1.f);
  }
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<char> suppressed(n, 0);
  int count = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    out_keep[count++] = i;
    const float* di = dets + i * 5;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      float xx1 = std::max(di[0], dj[0]);
      float yy1 = std::max(di[1], dj[1]);
      float xx2 = std::min(di[2], dj[2]);
      float yy2 = std::min(di[3], dj[3]);
      float w = std::max(0.f, xx2 - xx1 + 1.f);
      float h = std::max(0.f, yy2 - yy1 + 1.f);
      float inter = w * h;
      float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr >= thresh) suppressed[j] = 1;
    }
  }
  return count;
}

// boxes: (n,4), query: (k,4) xyxy; out: (n,k) IoU with +1 areas.
void bbox_overlaps(const float* boxes, int n, const float* query, int k,
                   float* out) {
  for (int j = 0; j < k; ++j) {
    const float* q = query + j * 4;
    float q_area = (q[2] - q[0] + 1.f) * (q[3] - q[1] + 1.f);
    for (int i = 0; i < n; ++i) {
      const float* b = boxes + i * 4;
      float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.f;
      float ov = 0.f;
      if (iw > 0) {
        float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.f;
        if (ih > 0) {
          float ua =
              (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f) + q_area - iw * ih;
          ov = iw * ih / ua;
        }
      }
      out[i * k + j] = ov;
    }
  }
}

// mask: (h, w) uint8 row-major; out_counts capacity h*w+1; returns count
// of runs (column-major order, first run is zeros).
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* out_counts) {
  int m = 0;
  uint32_t run = 0;
  uint8_t cur = 0;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      uint8_t v = mask[y * w + x] ? 1 : 0;
      if (v != cur) {
        out_counts[m++] = run;
        run = 0;
        cur = v;
      }
      ++run;
    }
  }
  out_counts[m++] = run;
  return m;
}

// soft-NMS (cython_nms.soft_nms semantics). boxes: (n,5) modified in
// place; out_inds capacity n; method 0=hard 1=linear 2=gaussian.
// Returns surviving count.
int soft_nms(float* boxes, int n, float sigma, float nt, float threshold,
             int method, int* out_inds) {
  std::vector<int> inds(n);
  std::iota(inds.begin(), inds.end(), 0);
  int N = n;
  for (int i = 0; i < N; ++i) {
    int maxpos = i;
    for (int pos = i + 1; pos < N; ++pos)
      if (boxes[pos * 5 + 4] > boxes[maxpos * 5 + 4]) maxpos = pos;
    for (int c = 0; c < 5; ++c) std::swap(boxes[i * 5 + c], boxes[maxpos * 5 + c]);
    std::swap(inds[i], inds[maxpos]);
    float tx1 = boxes[i * 5], ty1 = boxes[i * 5 + 1], tx2 = boxes[i * 5 + 2],
          ty2 = boxes[i * 5 + 3];
    float tarea = (tx2 - tx1 + 1.f) * (ty2 - ty1 + 1.f);
    for (int pos = i + 1; pos < N; ++pos) {
      float x1 = boxes[pos * 5], y1 = boxes[pos * 5 + 1],
            x2 = boxes[pos * 5 + 2], y2 = boxes[pos * 5 + 3];
      float area = (x2 - x1 + 1.f) * (y2 - y1 + 1.f);
      float iw = std::min(tx2, x2) - std::max(tx1, x1) + 1.f;
      float ih = std::min(ty2, y2) - std::max(ty1, y1) + 1.f;
      if (iw > 0 && ih > 0) {
        float ov = iw * ih / (tarea + area - iw * ih);
        float weight = 1.f;
        if (method == 1)
          weight = ov > nt ? 1.f - ov : 1.f;
        else if (method == 2)
          weight = std::exp(-(ov * ov) / sigma);
        else
          weight = ov >= nt ? 0.f : 1.f;
        boxes[pos * 5 + 4] *= weight;
        if (boxes[pos * 5 + 4] < threshold) {
          for (int c = 0; c < 5; ++c)
            boxes[pos * 5 + c] = boxes[(N - 1) * 5 + c];
          inds[pos] = inds[N - 1];
          --N;
          --pos;
        }
      }
    }
  }
  for (int i = 0; i < N; ++i) out_inds[i] = inds[i];
  return N;
}

// counts -> COCO LEB-style base-48 string (maskApi.c rleToString).
// out capacity: 8 * m chars. Returns string length.
int rle_to_string(const uint32_t* counts, int m, char* out) {
  int p = 0;
  for (int i = 0; i < m; ++i) {
    long long x = (long long)counts[i];
    if (i > 2) x -= (long long)counts[i - 2];
    bool more = true;
    while (more) {
      long long c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[p++] = (char)(c + 48);
    }
  }
  return p;
}

// COCO counts string -> counts (maskApi.c rleFrString). out capacity:
// len(s) entries is always enough. Returns number of counts.
int rle_from_string(const char* s, int len, uint32_t* out_counts) {
  int m = 0, i = 0;
  while (i < len) {
    long long x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      long long c = (long long)s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += (long long)out_counts[m - 2];
    out_counts[m++] = (uint32_t)x;
  }
  return m;
}

// counts -> (h, w) uint8 row-major mask (column-major runs). Runs are
// clamped to the h*w canvas so malformed/truncated counts can never write
// out of bounds (the Python fallback pads/truncates; keep parity).
void rle_decode(const uint32_t* counts, int m, int h, int w, uint8_t* mask) {
  const long long total = (long long)h * (long long)w;
  long long pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < m && pos < total; ++i) {
    if (val) {
      long long run_end = pos + (long long)counts[i];
      if (run_end > total) run_end = total;
      for (long long p = pos; p < run_end; ++p) {
        mask[(p % h) * w + (p / h)] = 1;  // column-major -> row-major
      }
    }
    pos += counts[i];
    val ^= 1;
  }
}

// Intersection area of two column-major RLEs over the same h*w canvas
// (pycocotools maskApi.c rleArea-of-merge walk, specialized to 2 inputs).
static long long rle_inter(const uint32_t* a, int ma, const uint32_t* b,
                           int mb) {
  long long inter = 0;
  long long ca = ma > 0 ? a[0] : 0, cb = mb > 0 ? b[0] : 0;
  int ia = 1, ib = 1;
  uint8_t va = 0, vb = 0;
  while (ia <= ma && ib <= mb) {
    long long c = ca < cb ? ca : cb;
    if (va && vb) inter += c;
    ca -= c;
    cb -= c;
    if (ca == 0 && ia < ma) {
      ca = a[ia++];
      va ^= 1;
    } else if (ca == 0) {
      break;
    }
    if (cb == 0 && ib < mb) {
      cb = b[ib++];
      vb ^= 1;
    } else if (cb == 0) {
      break;
    }
  }
  return inter;
}

// Pairwise mask IoU straight from RLE counts (no decode).
// dts/gts: concatenated counts with offsets (CSR-ish). iscrowd: per-gt
// flag -> union = dt area. out: (d, g) doubles, row-major.
void rle_iou(const uint32_t* dt_counts, const int* dt_off, int d,
             const uint32_t* gt_counts, const int* gt_off, int g,
             const uint8_t* iscrowd, double* out) {
  std::vector<double> da(d), ga(g);
  for (int i = 0; i < d; ++i) {
    double a = 0;
    for (int k = dt_off[i] + 1; k < dt_off[i + 1]; k += 2) a += dt_counts[k];
    da[i] = a;
  }
  for (int j = 0; j < g; ++j) {
    double a = 0;
    for (int k = gt_off[j] + 1; k < gt_off[j + 1]; k += 2) a += gt_counts[k];
    ga[j] = a;
  }
  for (int j = 0; j < g; ++j) {
    for (int i = 0; i < d; ++i) {
      double inter = (double)rle_inter(
          dt_counts + dt_off[i], dt_off[i + 1] - dt_off[i],
          gt_counts + gt_off[j], gt_off[j + 1] - gt_off[j]);
      double uni = iscrowd[j] ? da[i] : da[i] + ga[j] - inter;
      out[i * g + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

}  // extern "C"
