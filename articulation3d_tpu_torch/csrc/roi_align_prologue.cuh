// Per-ROI prologue of the multilevel ROIAlign kernels, shared by
// roi_align_fwd.cu (K1) and roi_align_adj.cu (K2), so that both build
// bit-identical weights and stay an exact linear map and its transpose.
//
// It is the device form of `ops/roi_align_cuda.py::_roi_record` (and of
// the integers of `_prepare`):
//   * detectron2's sqrt-area level (canonical size 224, level 4, eps 1e-8),
//     the level the reference pools every ROI from;
//   * the sample start, bin size and adaptive sample count: ceil(bin), at
//     least 1, uncapped as torchvision samples (Opts::adaptive_cap = 0) or
//     at most Opts::adaptive_cap (the JAX package caps at 4).  Nothing here
//     bounds the count: `sample`, `extent` and `build_row` loop to it;
//   * the cells the ROI reads on its level, per axis the first cell and
//     the count between the bilinear corners of the lowest and highest
//     sample, clipped to the real map: the record (level, y0, x0, ny, nx),
//     ny = 0 for an invalid ROI;
//   * the separable weight rows Ry (P x ny) and Rx (P x nx) from (y0, x0):
//     bilinear corners, zero outside the map, 1/n.
//
// The integers must equal what torch computes on the card, so every float
// operation is rounded on its own, in torch's order (no contraction into
// FMAs: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn), and a division by a
// Python scalar is a multiplication by its float32 reciprocal, as torch's
// CUDA `div` does for a CPU scalar divisor.  `ops/roi_align_cuda.py::
// _roi_record` is the same arithmetic in torch, for the tests.
//
// The min and max of an ROI's samples are taken in closed form: the
// rounded coordinates are monotone in (p, s), so the extremes are the
// first and last sample (swapped for a negative bin).  The corners of
// every sample in between lie in the record's cells, so `build_row`
// writes inside its row with no clamp.

#pragma once

#include <cuda_runtime.h>

namespace roi_prologue {

constexpr int kMaxP = 16;
constexpr int kRecord = 5;   // level, y0, x0, ny, nx (int32 per ROI)

// What the kernels need to know of the options and the pyramid.
struct Opts {
  int P;
  int sampling_ratio;
  int aligned;
  int min_level;
  int adaptive_cap;  // most samples per bin and axis at ratio 0; 0: uncapped
  float scale[4];   // 1 / stride, as float32 (the torch table's values)
  int h[4];         // real level extents
  int w[4];
};

// One axis of an ROI at one level: first sample position, bin size and
// sample count (`_sample_coords`).
struct Axis {
  float start;
  float bin;
  int n;
};

// The prologue's result for one ROI.
struct Record {
  int level, y0, x0, ny, nx;
};

__device__ __forceinline__ float recip(float d) { return __fdiv_rn(1.0f, d); }

__device__ __forceinline__ Axis axis_params(float lo, float hi, float scale,
                                            const Opts& o) {
  const float off = o.aligned ? 0.5f : 0.0f;
  const float a = __fsub_rn(__fmul_rn(lo, scale), off);
  const float b = __fsub_rn(__fmul_rn(hi, scale), off);
  float len = __fsub_rn(b, a);
  if (!o.aligned) len = fmaxf(len, 1.0f);
  Axis ax;
  ax.start = a;
  ax.bin = __fmul_rn(len, recip(static_cast<float>(o.P)));
  if (o.sampling_ratio > 0) {
    ax.n = o.sampling_ratio;
  } else {
    ax.n = max(static_cast<int>(ceilf(ax.bin)), 1);
    if (o.adaptive_cap > 0) ax.n = min(ax.n, o.adaptive_cap);
  }
  return ax;
}

// start + (p + (s + 0.5) / n) * bin
__device__ __forceinline__ float sample(const Axis& ax, int p, int s) {
  const float frac = __fdiv_rn(static_cast<float>(s) + 0.5f, static_cast<float>(ax.n));
  return __fadd_rn(ax.start, __fmul_rn(__fadd_rn(static_cast<float>(p), frac), ax.bin));
}

__device__ __forceinline__ void extent(const Axis& ax, int P, float* lo, float* hi) {
  const float first = sample(ax, 0, 0);
  const float last = sample(ax, P - 1, ax.n - 1);
  *lo = ax.bin >= 0.0f ? first : last;
  *hi = ax.bin >= 0.0f ? last : first;
}

// detectron2 assign_boxes_to_levels, 0-based
__device__ __forceinline__ int base_level(const float* box, const Opts& o) {
  const float bw = fmaxf(__fsub_rn(box[2], box[0]), 0.0f);
  const float bh = fmaxf(__fsub_rn(box[3], box[1]), 0.0f);
  const float t = __fadd_rn(__fmul_rn(__fsqrt_rn(__fmul_rn(bw, bh)), recip(224.0f)), 1e-8f);
  float lvl = floorf(__fadd_rn(4.0f, log2f(t)));
  lvl = fminf(fmaxf(lvl, static_cast<float>(o.min_level)),
              static_cast<float>(o.min_level + 3));
  return static_cast<int>(lvl) - o.min_level;
}

// First cell and cell count between the bilinear corners of the lowest
// and highest sample coordinate, clipped to [0, size) (`_cells`).
__device__ __forceinline__ void cells(float lo, float hi, int size, int* first, int* count) {
  const float last = static_cast<float>(size - 1);
  const float f = floorf(fminf(fmaxf(lo, 0.0f), last));
  const float e = fminf(__fadd_rn(floorf(fminf(fmaxf(hi, 0.0f), last)), 1.0f), last);
  *first = static_cast<int>(f);
  *count = static_cast<int>(e) - static_cast<int>(f) + 1;
}

// The record of one ROI, and its two axes at its level.
__device__ __forceinline__ Record roi_record(const float* box, bool valid, const Opts& o,
                                             Axis* ay_out, Axis* ax_out) {
  Record rec;
  rec.level = base_level(box, o);
  const int l = rec.level;
  const Axis ay = axis_params(box[1], box[3], o.scale[l], o);
  const Axis ax = axis_params(box[0], box[2], o.scale[l], o);
  float ymin, ymax, xmin, xmax;
  extent(ay, o.P, &ymin, &ymax);
  extent(ax, o.P, &xmin, &xmax);
  int ny;
  cells(ymin, ymax, o.h[l], &rec.y0, &ny);
  cells(xmin, xmax, o.w[l], &rec.x0, &rec.nx);
  rec.ny = valid ? ny : 0;
  *ay_out = ay;
  *ax_out = ax;
  return rec;
}

// Row p of one axis's separable weights (`_separable_weights`): row[0, n)
// from the ROI's first cell `origin`, zeroed by the caller (n: the
// record's cell count).  Only the entries the row's samples touch are
// visited.  Returns the first and last non-zero entry (lo > hi when the
// row is all zero).
__device__ __forceinline__ void build_row(float* row, const Axis& ax, int p, int size,
                                          int origin, int n, int* lo_out, int* hi_out) {
  const float hf = static_cast<float>(size);
  int first = n, last = -1;
  for (int s = 0; s < ax.n; ++s) {
    const float c = sample(ax, p, s);
    const bool oor = c < -1.0f || c > hf;
    float y = fmaxf(c, 0.0f);
    const long long yi = static_cast<long long>(y);
    const int y_low = static_cast<int>(min(yi, static_cast<long long>(size - 1)));
    const int y_high = min(y_low + 1, size - 1);
    if (yi >= size - 1) y = static_cast<float>(y_low);
    const float ly = __fsub_rn(y, static_cast<float>(y_low));
    const float hy = __fsub_rn(1.0f, ly);
    const int rl = y_low - origin;
    const int rh = y_high - origin;
    row[rl] = __fadd_rn(row[rl], oor ? 0.0f : hy);
    row[rh] = __fadd_rn(row[rh], oor ? 0.0f : ly);
    first = min(first, rl);
    last = max(last, rh);
  }
  const float cnt = static_cast<float>(max(ax.n, 1));
  int lo = n, hi = -1;
  for (int k = first; k <= last; ++k) {
    const float v = __fdiv_rn(row[k], cnt);
    row[k] = v;
    if (v != 0.0f) {
      lo = min(lo, k);
      hi = k;
    }
  }
  *lo_out = lo;
  *hi_out = hi;
}

}  // namespace roi_prologue
