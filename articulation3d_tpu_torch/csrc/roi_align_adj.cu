// Multilevel FPN ROIAlign adjoint (gradient with respect to the features)
// for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_adjoint_kernel_factory` in
// articulation3d_tpu/ops/roi_align_pallas.py:519-586, launched by
// `multilevel_roi_align_adjoint_pallas` (589-732).  It computes the exact
// transpose of csrc/roi_align_fwd.cu (K1):
//
//     dF_level[b, y0 + y, x0 + x, c] += sum_p sum_q Ry[r, p, y] * Rx[r, q, x]
//                                                   * g[r, p, q, c]
//
// over the ny x nx cells the ROI's samples touch on its detectron2 level:
// the gradient of the reference's ROIAlign with respect to the features
// (torchvision's backward).  Each block reads its ROI's record (level, y0,
// x0, ny, nx) as K1 wrote it and rebuilds Ry/Rx from the box through
// roi_align_prologue.cuh, the same code K1 ran, so the weights are
// bit-identical and forward and adjoint stay an exact linear map and
// transpose for every ROI.  An invalid ROI (ny == 0) reads and writes
// nothing.
//
// Bound on an H100 SXM: memory bytes.  g's rows of the valid ROIs read
// once and each float32 cell of the level gradients written once, over
// 3.35 TB/s: 0.247 ms at the training box pool (8192 ROIs, 7x7, C = 256).
// The zero fill of the gradients and the atomics' read-modify-write are
// costs of this design, not of the function.
//
// Design:
//   * grid (ROI, channel slice); the block stages its ROI's cotangent rows
//     g[r, :, :, slice] in dynamic shared memory once, with 16-byte loads:
//     all 256 channels at P = 7 (50 KB), 64-channel slices at P = 14
//     (50 KB), so a cotangent value is read from device memory once; the
//     weight rows follow, packed at the ROI's own ny and nx, and the
//     per-cell ranges of output rows and columns after them (the launch
//     reserves room for the largest level's height plus width);
//   * a thread owns 4 channels; the block's thread groups split the cell
//     columns.  Per column x of the support, T[p] = sum_q Rx[q, x] g[p, q]
//     in registers (P a template parameter), then per row y of the support
//     sum_p Ry[p, y] T[p], added to dF[b, y0 + y, x0 + x, c..c+3] with one
//     16-byte vector reduction (red.global.add.v4.f32, native on sm_90),
//     and no old value sent back;
//   * ROIs overlap and run at once (the TPU ran its grid in sequence,
//     roi_align_pallas.py:496-506), so the adds stay atomic and their
//     order, hence the last bits of the sum, varies between runs.

#include <cuda_runtime.h>

#include "roi_align_prologue.cuh"

namespace {

using namespace roi_prologue;

constexpr int kThreads = 256;
constexpr int kStageFloats = 12544;   // 49 KB of staged cotangent per block

struct Grads {
  float* d[4];
};

// dst[0..3] += v with one 16-byte reduction (red.global.add.v4.f32, sm_90):
// no old value comes back to the SM, as it would with atomicAdd's ATOM.
__device__ __forceinline__ void red_add4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

template <int PMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads)
roi_align_adj_kernel(Grads gr, Opts o, int C, int cs_max,
                     const float* __restrict__ boxes, const int* __restrict__ record,
                     int n_per_image, const float* __restrict__ g) {
  // staged g (P * P * cs_max / 4 float4), then Ry (P x ny), Rx (P x nx),
  // and per cell row (column) the output rows p (columns q) that hold it
  extern __shared__ float4 sg4[];
  __shared__ int ylo[PMAX], yhi[PMAX], xlo[PMAX], xhi[PMAX];

  const int P = EXACT ? PMAX : o.P;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int* rr = record + static_cast<size_t>(r) * kRecord;
  Record rec;
  rec.level = rr[0]; rec.y0 = rr[1]; rec.x0 = rr[2]; rec.ny = rr[3]; rec.nx = rr[4];
  if (rec.ny == 0) return;
  const int l = rec.level;
  const int H = o.h[l];
  const int W = o.w[l];
  const int ny = rec.ny, nx = rec.nx;
  float* sry = reinterpret_cast<float*>(sg4 + P * P * (cs_max / 4));
  float* srx = sry + P * ny;
  int* plo = reinterpret_cast<int*>(srx + P * nx);
  int* phi = plo + ny;
  int* qlo = phi + ny;
  int* qhi = qlo + nx;
  const float* box = boxes + static_cast<size_t>(r) * 4;

  // stage this block's channel slice of g[r] (P*P rows of cs floats)
  const int c0 = blockIdx.y * cs_max;
  const int cs = min(cs_max, C - c0);
  const int cs4 = cs / 4;
  const float* g_roi = g + static_cast<size_t>(r) * P * P * C + c0;
  for (int i = tid; i < P * P * cs4; i += kThreads) {
    const int pq = i / cs4;
    sg4[i] = *reinterpret_cast<const float4*>(g_roi + static_cast<size_t>(pq) * C +
                                              (i - pq * cs4) * 4);
  }

  // weights, rebuilt as K1 built them
  const Axis ay = axis_params(box[1], box[3], o.scale[l], o);
  const Axis ax = axis_params(box[0], box[2], o.scale[l], o);
  for (int i = tid; i < P * (ny + nx); i += kThreads) sry[i] = 0.f;
  __syncthreads();
  if (tid < P) {
    build_row(sry + tid * ny, ay, tid, H, rec.y0, ny, &ylo[tid], &yhi[tid]);
  } else if (tid < 2 * P) {
    const int q = tid - P;
    build_row(srx + q * nx, ax, q, W, rec.x0, nx, &xlo[q], &xhi[q]);
  }
  __syncthreads();
  // per cell row (column): the first and last output row p (column q)
  // whose support holds it; lo > hi marks one that no support holds
  for (int i = tid; i < ny + nx; i += kThreads) {
    const bool is_y = i < ny;
    const int k = is_y ? i : i - ny;
    int lo = P, hi = -1;
    for (int p = 0; p < P; ++p) {
      const int a = is_y ? ylo[p] : xlo[p];
      const int b = is_y ? yhi[p] : xhi[p];
      if (a <= k && k <= b) {
        lo = min(lo, p);
        hi = p;
      }
    }
    (is_y ? plo : qlo)[k] = lo;
    (is_y ? phi : qhi)[k] = hi;
  }
  __syncthreads();
  int y_first = ny, y_last = -1, x_first = nx, x_last = -1;
  for (int p = 0; p < P; ++p) {
    if (ylo[p] <= yhi[p]) {
      y_first = min(y_first, ylo[p]);
      y_last = max(y_last, yhi[p]);
    }
    if (xlo[p] <= xhi[p]) {
      x_first = min(x_first, xlo[p]);
      x_last = max(x_last, xhi[p]);
    }
  }

  const int lanes = cs4;                       // <= kThreads by the wrapper
  const int groups = kThreads / lanes;         // cell-column groups
  const int grp = tid / lanes;
  if (grp >= groups) return;
  const int lane = tid - grp * lanes;
  const int b = r / n_per_image;
  const size_t row_stride = static_cast<size_t>(W) * C;
  float* d = gr.d[l] + (static_cast<size_t>(b) * H + rec.y0) * row_stride +
             static_cast<size_t>(rec.x0) * C + c0 + lane * 4;
  for (int x = x_first + grp; x <= x_last; x += groups) {
    const int q0 = qlo[x], q1 = qhi[x];
    if (q1 < q0) continue;
    float4 t[PMAX];
#pragma unroll
    for (int p = 0; p < PMAX; ++p) t[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = q0; q <= q1; ++q) {
      const float wx = srx[q * nx + x];
      if (wx == 0.f) continue;
#pragma unroll
      for (int p = 0; p < PMAX; ++p) {
        if (!EXACT && p >= P) break;
        const float4 v = sg4[(p * P + q) * cs4 + lane];
        t[p].x += wx * v.x; t[p].y += wx * v.y; t[p].z += wx * v.z; t[p].w += wx * v.w;
      }
    }
    float* dcol = d + static_cast<size_t>(x) * C;
    for (int y = y_first; y <= y_last; ++y) {
      const int p0 = plo[y], p1 = phi[y];
      if (p1 < p0) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < PMAX; ++p) {
        if (!EXACT && p >= P) break;
        if (p < p0 || p > p1) continue;
        const float wy = sry[p * ny + y];
        acc.x += wy * t[p].x; acc.y += wy * t[p].y; acc.z += wy * t[p].z; acc.w += wy * t[p].w;
      }
      red_add4(dcol + y * row_stride, acc);
    }
  }
}

template <int PMAX, bool EXACT>
int launch(int T, cudaStream_t s, const Grads& gr, const Opts& o, int C, int cs,
           const float* boxes, const int* record, int n, const float* g) {
  // the staged g, and room for the largest ROI's rows and cell ranges:
  // ny <= H_l and nx <= W_l on its level
  int span = 0;
  for (int l = 0; l < 4; ++l) span = max(span, o.h[l] + o.w[l]);
  const size_t smem = (static_cast<size_t>(o.P) * o.P * cs + (o.P + 2) * span) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(roi_align_adj_kernel<PMAX, EXACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(T, (C + cs - 1) / cs);
  roi_align_adj_kernel<PMAX, EXACT><<<grid, dim3(kThreads), smem, s>>>(
      gr, o, C, cs, boxes, record, n, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  Pointers are device
// pointers; `stream` is a cudaStream_t.  d2..d5 are the float32 level
// gradients (B, H_l, W_l, C), zeroed by the caller; boxes (T, 4) float32
// and record (T, 5) int32 are the forward's; g is the float32 pooled
// cotangent (T, P, P, C) in [p, q, c] order.  C must be a multiple of 4,
// every pointer 16-byte aligned.  The options, adaptive_cap included, are
// the forward's.
extern "C" int roi_align_adj(void* d2, void* d3, void* d4, void* d5, int h2,
                             int w2, int h3, int w3, int h4, int w4, int h5,
                             int w5, float s2, float s3, float s4, float s5, int C,
                             int P, int sampling_ratio, int aligned, int min_level,
                             int adaptive_cap,
                             const void* boxes, const void* record, int n_per_image,
                             const void* g, int T, void* stream) {
  if (T <= 0) return 0;
  if (P < 1 || P > kMaxP || C < 4 || C % 4 != 0 || n_per_image < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // channel slice: as many channels as fit the staging budget, a multiple
  // of 4, at most one per thread group of 4 channels
  const int cs = min(C, min(kThreads * 4, max(4, kStageFloats / (P * P) / 4 * 4)));
  Grads gr;
  gr.d[0] = static_cast<float*>(d2); gr.d[1] = static_cast<float*>(d3);
  gr.d[2] = static_cast<float*>(d4); gr.d[3] = static_cast<float*>(d5);
  Opts o;
  o.P = P;
  o.sampling_ratio = sampling_ratio;
  o.aligned = aligned;
  o.min_level = min_level;
  o.adaptive_cap = adaptive_cap;
  o.scale[0] = s2; o.scale[1] = s3; o.scale[2] = s4; o.scale[3] = s5;
  o.h[0] = h2; o.h[1] = h3; o.h[2] = h4; o.h[3] = h5;
  o.w[0] = w2; o.w[1] = w3; o.w[2] = w4; o.w[3] = w5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(boxes);
  const int* rp = static_cast<const int*>(record);
  const float* gp = static_cast<const float*>(g);
  if (P == 7) return launch<7, true>(T, s, gr, o, C, cs, bp, rp, n_per_image, gp);
  if (P == 14) return launch<14, true>(T, s, gr, o, C, cs, bp, rp, n_per_image, gp);
  return launch<kMaxP, false>(T, s, gr, o, C, cs, bp, rp, n_per_image, gp);
}
