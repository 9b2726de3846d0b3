// Multilevel FPN ROIAlign forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` in
// articulation3d_tpu/ops/roi_align_pallas.py:184-270, launched by
// `multilevel_roi_align_pallas` (378-482), prologue included: one launch
// per pool call takes the boxes and the valid mask and computes
//
//     out[r, p, q, c] = sum_y sum_x Ry[r, p, y] * Rx[r, q, x]
//                                   * F_level[b, y0 + y, x0 + x, c]
//
// over the ny x nx cells the ROI's samples touch on its detectron2 level,
// with the record and separable weights of roi_align_prologue.cuh (the
// device form of `ops/roi_align_cuda.py::_roi_record`): the reference's
// ROIAlign, the same linear map as `ops/roi_align.py::multilevel_roi_align`.
// It also writes each ROI's record (level, y0, x0, ny, nx) as int32, for
// the adjoint (K2) and the tests; an invalid ROI (ny = 0) writes zeros and
// reads no feature.
//
// Bound on an H100 SXM: memory bytes.  The output, B*N*P*P*C*4 bytes, plus
// the feature cells the ROIs read, over 3.35 TB/s: at the serving box pool
// (8000 ROIs, 7x7, bf16 maps) 0.148 ms, at the training box pool (8192
// ROIs, float32 maps) 0.205 ms (damped random-weight proposals).  Each
// cell costs about one multiply-add per output row and column whose
// support holds it, far below the ~20 FLOP per byte ridge of the fp32 CUDA
// cores.
//
// Design:
//   * the prologue is fused: every thread derives its ROI's record from
//     the box in registers; 2P threads build the Ry/Rx rows and their
//     supports straight into dynamic shared memory, packed at the ROI's
//     own ny and nx (P * (ny + nx) floats; the launch reserves P times the
//     largest level's height plus width, 17.9 KB at P = 16 on a 480x640
//     pyramid).  No per-ROI tensor but the 20-byte record goes to device
//     memory;
//   * a thread owns 8 bf16 or 4 float32 consecutive channels, so every
//     feature load is 16 bytes and a warp reads 512 contiguous bytes of a
//     channels-last row; the threads of a block split the work items, an
//     output column q and a block of at most 8 output rows p (two blocks
//     of 7 at P = 14), which keeps the accumulators in 128 registers;
//   * separable sums in registers, with P a template parameter (7, 14, or
//     up to 16 at run time): per work item the thread sweeps the cell rows
//     y of the block's support once, top to bottom, forms
//     H[q] = sum_x Rx[q, x] F[y, x] over the column's support and adds
//     Ry[p, y] H[q] into the rows p whose weight at y is non-zero; each
//     output is written once, in [p, q, c] order, with 16-byte stores.  A
//     feature cell is loaded once per row sweep and per column whose
//     support holds it (neighbouring bins share one or two cells);
//   * float32 accumulation with float32 weights for bf16 features (the TPU
//     rounded the weights to bf16 for its matrix unit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_prologue.cuh"

namespace {

using namespace roi_prologue;

// Launch shape by compiled row count, chosen on the card at the pools'
// shapes: at P <= 8, 128 threads, 4 blocks per SM and the column loop
// unrolled 4 times; at P <= 16, 256 threads and 2 blocks (more work items
// per ROI to share), unrolled twice.
template <int PMAX>
struct Shape {
  static constexpr int threads = PMAX <= 8 ? 128 : 256;
  static constexpr int min_blocks = PMAX <= 8 ? 4 : 2;
  static constexpr int x_unroll = PMAX <= 8 ? 4 : 2;
};

struct Levels {
  const void* f[4];
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// PMAX: the compiled row count; EXACT: P == PMAX, else P <= PMAX at run time.
// A work item is one output column q and a block of at most 8 output rows
// (two blocks of 7 at P = 14), so the accumulators stay under 128
// registers and 16 warps share an SM: the feature loads need warps in
// flight more than registers.
template <typename T, int PMAX, bool EXACT>
__global__ void __launch_bounds__(Shape<PMAX>::threads, Shape<PMAX>::min_blocks)
roi_align_fwd_kernel(Levels lv, Opts o, int C, const float* __restrict__ boxes,
                     const bool* __restrict__ valid, int n_per_image,
                     int* __restrict__ record, float* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  constexpr int kThreads = Shape<PMAX>::threads;
  constexpr int PB = PMAX <= 8 ? PMAX : (PMAX + 1) / 2;   // rows per work item
  extern __shared__ float srow[];   // Ry (P x ny), then Rx (P x nx)
  __shared__ int ylo[PMAX], yhi[PMAX], xlo[PMAX], xhi[PMAX];

  const int P = EXACT ? PMAX : o.P;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* box = boxes + static_cast<size_t>(r) * 4;
  const bool ok = valid == nullptr || valid[r];
  Axis ay, ax;
  const Record rec = roi_record(box, ok, o, &ay, &ax);
  if (tid == 0) {
    int* rr = record + static_cast<size_t>(r) * kRecord;
    rr[0] = rec.level; rr[1] = rec.y0; rr[2] = rec.x0; rr[3] = rec.ny; rr[4] = rec.nx;
  }
  float* o_roi = out + static_cast<size_t>(r) * P * P * C;
  if (rec.ny == 0) {
    float4* o4 = reinterpret_cast<float4*>(o_roi);
    for (int i = tid; i < P * P * C / 4; i += kThreads) o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int l = rec.level;
  const int H = o.h[l];
  const int W = o.w[l];
  const int ny = rec.ny, nx = rec.nx;
  float* sry = srow;
  float* srx = srow + P * ny;
  for (int i = tid; i < P * (ny + nx); i += kThreads) srow[i] = 0.f;
  __syncthreads();
  if (tid < P) {
    build_row(sry + tid * ny, ay, tid, H, rec.y0, ny, &ylo[tid], &yhi[tid]);
  } else if (tid < 2 * P) {
    const int q = tid - P;
    build_row(srx + q * nx, ax, q, W, rec.x0, nx, &xlo[q], &xhi[q]);
  }
  __syncthreads();

  const int b = r / n_per_image;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* f = static_cast<const T*>(lv.f[l]) +
               (static_cast<size_t>(b) * H + rec.y0) * row_stride +
               static_cast<size_t>(rec.x0) * C;
  const int n_cg = C / V;                      // channel groups
  const int lanes = min(n_cg, kThreads);
  const int groups = kThreads / lanes;         // work-item groups
  const int g = tid / lanes;
  if (g >= groups) return;
  const int npb = (P + PB - 1) / PB;
  for (int cg = tid % lanes; cg < n_cg; cg += lanes) {
    const int c = cg * V;
    for (int item = g; item < P * npb; item += groups) {
      const int q = item % P;
      const int p0 = (item / P) * PB;
      // the cell rows any output row of the block reads
      int y_first = ny, y_last = -1;
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        const int p = p0 + j;
        if ((!EXACT || PB != PMAX) && p >= P) break;
        if (ylo[p] <= yhi[p]) {
          y_first = min(y_first, ylo[p]);
          y_last = max(y_last, yhi[p]);
        }
      }
      float acc[PB][V];
#pragma unroll
      for (int j = 0; j < PB; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
      const int x0 = xlo[q], x1 = xhi[q];
      for (int y = y_first; y <= y_last; ++y) {
        // H[q] = sum_x Rx[q, x] F[y, x], once per cell row
        const T* row = f + y * row_stride + c;
        float h[V];
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = 0.f;
#pragma unroll (Shape<PMAX>::x_unroll)
        for (int x = x0; x <= x1; ++x) {
          const float wx = srx[q * nx + x];
          float fv[V];
          Vec<T>::load(row + static_cast<size_t>(x) * C, fv);
#pragma unroll
          for (int v = 0; v < V; ++v) h[v] += wx * fv[v];
        }
        // into every output row whose support holds y
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const int p = p0 + j;
          if ((!EXACT || PB != PMAX) && p >= P) break;
          const float wy = sry[p * ny + y];
          if (wy == 0.f) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[j][v] += wy * h[v];
        }
      }
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        const int p = p0 + j;
        if ((!EXACT || PB != PMAX) && p >= P) break;
        float* op = o_roi + (static_cast<size_t>(p) * P + q) * C + c;
#pragma unroll
        for (int v = 0; v < V; v += 4) {
          *reinterpret_cast<float4*>(op + v) =
              make_float4(acc[j][v], acc[j][v + 1], acc[j][v + 2], acc[j][v + 3]);
        }
      }
    }
  }
}

template <typename T, int PMAX, bool EXACT>
int launch(int T_rois, cudaStream_t s, const Levels& lv, const Opts& o, int C,
           const float* boxes, const bool* valid, int n, int* record, float* out) {
  // room for the largest ROI's rows: ny <= H_l and nx <= W_l on its level
  int span = 0;
  for (int l = 0; l < 4; ++l) span = max(span, o.h[l] + o.w[l]);
  const size_t smem = static_cast<size_t>(o.P) * span * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(roi_align_fwd_kernel<T, PMAX, EXACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  roi_align_fwd_kernel<T, PMAX, EXACT><<<dim3(T_rois), dim3(Shape<PMAX>::threads), smem, s>>>(
      lv, o, C, boxes, valid, n, record, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int T_rois, cudaStream_t s, const Levels& lv, const Opts& o, int C,
             const float* boxes, const bool* valid, int n, int* record, float* out) {
  if (o.P == 7) return launch<T, 7, true>(T_rois, s, lv, o, C, boxes, valid, n, record, out);
  if (o.P == 14) return launch<T, 14, true>(T_rois, s, lv, o, C, boxes, valid, n, record, out);
  return launch<T, kMaxP, false>(T_rois, s, lv, o, C, boxes, valid, n, record, out);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  Pointers are device
// pointers; `stream` is a cudaStream_t.  dtype: 0 float32, 1 bfloat16.
// boxes (T, 4) float32, valid (T,) bool or null, record (T, 5) int32 and
// out (T, P, P, C) float32 are written; T = images x n_per_image.  C must
// be a multiple of 8 (bfloat16) or 4 (float32), every pointer 16-byte
// aligned; scale_l = 1 / stride_l as float32; adaptive_cap caps the
// samples per bin and axis at sampling ratio 0 (0: uncapped).
extern "C" int roi_align_fwd(const void* f2, const void* f3, const void* f4,
                             const void* f5, int dtype, int h2, int w2, int h3,
                             int w3, int h4, int w4, int h5, int w5, float s2,
                             float s3, float s4, float s5, int C, int P,
                             int sampling_ratio, int aligned, int min_level,
                             int adaptive_cap,
                             const void* boxes, const void* valid, int n_per_image,
                             void* record, void* out, int T, void* stream) {
  if (T <= 0) return 0;
  const int vec = dtype == 1 ? 8 : 4;
  if (P < 1 || P > kMaxP || C < vec || C % vec != 0 || n_per_image < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.f[0] = f2; lv.f[1] = f3; lv.f[2] = f4; lv.f[3] = f5;
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
  const bool* vp = static_cast<const bool*>(valid);
  int* rp = static_cast<int*>(record);
  float* op = static_cast<float*>(out);
  if (dtype == 0) return dispatch<float>(T, s, lv, o, C, bp, vp, n_per_image, rp, op);
  return dispatch<__nv_bfloat16>(T, s, lv, o, C, bp, vp, n_per_image, rp, op);
}
