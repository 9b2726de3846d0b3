// Multilevel FPN ROIAlign forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` in
// articulation3d_tpu/ops/roi_align_pallas.py:184-270, launched by
// `multilevel_roi_align_pallas` (378-482).  It computes exactly what that
// kernel computes, from the same per-ROI prologue (level after the window
// bump, image id, window origin y0/x0, tile counts nty/ntx, separable weights
// Ry (P x 64) and Rx (P x 80)), which the torch wrapper
// `articulation3d_tpu_torch/ops/roi_align_cuda.py::_prepare` builds:
//
//     out[r, p, q, c] = sum_y sum_x Ry[r, p, y] * Rx[r, q, x]
//                                   * F_level[b, y0 + y, x0 + x, c]
//
// over the tiles the ROI spans (y < 32 * nty, x < 40 * ntx) and the cells
// inside the real level map.  The Pallas kernel read those cells from a
// zero-padded copy; here they are skipped, which is the same sum.
//
// Bound on an H100 SXM: memory bytes.  Each ROI does about
// (support rows x support cols) multiply-adds per output element, a few
// tens, far below the ~20 FLOP/byte ridge of fp32 CUDA cores, so the least
// time is (output written, B*N*P*P*C*4 bytes, plus the feature cells the
// ROIs read, plus the weights) over 3.35 TB/s.
//
// Design (first version: simple and right, no TMA and no wgmma yet):
//   * one thread block per ROI, 256 threads across the channels, so every
//     read of the channels-last features and every write of the
//     [p, q, c]-ordered output is coalesced;
//   * the ROI's Ry/Rx rows (about 8 KB at P = 14), already cut to its tiles
//     and to the real map, and the first/last non-zero entry of each row,
//     staged in shared memory; the sum visits only that support;
//   * float32 accumulation; the output is written once, in [p, q, c] order
//     (the TPU kernel wrote [q, p, c] and swapped afterwards);
//   * an invalid ROI (nty == 0) writes zeros and reads nothing.
// Features may be float32 or bfloat16.  Ry/Rx stay float32 for bfloat16
// features, where the TPU kernel rounded them to bfloat16 for its matrix
// unit; the results therefore differ from the TPU's by about 2^-9 relative.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 32;
constexpr int kTileX = 40;
constexpr int kSpanY = 2 * kTileY;
constexpr int kSpanX = 2 * kTileX;
constexpr int kMaxP = 16;
constexpr int kThreads = 256;

struct Levels {
  const void* f[4];
  int h[4];
  int w[4];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels lv, int C, int P,
                     const int* __restrict__ level, const int* __restrict__ bid,
                     const int* __restrict__ y0s, const int* __restrict__ x0s,
                     const int* __restrict__ ntys, const int* __restrict__ ntxs,
                     const float* __restrict__ ry, const float* __restrict__ rx,
                     float* __restrict__ out) {
  __shared__ float sry[kMaxP][kSpanY];
  __shared__ float srx[kMaxP][kSpanX];
  __shared__ int ylo[kMaxP], yhi[kMaxP], xlo[kMaxP], xhi[kMaxP];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nty = ntys[r];
  float* o = out + static_cast<size_t>(r) * P * P * C;
  if (nty == 0) {
    for (int i = tid; i < P * P * C; i += blockDim.x) o[i] = 0.f;
    return;
  }
  const int l = level[r];
  const int b = bid[r];
  const int y0 = y0s[r];
  const int x0 = x0s[r];
  const int H = lv.h[l];
  const int W = lv.w[l];
  // window rows/cols the ROI may read: its spanned tiles, inside the map
  const int ylim = min(nty * kTileY, H - y0);
  const int xlim = min(ntxs[r] * kTileX, W - x0);

  const float* ryr = ry + static_cast<size_t>(r) * P * kSpanY;
  const float* rxr = rx + static_cast<size_t>(r) * P * kSpanX;
  for (int i = tid; i < P * kSpanY; i += blockDim.x) {
    const int y = i % kSpanY;
    sry[i / kSpanY][y] = y < ylim ? ryr[i] : 0.f;
  }
  for (int i = tid; i < P * kSpanX; i += blockDim.x) {
    const int x = i % kSpanX;
    srx[i / kSpanX][x] = x < xlim ? rxr[i] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < 2 * P; i += blockDim.x) {
    const bool is_y = i < P;
    const int row = is_y ? i : i - P;
    const int n = is_y ? kSpanY : kSpanX;
    const float* wts = is_y ? &sry[row][0] : &srx[row][0];
    int lo = n, hi = -1;
    for (int k = 0; k < n; ++k) {
      if (wts[k] != 0.f) {
        lo = min(lo, k);
        hi = k;
      }
    }
    (is_y ? ylo : xlo)[row] = lo;
    (is_y ? yhi : xhi)[row] = hi;
  }
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* f = static_cast<const T*>(lv.f[l]) +
               (static_cast<size_t>(b) * H + y0) * row_stride +
               static_cast<size_t>(x0) * C;
  for (int c = tid; c < C; c += blockDim.x) {
    for (int p = 0; p < P; ++p) {
      for (int q = 0; q < P; ++q) {
        float acc = 0.f;
        for (int y = ylo[p]; y <= yhi[p]; ++y) {
          const float wy = sry[p][y];
          if (wy == 0.f) continue;
          const T* row = f + y * row_stride + c;
          float s = 0.f;
          for (int x = xlo[q]; x <= xhi[q]; ++x) {
            s += srx[q][x] * to_float(row[static_cast<size_t>(x) * C]);
          }
          acc += wy * s;
        }
        o[(static_cast<size_t>(p) * P + q) * C + c] = acc;
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  Pointers are device
// pointers; `stream` is a cudaStream_t.  dtype: 0 float32, 1 bfloat16.
extern "C" int roi_align_fwd(const void* f2, const void* f3, const void* f4,
                             const void* f5, int dtype, int h2, int w2, int h3,
                             int w3, int h4, int w4, int h5, int w5, int C,
                             int P, const void* level, const void* bid,
                             const void* y0, const void* x0, const void* nty,
                             const void* ntx, const void* ry, const void* rx,
                             void* out, int T, void* stream) {
  if (T <= 0) return 0;
  if (P < 1 || P > kMaxP || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.f[0] = f2; lv.f[1] = f3; lv.f[2] = f4; lv.f[3] = f5;
  lv.h[0] = h2; lv.h[1] = h3; lv.h[2] = h4; lv.h[3] = h5;
  lv.w[0] = w2; lv.w[1] = w3; lv.w[2] = w4; lv.w[3] = w5;
  const dim3 grid(T), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip[6] = {static_cast<const int*>(level), static_cast<const int*>(bid),
                      static_cast<const int*>(y0), static_cast<const int*>(x0),
                      static_cast<const int*>(nty), static_cast<const int*>(ntx)};
  const float* ryp = static_cast<const float*>(ry);
  const float* rxp = static_cast<const float*>(rx);
  float* op = static_cast<float*>(out);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, block, 0, s>>>(
        lv, C, P, ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], ryp, rxp, op);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        lv, C, P, ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], ryp, rxp, op);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
