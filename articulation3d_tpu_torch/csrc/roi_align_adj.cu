// Multilevel FPN ROIAlign adjoint (gradient with respect to the features)
// for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_adjoint_kernel_factory` in
// articulation3d_tpu/ops/roi_align_pallas.py:519-586, launched by
// `multilevel_roi_align_adjoint_pallas` (589-732).  From the forward's own
// per-ROI prologue (level after the window bump, image id, window origin
// y0/x0, tile counts nty/ntx, separable weights Ry (P x 64) and Rx (P x 80),
// built by `articulation3d_tpu_torch/ops/roi_align_cuda.py::_prepare`) it
// computes the exact transpose of csrc/roi_align_fwd.cu:
//
//     dF_level[b, y0 + y, x0 + x, c] += sum_p sum_q Ry[r, p, y] * Rx[r, q, x]
//                                                   * g[r, p, q, c]
//
// for the tiles the ROI spans (y < 32 * nty, x < 40 * ntx) and only for the
// cells inside the real level map (y0 + y < H, x0 + x < W).  The Pallas
// kernel accumulated the out-of-map cells into a padded scratch and cropped
// them afterwards; dropping them is the same result, and writing them would
// run past p4 and p5, where the capped window origin lets a 64x80 window
// hang over the map.  An invalid ROI (nty == 0) writes nothing.  Ry/Rx are
// used as the prologue built them (window-edge snap included), so forward
// and adjoint stay an exact linear map and transpose for every ROI.
//
// Bound on an H100 SXM: memory bytes.  Each touched gradient cell costs a
// read and a write (the atomic add) of 4 bytes per channel against a few
// tens of multiply-adds, far below the ~20 FLOP/byte ridge of fp32 CUDA
// cores; with the zero fill of the level gradients and one read of g, the
// least time is those bytes over 3.35 TB/s.
//
// Design (first version: simple and right, no TMA and no wgmma yet):
//   * one thread block per ROI, 256 threads across the channels, so every
//     read of g and every atomic add into the channels-last gradient is
//     coalesced;
//   * the ROI's Ry/Rx rows, cut to its tiles and to the real map, staged in
//     shared memory, with the first and last p (q) of non-zero weight for
//     every window row y (column x); a cell outside both supports is never
//     visited, so the sum runs over the same support as the forward's;
//   * float32 sums, one atomicAdd per touched cell and channel.  ROI
//     windows overlap and the card runs ROIs concurrently (the TPU ran its
//     grid in sequence, roi_align_pallas.py:496-506), so the adds are
//     atomic and their order, hence the last bits of the sum, varies
//     between runs.

#include <cuda_runtime.h>

namespace {

constexpr int kTileY = 32;
constexpr int kTileX = 40;
constexpr int kSpanY = 2 * kTileY;
constexpr int kSpanX = 2 * kTileX;
constexpr int kMaxP = 16;
constexpr int kThreads = 256;

struct Grads {
  float* d[4];
  int h[4];
  int w[4];
};

__global__ void __launch_bounds__(kThreads)
roi_align_adj_kernel(Grads gr, int C, int P,
                     const int* __restrict__ level, const int* __restrict__ bid,
                     const int* __restrict__ y0s, const int* __restrict__ x0s,
                     const int* __restrict__ ntys, const int* __restrict__ ntxs,
                     const float* __restrict__ ry, const float* __restrict__ rx,
                     const float* __restrict__ g) {
  __shared__ float sry[kMaxP][kSpanY];
  __shared__ float srx[kMaxP][kSpanX];
  __shared__ int plo[kSpanY], phi[kSpanY], qlo[kSpanX], qhi[kSpanX];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nty = ntys[r];
  if (nty == 0) return;
  const int l = level[r];
  const int b = bid[r];
  const int y0 = y0s[r];
  const int x0 = x0s[r];
  const int H = gr.h[l];
  const int W = gr.w[l];
  // window rows/cols the ROI may write: its spanned tiles, inside the map
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
  // per window row (col): the first and last output row p (col q) whose
  // weight on it is non-zero; lo > hi marks a row (col) no sample touches
  for (int i = tid; i < kSpanY + kSpanX; i += blockDim.x) {
    const bool is_y = i < kSpanY;
    const int k = is_y ? i : i - kSpanY;
    int lo = P, hi = -1;
    for (int p = 0; p < P; ++p) {
      const float w = is_y ? sry[p][k] : srx[p][k];
      if (w != 0.f) {
        lo = min(lo, p);
        hi = p;
      }
    }
    (is_y ? plo : qlo)[k] = lo;
    (is_y ? phi : qhi)[k] = hi;
  }
  __syncthreads();

  const float* gr_roi = g + static_cast<size_t>(r) * P * P * C;
  const size_t row_stride = static_cast<size_t>(W) * C;
  float* d = gr.d[l] + (static_cast<size_t>(b) * H + y0) * row_stride +
             static_cast<size_t>(x0) * C;
  for (int c = tid; c < C; c += blockDim.x) {
    for (int y = 0; y < ylim; ++y) {
      const int p0 = plo[y], p1 = phi[y];
      if (p1 < p0) continue;
      float* drow = d + y * row_stride + c;
      for (int x = 0; x < xlim; ++x) {
        const int q0 = qlo[x], q1 = qhi[x];
        if (q1 < q0) continue;
        float acc = 0.f;
        for (int p = p0; p <= p1; ++p) {
          const float wy = sry[p][y];
          if (wy == 0.f) continue;
          const float* gp = gr_roi + static_cast<size_t>(p) * P * C + c;
          float s = 0.f;
          for (int q = q0; q <= q1; ++q) {
            s += srx[q][x] * gp[static_cast<size_t>(q) * C];
          }
          acc += wy * s;
        }
        atomicAdd(drow + static_cast<size_t>(x) * C, acc);
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  Pointers are device
// pointers; `stream` is a cudaStream_t.  d2..d5 are the float32 level
// gradients (B, H_l, W_l, C), zeroed by the caller; g is the float32 pooled
// cotangent (T, P, P, C) in [p, q, c] order.
extern "C" int roi_align_adj(void* d2, void* d3, void* d4, void* d5, int h2,
                             int w2, int h3, int w3, int h4, int w4, int h5,
                             int w5, int C, int P, const void* level,
                             const void* bid, const void* y0, const void* x0,
                             const void* nty, const void* ntx, const void* ry,
                             const void* rx, const void* g, int T,
                             void* stream) {
  if (T <= 0) return 0;
  if (P < 1 || P > kMaxP || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  Grads gr;
  gr.d[0] = static_cast<float*>(d2); gr.d[1] = static_cast<float*>(d3);
  gr.d[2] = static_cast<float*>(d4); gr.d[3] = static_cast<float*>(d5);
  gr.h[0] = h2; gr.h[1] = h3; gr.h[2] = h4; gr.h[3] = h5;
  gr.w[0] = w2; gr.w[1] = w3; gr.w[2] = w4; gr.w[3] = w5;
  roi_align_adj_kernel<<<dim3(T), dim3(kThreads), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      gr, C, P, static_cast<const int*>(level), static_cast<const int*>(bid),
      static_cast<const int*>(y0), static_cast<const int*>(x0),
      static_cast<const int*>(nty), static_cast<const int*>(ntx),
      static_cast<const float*>(ry), static_cast<const float*>(rx),
      static_cast<const float*>(g));
  return static_cast<int>(cudaGetLastError());
}
