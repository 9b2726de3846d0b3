// Exact greedy NMS over many independent box sets for Hopper (sm_90a),
// plain C interface (K4).
//
// Replaces no TPU kernel: the JAX package's NMS (articulation3d_tpu/ops/
// nms.py) is a jnp / fori_loop program.  The port's plain version
// (`ops/nms.py::nms_mask_sweep`) finds the greedy keep mask as the fixed
// point of sweeps over an (S, N, N) IoU matrix built from broadcast float32
// temporaries, and the host waits once per sweep to test convergence.  At
// the stage-1 training step (16 images x 5 FPN levels x 2000 boxes) that
// moves about 26 GB of temporaries a step and waits about 60 times; at
// inference the waits alone cost milliseconds a call.
//
// Input: S sets of capacity N in input order (boxes (S, N, 4) float32 xyxy,
// valid (S, N) bool) and each set's visiting order (S, N) int64, the
// wrapper's stable descending sort of the masked scores.  Output: the keep
// mask (S, N) bool in input order.  A box is kept iff it is valid and no
// earlier kept box overlaps it with IoU > threshold; invalid boxes are
// never kept and never suppress.
//
// Bound on an H100 SXM: the boxes read (16 B a box) and the keep mask
// written (1 B a box) are 1.4 MB at the training step, 0.4 us at 3.35
// TB/s; the IoUs, N^2/2 a set of about 20 float ops, are 3.2 GFLOP there,
// 48 us at 67 TFLOP/s outside the tensor cores.  What bounds the kernel is
// the walk: greedy NMS is serial within a set, N rows in order.
//
// Design, two launches on the caller's stream and no host wait:
//   * nms_mask_kernel: one block of 64 threads per (set, row tile, column
//     tile at or right of it).  Each thread owns a sorted row and writes a
//     64-bit word whose bit j says that the row suppresses column j of the
//     tile (only columns after the row).  The per-set bitmask, N x N/64
//     words (512 KB at N = 2000, 41 MB for the training step's 80 sets),
//     stays in the 50 MB L2 for the walk.  The diagonal tiles also write
//     one word of valid bits per row tile.
//   * nms_walk_kernel: one warp per set walks the row tiles in order.  The
//     `removed` bitset lives in shared memory.  Within a tile the keep
//     decisions are the fixed point of the tile's diagonal words, a few
//     warp-wide OR reductions; then every lane ORs the kept rows' words of
//     its columns into `removed`, all 64 loads of a column in flight
//     together, while the next tile's order and diagonal words load.
//   * the IoU is `ops/box_ops.py::pairwise_iou` bit for bit: torch's
//     operation order, NaN-propagating max/min and clamp, `union > 0`,
//     inter / max(union, 1e-12) as an IEEE division, and a strict `>`;
//     every float operation is an `_rn` intrinsic, so nothing is contracted
//     into an FMA.  A pair whose IoU is certain to lie more than about
//     2^-18 from the threshold is decided without the division
//     (`overlaps_fast`); the others divide.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // rows and columns per tile: one bit word
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum / clamp(min=0) on float32: a NaN operand
// gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float clamp0(float a) { return a < 0.f ? 0.f : a; }

// coordinates within +-2^40 keep every intermediate of the IoU finite: no
// NaN can arise, so plain fminf/fmaxf equal torch's NaN-propagating ones
constexpr float kTame = 1099511627776.f;

struct Box {
  float x1, y1, x2, y2, area;
  bool tame;
};

__device__ __forceinline__ Box load_box(const float* b) {
  Box r;
  r.x1 = b[0]; r.y1 = b[1]; r.x2 = b[2]; r.y2 = b[3];
  r.area = __fmul_rn(clamp0(__fsub_rn(r.x2, r.x1)), clamp0(__fsub_rn(r.y2, r.y1)));
  r.tame = fabsf(r.x1) <= kTame && fabsf(r.y1) <= kTame && fabsf(r.x2) <= kTame &&
           fabsf(r.y2) <= kTame;
  return r;
}

// pairwise_iou(a, b) > thresh, as torch computes it
__device__ __forceinline__ bool overlaps(const Box& a, const Box& b, float thresh) {
  const float w = clamp0(__fsub_rn(tmin(a.x2, b.x2), tmax(a.x1, b.x1)));
  const float h = clamp0(__fsub_rn(tmin(a.y2, b.y2), tmax(a.y1, b.y1)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  const float iou =
      uni > 0.f ? __fdiv_rn(inter, uni < (float)1e-12 ? (float)1e-12 : uni) : 0.f;
  return iou > thresh;
}

// The same answer without the division for two tame boxes, where it is
// certain: 1 or 0, else -1 (take `overlaps`).  With uni >= 2^-30 (no
// clamp, no underflow) and tlo, thi = thresh x (1 -+ 2^-18) rounded, the
// products carry at most 2^-23 relative error, so inter < uni * tlo puts
// the exact quotient below thresh and inter > uni * thi puts it more than
// one ulp above: its rounding then compares alike.  Only pairs within
// about 2^-18 of the threshold divide.
__device__ __forceinline__ int overlaps_fast(const Box& a, const Box& b, float tlo,
                                             float thi) {
  const float w = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  if (!(uni >= 0x1p-30f)) return -1;
  if (inter < __fmul_rn(uni, tlo)) return 0;
  if (inter > __fmul_rn(uni, thi)) return 1;
  return -1;
}

__device__ __forceinline__ unsigned long long low_bits(int k) {
  return k >= 64 ? ~0ull : (1ull << k) - 1;
}

// grid (W (W + 1) / 2, S), 64 threads: block (L, s) takes the L-th tile
// (r, c) of the upper triangle, c >= r, row by row; it writes the words of
// row tile r at column tile c, and for c == r the valid bits of row tile r
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                const int64_t* __restrict__ order, int n, int words, float thresh,
                unsigned long long* __restrict__ mask, uint32_t* __restrict__ vbits) {
  const int s = blockIdx.y, t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  // row r starts at r * W - r (r - 1) / 2
  auto first = [words](int64_t row) { return row * words - row * (row - 1) / 2; };
  const double b2 = 2.0 * words + 1.0;
  int r = static_cast<int>((b2 - sqrt(b2 * b2 - 8.0 * static_cast<double>(tile))) * 0.5);
  r = max(0, min(r, words - 1));
  while (r > 0 && first(r) > tile) --r;
  while (r + 1 < words && first(r + 1) <= tile) ++r;
  const int c = r + static_cast<int>(tile - first(r));

  __shared__ Box cols[kTile];
  const int64_t base = static_cast<int64_t>(s) * n;
  const int j = c * kTile + t;
  if (j < n) {
    cols[t] = load_box(boxes + 4 * (base + order[base + j]));
  } else {
    cols[t] = Box{0.f, 0.f, 0.f, 0.f, 0.f, true};   // past N: a tame empty box
  }
  const int i = r * kTile + t;
  int64_t oi = 0;
  bool vi = false;
  if (i < n) {
    oi = order[base + i];
    vi = valid[base + oi] != 0;
  }
  if (c == r) {
    const unsigned b = __ballot_sync(kFull, vi);
    if ((t & 31) == 0) vbits[(static_cast<int64_t>(s) * words + r) * 2 + (t >> 5)] = b;
  }
  __syncthreads();
  if (!vi) return;                        // the walk never reads an invalid row
  const Box a = load_box(boxes + 4 * (base + oi));
  const bool fast_t = thresh >= 0x1p-20f && thresh <= 0x1p20f;
  const float tlo = __fmul_rn(thresh, 1.f - 0x1p-18f), thi = __fmul_rn(thresh, 1.f + 0x1p-18f);
  unsigned long long bits = 0;
#pragma unroll 8
  for (int jj = 0; jj < kTile; ++jj) {
    const Box& b = cols[jj];
    int o = fast_t && a.tame && b.tame ? overlaps_fast(a, b, tlo, thi) : -1;
    if (o < 0) o = overlaps(a, b, thresh);
    bits |= static_cast<unsigned long long>(o) << jj;
  }
  // only the columns after the row, and before N
  bits &= low_bits(n - c * kTile) & ~low_bits(c == r ? t + 1 : 0);
  mask[(base + i) * words + c] = bits;
}

// grid (S), 32 threads, words x 8 bytes of dynamic shared memory
__global__ void __launch_bounds__(32)
nms_walk_kernel(const int64_t* __restrict__ order,
                const unsigned long long* __restrict__ mask,
                const unsigned long long* __restrict__ vwords, int n, int words,
                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int s = blockIdx.x, lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(s) * n;
  const unsigned long long* m = mask + base * words;
  const unsigned long long* vw = vwords + static_cast<int64_t>(s) * words;
  for (int c = lane; c < words; c += 32) removed[c] = 0;
  __syncwarp();
  // a lane's two rows of a tile (clamped: rows past N are never valid) and
  // what it loads for them: their input index and their diagonal word
  int i0 = min(lane, n - 1), i1 = min(lane + 32, n - 1);
  unsigned long long vnext = vw[0];
  int64_t o0 = order[base + i0], o1 = order[base + i1];
  unsigned long long d0 = m[static_cast<int64_t>(i0) * words], d1 = m[static_cast<int64_t>(i1) * words];
  for (int r = 0; r < words; ++r) {
    const unsigned long long valid_bits = vnext, dc0 = d0, dc1 = d1;
    const int64_t oc0 = o0, oc1 = o1;
    if (r + 1 < words) {                  // the next tile's loads, in flight meanwhile
      i0 = min((r + 1) * kTile + lane, n - 1);
      i1 = min((r + 1) * kTile + 32 + lane, n - 1);
      vnext = vw[r + 1];
      o0 = order[base + i0];
      o1 = order[base + i1];
      d0 = m[static_cast<int64_t>(i0) * words + r + 1];
      d1 = m[static_cast<int64_t>(i1) * words + r + 1];
    }
    const unsigned long long cand = valid_bits & ~removed[r];
    unsigned long long kept = cand;
    if (cand) {
      // this tile's rows at the lane's first later column tile, loading
      // while the tile's decisions are made (rows past N: clamped, masked)
      const unsigned long long* rows = m + r + 1 + lane;
      unsigned long long w[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const int64_t row = min(r * kTile + k, n - 1);
        w[k] = r + 1 + lane < words ? rows[row * words] : 0;
      }
      // greedy within the tile: the fixed point of kept = cand & ~(rows of
      // kept rows), iterated from cand (unique, reached in at most 64
      // steps, usually a few); each step ORs the kept rows' diagonal words
      // across the warp
      for (;;) {
        unsigned long long killed = (((kept >> lane) & 1) ? dc0 : 0) |
                                    (((kept >> (lane + 32)) & 1) ? dc1 : 0);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) killed |= __shfl_xor_sync(kFull, killed, off);
        const unsigned long long next = cand & ~killed;
        if (next == kept) break;
        kept = next;
      }
      // the kept rows' words of every later column tile into `removed`
      // (rows not kept are loaded and masked off)
      unsigned long long acc = 0;
#pragma unroll
      for (int k = 0; k < kTile; ++k) acc |= w[k] & (0ull - ((kept >> k) & 1));
      if (r + 1 + lane < words) removed[r + 1 + lane] |= acc;
      for (int c = r + 33 + lane; c < words; c += 32) {
        acc = 0;
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          const int64_t row = min(r * kTile + k, n - 1);
          acc |= m[row * words + c] & (0ull - ((kept >> k) & 1));
        }
        removed[c] |= acc;
      }
      __syncwarp();
    }
    if (r * kTile + lane < n) keep[base + oc0] = (kept >> lane) & 1;
    if (r * kTile + 32 + lane < n) keep[base + oc1] = (kept >> (lane + 32)) & 1;
  }
}

}  // namespace

// Launches both kernels on `stream`; returns the CUDA error code (0: ok).
// scratch: (S * (N + 1) * W) 64-bit words, W = ceil(N / 64): the bitmask,
// then each set's valid bits by row tile.
extern "C" int nms(const void* boxes, const void* valid, const void* order, int sets,
                   int n, float thresh, void* scratch, void* keep, void* stream) {
  if (sets <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  if (sets > 65535 || words * static_cast<int>(sizeof(unsigned long long)) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned tiles = static_cast<unsigned>(words) * (words + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* mask = static_cast<unsigned long long*>(scratch);
  unsigned long long* vwords = mask + static_cast<int64_t>(sets) * n * words;
  nms_mask_kernel<<<dim3(tiles, sets), kTile, 0, st>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(order), n, words, thresh, mask,
      reinterpret_cast<uint32_t*>(vwords));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<sets, 32, words * sizeof(unsigned long long), st>>>(
      static_cast<const int64_t*>(order), mask, vwords, n, words,
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
