"""Multilevel ROIAlign forward as a hand-written CUDA kernel for Hopper.

Counterpart of `articulation3d_tpu/ops/roi_align_pallas.py`.  It holds:

  * the torch prologue (`pallas_level_idx`, `_separable_weights`,
    `_prepare`), which reproduces the Pallas prologue in float32: the
    detectron2 sqrt-area level plus the window-overflow bump, the window
    origin (y0, x0) with x floored to a multiple of 8 and both capped
    against the padded level extents, the tile counts nty/ntx, and the
    per-ROI separable weights Ry (P, 64) and Rx (P, 80) that fold in V1/V2
    offsets, the adaptive sample count capped at 4, bilinear corners, zeros
    outside the map, the defensive edge clamp and 1/n averaging;
  * the kernel wrapper `multilevel_roi_align_cuda`, which launches
    `csrc/roi_align_fwd.cu` for CUDA tensors;
  * the plain version `multilevel_roi_align_separable`, the same math in
    torch ops, which the wrapper takes for CPU tensors and the tests and
    `chip_smoke.py` hold the kernel against.

The 64x80 window and the 8-aligned x origin are kept in the prologue though
the CUDA kernel does no DMA: they decide which level and which weights an
ROI beyond the window contract gets (roi_align_pallas.py docstring), so the
port pools exactly what the Pallas kernel pooled.  The TPU's launch
chunking, ROI groups and padded copies of p3-p5 do not carry over: the
kernel reads the unpadded maps and skips cells at or beyond the real level
extent, where the padded Pallas window holds zeros.

Layout: features are channels-last (B, H_l, W_l, C), as in the JAX package.
The output is (B, N, P, P, C) float32 in [row, col, C] order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import torch

from .roi_align import _sample_coords, assign_boxes_to_levels

TILE_Y = 32   # window rows per tile
TILE_X = 40   # window cols per tile
N_TILES = 2   # tiles per axis -> 64 x 80 cell window
SPAN_Y = TILE_Y * N_TILES
SPAN_X = TILE_X * N_TILES
MAX_P = 16    # output sizes the kernel's shared-memory arrays hold

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "roi_align_fwd.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]


def _separable_weights(coord, mask, n_s, size, origin, win_n):
    """Fold sampling, bilinear corners and averaging into (N, P, win_n)
    weights relative to the window origin.

    coord (N, P, S) absolute sample coordinates on the pooled level; mask
    (N, P, S) adaptive-sample mask; n_s (N,) sample counts; size (N,) real
    level extent; origin (N,) window origin.
    """
    h = size[:, None, None].to(torch.float32)
    hi = size[:, None, None]
    oor = (coord < -1.0) | (coord > h)
    y = coord.clamp(min=0.0)
    y_low = torch.minimum(y.to(torch.int64), hi - 1)
    y_high = torch.minimum(y_low + 1, hi - 1)
    y = torch.where(y.to(torch.int64) >= hi - 1, y_low.to(y.dtype), y)
    ly = y - y_low.to(y.dtype)
    hy = 1.0 - ly
    zero = torch.zeros_like(ly)
    w_lo = torch.where(oor, zero, hy) * mask
    w_hi = torch.where(oor, zero, ly) * mask

    # defensive clamp for ROIs that overflow the window even at the top
    # level: tail samples snap to the window edge instead of being dropped
    rel_lo = (y_low - origin[:, None, None]).clamp(0, win_n - 1)
    rel_hi = (y_high - origin[:, None, None]).clamp(0, win_n - 1)
    win_ids = torch.arange(win_n, dtype=torch.int64, device=coord.device)
    one_lo = (rel_lo[..., None] == win_ids).to(torch.float32)
    one_hi = (rel_hi[..., None] == win_ids).to(torch.float32)
    w = (one_lo * w_lo[..., None] + one_hi * w_hi[..., None]).sum(dim=2)
    return w / n_s.clamp(min=1)[:, None, None].to(torch.float32)


def pallas_level_idx(flat_boxes: torch.Tensor, *, n_levels: int,
                     strides: Sequence[int], output_size: int,
                     sampling_ratio: int, aligned: bool,
                     min_level: int = 2) -> torch.Tensor:
    """The 0-based level each ROI is pooled from: detectron2's sqrt-area
    level, moved to a coarser level when the sampled extent overflows the
    64x80-cell window (roi_align_pallas.py:120-171)."""
    dev = flat_boxes.device
    levels = assign_boxes_to_levels(flat_boxes, min_level=min_level,
                                    max_level=min_level + n_levels - 1) - min_level
    scale_table = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                               device=dev)
    ys0, xs0, ym0, xm0 = _sample_coords(flat_boxes, scale_table[levels],
                                        output_size, sampling_ratio, aligned)
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    y_min0 = torch.where(ym0 > 0, ys0, big).amin(dim=(1, 2))
    y_max0 = torch.where(ym0 > 0, ys0, -big).amax(dim=(1, 2))
    x_min0 = torch.where(xm0 > 0, xs0, big).amin(dim=(1, 2))
    x_max0 = torch.where(xm0 > 0, xs0, -big).amax(dim=(1, 2))
    need_y0 = torch.floor(y_max0) + 2 - (torch.floor(y_min0) - 1).clamp(min=0.0)
    x0_al = torch.floor((torch.floor(x_min0) - 1).clamp(min=0.0) / 8) * 8
    need_x0 = torch.floor(x_max0) + 2 - x0_al
    overflow = (need_y0 > SPAN_Y) | (need_x0 > SPAN_X)
    over = torch.maximum((y_max0 - y_min0) / float(SPAN_Y - 4),
                         (x_max0 - x_min0) / float(SPAN_X - 11))
    b_req = torch.ceil(torch.log2(over.clamp(min=1.0))).to(torch.int64)
    bump = torch.where(overflow, b_req.clamp(min=1), torch.zeros_like(b_req))
    return (levels + bump).clamp(max=n_levels - 1)


def _prepare(level_shapes: Sequence[Sequence[int]], boxes: torch.Tensor, *,
             strides: Sequence[int], output_size: int, sampling_ratio: int,
             aligned: bool, min_level: int = 2,
             valid: Optional[torch.Tensor] = None) -> dict:
    """Per-ROI prologue shared by the kernel and its plain version
    (roi_align_pallas.py:273-375).

    level_shapes: per level (B, H_l, W_l, C); boxes (B, N, 4).  Returns
    levels, batch_ids, y0, x0, nty, ntx as (T,) int32 (T = B*N), ry
    (T, P, 64) and rx (T, P, 80) float32, and the padded extents hp, wp.
    Invalid ROIs get nty = 0.
    """
    bsz, n = boxes.shape[:2]
    p = output_size
    dev = boxes.device
    flat_boxes = boxes.reshape(bsz * n, 4).to(torch.float32)
    total = bsz * n
    levels = pallas_level_idx(flat_boxes, n_levels=len(level_shapes),
                              strides=strides, output_size=p,
                              sampling_ratio=sampling_ratio, aligned=aligned,
                              min_level=min_level)
    hs = [int(s[1]) for s in level_shapes]
    ws = [int(s[2]) for s in level_shapes]
    hp = [max(h, SPAN_Y) for h in hs]
    # widths round up to a multiple of 8 so the 8-aligned x-origin cap
    # reaches the right edge exactly
    wp = [(max(w, SPAN_X) + 7) // 8 * 8 for w in ws]
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    heights = as_t(hs)[levels]
    widths = as_t(ws)[levels]
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)[levels]
    y0_cap = as_t([h - SPAN_Y for h in hp])[levels]
    x0_cap = as_t([w - SPAN_X for w in wp])[levels]

    ys, xs, y_mask, x_mask = _sample_coords(flat_boxes, scales, p,
                                            sampling_ratio, aligned)
    if sampling_ratio > 0:
        n_sh = torch.full((total,), sampling_ratio, dtype=torch.int64, device=dev)
        n_sw = n_sh
    else:
        n_sh = y_mask[:, 0, :].sum(dim=1).to(torch.int64)
        n_sw = x_mask[:, 0, :].sum(dim=1).to(torch.int64)

    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    y_min = torch.where(y_mask > 0, ys, big).amin(dim=(1, 2))
    y_max = torch.where(y_mask > 0, ys, -big).amax(dim=(1, 2))
    x_min = torch.where(x_mask > 0, xs, big).amin(dim=(1, 2))
    x_max = torch.where(x_mask > 0, xs, -big).amax(dim=(1, 2))

    y0 = (torch.floor(y_min).to(torch.int64) - 1).clamp(min=0)
    x0 = (torch.floor(x_min).to(torch.int64) - 1).clamp(min=0)
    x0 = torch.div(x0, 8, rounding_mode="floor") * 8
    y0 = torch.minimum(y0, y0_cap)
    x0 = torch.minimum(x0, x0_cap)

    need_y = torch.floor(y_max).to(torch.int64) + 2 - y0
    need_x = torch.floor(x_max).to(torch.int64) + 2 - x0
    nty = torch.div(need_y + TILE_Y - 1, TILE_Y, rounding_mode="floor").clamp(1, N_TILES)
    ntx = torch.div(need_x + TILE_X - 1, TILE_X, rounding_mode="floor").clamp(1, N_TILES)
    if valid is not None:
        nty = torch.where(valid.reshape(total), nty, torch.zeros_like(nty))

    ry = _separable_weights(ys, y_mask, n_sh, heights, y0, SPAN_Y)
    rx = _separable_weights(xs, x_mask, n_sw, widths, x0, SPAN_X)
    batch_ids = torch.arange(bsz, dtype=torch.int64, device=dev).repeat_interleave(n)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return dict(levels=i32(levels), batch_ids=i32(batch_ids), y0=i32(y0),
                x0=i32(x0), nty=i32(nty), ntx=i32(ntx), ry=ry.contiguous(),
                rx=rx.contiguous(), hp=hp, wp=wp)


def multilevel_roi_align_separable(features: Sequence[torch.Tensor],
                                   boxes: torch.Tensor, *,
                                   strides: Sequence[int], output_size: int,
                                   sampling_ratio: int, aligned: bool,
                                   min_level: int = 2,
                                   valid: Optional[torch.Tensor] = None,
                                   chunk: int = 256) -> torch.Tensor:
    """The plain torch version of the kernel (port of the CPU emulation in
    `tests/test_pallas_roi.py`), chunked over ROIs.

    Per ROI: out[p, q, c] = sum_y sum_x Ry[p, y] Rx[q, x] win[y, x, c] over
    the 64x80 window at (y0, x0) of its level, with tiles beyond nty/ntx
    dropped and cells beyond the real level extent read as zero.  Weights
    stay float32 for bf16 features; the sum is float32.
    """
    bsz, n = boxes.shape[:2]
    c = features[0].shape[-1]
    p = output_size
    pr = _prepare([f.shape for f in features], boxes, strides=strides,
                  output_size=p, sampling_ratio=sampling_ratio,
                  aligned=aligned, min_level=min_level, valid=valid)
    dev = boxes.device
    ry, rx = _predicated_weights(pr)
    levels = pr["levels"].long()
    bids, y0, x0 = pr["batch_ids"].long(), pr["y0"].long(), pr["x0"].long()
    out = torch.zeros((bsz * n, p, p, c), dtype=torch.float32, device=dev)
    wy = torch.arange(SPAN_Y, device=dev)
    wx = torch.arange(SPAN_X, device=dev)
    for lvl, f in enumerate(features):
        padded = torch.nn.functional.pad(
            f, (0, 0, 0, pr["wp"][lvl] - f.shape[2], 0, pr["hp"][lvl] - f.shape[1]))
        sel = torch.nonzero((levels == lvl) & (pr["nty"] > 0)).flatten()
        for lo in range(0, sel.numel(), chunk):
            r = sel[lo:lo + chunk]
            rows = (y0[r, None] + wy)[:, :, None]
            cols = (x0[r, None] + wx)[:, None, :]
            win = padded[bids[r, None, None], rows, cols].to(torch.float32)
            out[r] = torch.einsum("kpy,kyxc,kqx->kpqc", ry[r], win, rx[r])
    return out.reshape(bsz, n, p, p, c)


def _predicated_weights(pr: dict):
    """Ry/Rx with the tiles an ROI does not span zeroed (the Pallas kernel
    skips those tiles); invalid ROIs (nty = 0) get all-zero Ry."""
    ry, rx = pr["ry"], pr["rx"]
    dev = ry.device
    ty = torch.arange(SPAN_Y, device=dev) // TILE_Y
    tx = torch.arange(SPAN_X, device=dev) // TILE_X
    ry = ry * (ty[None, :] < pr["nty"].long()[:, None])[:, None, :]
    rx = rx * (tx[None, :] < pr["ntx"].long()[:, None])[:, None, :]
    return ry, rx


# --------------------------------------------------------------------------- #
# the kernel: build, bind, launch
# --------------------------------------------------------------------------- #

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_kernel(verbose: bool = False) -> str:
    """Compile `csrc/roi_align_fwd.cu` into `_build/` (once per source
    version) and return the shared library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    path = os.path.join(_BUILD_DIR, f"libroi_align_fwd_{digest}.so")
    if os.path.exists(path):
        return path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, flush=True)
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernel())
        fn = lib.roi_align_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i,              # f2..f5, dtype
                       i, i, i, i, i, i, i, i,          # h2, w2 .. h5, w5
                       i, i,                            # C, P
                       vp, vp, vp, vp, vp, vp,          # level bid y0 x0 nty ntx
                       vp, vp, vp, i, vp]               # ry rx out T stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(features: Sequence[torch.Tensor], pr: dict, out: torch.Tensor,
            p: int) -> None:
    lib = _load()
    hw = []
    for f in features:
        hw += [int(f.shape[1]), int(f.shape[2])]
    total = int(pr["levels"].numel())
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.roi_align_fwd(
        *[f.data_ptr() for f in features], _DTYPES[features[0].dtype], *hw,
        int(features[0].shape[-1]), p,
        *[pr[k].data_ptr() for k in ("levels", "batch_ids", "y0", "x0",
                                     "nty", "ntx", "ry", "rx")],
        out.data_ptr(), total, stream)
    if err != 0:
        raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {err}")


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, *,
                              strides: Sequence[int], output_size: int,
                              sampling_ratio: int, aligned: bool,
                              min_level: int = 2,
                              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched FPN ROIAlign: features (B, H_l, W_l, C) x 4 (float32 or
    bfloat16, channels-last), boxes (B, N, 4), valid (B, N) bool ->
    (B, N, P, P, C) float32.  Invalid ROIs give zeros and cost no reads.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    kw = dict(strides=strides, output_size=output_size,
              sampling_ratio=sampling_ratio, aligned=aligned,
              min_level=min_level, valid=valid)
    if boxes.device.type == "cpu":
        return multilevel_roi_align_separable(features, boxes, **kw)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if len(features) != 4:
        raise ValueError("the kernel pools exactly four levels (p2..p5)")
    dtype = features[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in features):
        raise TypeError(f"features must all be float32 or bfloat16, got "
                        f"{[f.dtype for f in features]}")
    c = features[0].shape[-1]
    for f in features:
        if (f.device != boxes.device or f.dim() != 4 or f.shape[-1] != c
                or f.shape[0] != boxes.shape[0] or not f.is_contiguous()):
            raise ValueError("features must be contiguous (B, H, W, C) "
                             "tensors on the boxes' device")
    if not 1 <= output_size <= MAX_P:
        raise ValueError(f"output_size must be in [1, {MAX_P}]")
    bsz, n = boxes.shape[:2]
    pr = _prepare([f.shape for f in features], boxes, **kw)
    out = torch.empty((bsz * n, output_size, output_size, c),
                      dtype=torch.float32, device=boxes.device)
    if bsz * n:
        _launch(features, pr, out, output_size)
        multilevel_roi_align_cuda.launches += 1
    return out.reshape(bsz, n, output_size, output_size, c)


multilevel_roi_align_cuda.launches = 0
