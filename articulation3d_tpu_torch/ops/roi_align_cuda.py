"""Multilevel ROIAlign forward and its adjoint as hand-written CUDA kernels
for Hopper, and the training pooler built from the two.

Counterpart of `articulation3d_tpu/ops/roi_align_pallas.py`.  It holds:

  * the torch prologue (`pallas_level_idx`, `_separable_weights`,
    `_prepare`), which reproduces the Pallas prologue in float32: the
    detectron2 sqrt-area level plus the window-overflow bump, the window
    origin (y0, x0) with x floored to a multiple of 8 and both capped
    against the padded level extents, the tile counts nty/ntx, and the
    per-ROI separable weights Ry (P, 64) and Rx (P, 80) that fold in V1/V2
    offsets, the adaptive sample count, bilinear corners, zeros outside the
    map, the defensive edge clamp and 1/n averaging.  It feeds the plain
    versions;
  * `_roi_record`, the same per-ROI integers as the kernels' own prologue
    (`csrc/roi_align_prologue.cuh`) computes them, for the tests;
  * K1, the forward: the wrapper `multilevel_roi_align_cuda`, which
    launches `csrc/roi_align_fwd.cu` (prologue fused in: boxes in, pooled
    features and the int32 record (level, y0, x0, nty, ntx) out) for CUDA
    tensors, and its plain version `multilevel_roi_align_separable`;
  * K2, the adjoint with respect to the features: the wrapper
    `multilevel_roi_align_adjoint_cuda`, which launches
    `csrc/roi_align_adj.cu` from the boxes and K1's record, and its plain
    version `multilevel_roi_align_adjoint_separable`;
  * K3, `multilevel_roi_align_train`: a `torch.autograd.Function` whose
    forward is K1 and whose backward is K2 (the JAX `_train_pool`
    custom VJP), or the gather formulation under torch autograd.

Each wrapper takes its plain version for CPU tensors only; the tests and
`chip_smoke.py` hold the kernels against the plain versions.

Every function takes `adaptive_cap`: with sampling ratio 0 an ROI takes
ceil(bin) samples per bin and axis, uncapped as torchvision does (None,
the default), or at most `adaptive_cap` (the JAX package's Pallas prologue
caps at 4, so its parity tests pass 4).  More samples move an ROI's first
and last sample, hence possibly its window origin and level bump; the
kernels take the cap as a run-time option (0: uncapped).

The 64x80 window and the 8-aligned x origin are kept in the prologue though
the CUDA kernels do no DMA: they decide which level and which weights an
ROI beyond the window contract gets (roi_align_pallas.py docstring), so the
port pools exactly what the Pallas kernel pooled.  The TPU's launch
chunking, ROI groups and padded copies of p3-p5 do not carry over: the
kernels read the unpadded maps and skip cells at or beyond the real level
extent, where the padded Pallas window holds zeros.

Layout: features are channels-last (B, H_l, W_l, C), as in the JAX package.
The output is (B, N, P, P, C) float32 in [row, col, C] order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .roi_align import _sample_coords, assign_boxes_to_levels, multilevel_roi_align

TILE_Y = 32   # window rows per tile
TILE_X = 40   # window cols per tile
N_TILES = 2   # tiles per axis -> 64 x 80 cell window
SPAN_Y = TILE_Y * N_TILES
SPAN_X = TILE_X * N_TILES
MAX_P = 16    # output sizes the kernels' shared-memory arrays hold
RECORD = ("levels", "y0", "x0", "nty", "ntx")   # the (T, 5) record's columns

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
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
                     min_level: int = 2,
                     adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """The 0-based level each ROI is pooled from: detectron2's sqrt-area
    level, moved to a coarser level when the sampled extent overflows the
    64x80-cell window (roi_align_pallas.py:120-171)."""
    dev = flat_boxes.device
    levels = assign_boxes_to_levels(flat_boxes, min_level=min_level,
                                    max_level=min_level + n_levels - 1) - min_level
    scale_table = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                               device=dev)
    ys0, xs0, ym0, xm0 = _sample_coords(flat_boxes, scale_table[levels],
                                        output_size, sampling_ratio, aligned,
                                        adaptive_cap)
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
             valid: Optional[torch.Tensor] = None,
             adaptive_cap: Optional[int] = None) -> dict:
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
                              min_level=min_level, adaptive_cap=adaptive_cap)
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
                                            sampling_ratio, aligned, adaptive_cap)
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
                                   chunk: int = 256,
                                   adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """The plain torch version of the kernel (port of the CPU emulation in
    `tests/test_pallas_roi.py`), chunked over ROIs.

    Per ROI: out[p, q, c] = sum_y sum_x Ry[p, y] Rx[q, x] win[y, x, c] over
    the 64x80 window at (y0, x0) of its level, with tiles beyond nty/ntx
    dropped and cells beyond the real level extent read as zero.  Weights
    stay float32 for bf16 features; the sum is float32.
    """
    bsz, n = boxes.shape[:2]
    pr = _prepare([f.shape for f in features], boxes, strides=strides,
                  output_size=output_size, sampling_ratio=sampling_ratio,
                  aligned=aligned, min_level=min_level, valid=valid,
                  adaptive_cap=adaptive_cap)
    out = _separable_forward(features, pr, output_size, chunk)
    return out.reshape(bsz, n, output_size, output_size, -1)


def _separable_forward(features: Sequence[torch.Tensor], pr: dict, p: int,
                       chunk: int = 256) -> torch.Tensor:
    """The plain forward from a `_prepare` result: (T, P, P, C) float32."""
    c = features[0].shape[-1]
    dev = pr["ry"].device
    ry, rx = _predicated_weights(pr)
    levels = pr["levels"].long()
    bids, y0, x0 = pr["batch_ids"].long(), pr["y0"].long(), pr["x0"].long()
    out = torch.zeros((levels.numel(), p, p, c), dtype=torch.float32, device=dev)
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
    return out


def multilevel_roi_align_adjoint_separable(g: torch.Tensor,
                                           feat_shapes: Sequence[Sequence[int]],
                                           pr: dict,
                                           chunk: int = 128) -> List[torch.Tensor]:
    """The plain torch version of K2 (port of the CPU emulation
    `tests/test_roi_train_pool.py::_emulate_pallas_adjoint`).

    g: (T, P, P, C) or (B, N, P, P, C) pooled cotangent; feat_shapes: per
    level (B, H_l, W_l, C); pr: the `_prepare` result of the forward.  Per
    ROI the window cotangent dwin[y, x, c] = sum_p sum_q Ry[p, y] Rx[q, x]
    g[p, q, c] (tiles beyond nty/ntx dropped, invalid ROIs skipped) is added
    into the zero-padded level map at (y0, x0); each map is cropped to its
    real extent (roi_align_pallas.py:727-731).  Returns float32 (B, H_l,
    W_l, C) gradients.
    """
    p = g.shape[-2]
    c = g.shape[-1]
    gf = g.reshape(-1, p, p, c).to(torch.float32)
    dev = gf.device
    ry, rx = _predicated_weights(pr)
    levels = pr["levels"].long()
    bids, y0, x0 = pr["batch_ids"].long(), pr["y0"].long(), pr["x0"].long()
    wy = torch.arange(SPAN_Y, device=dev)
    wx = torch.arange(SPAN_X, device=dev)
    grads = []
    for lvl, shape in enumerate(feat_shapes):
        bsz, h, w = (int(v) for v in shape[:3])
        hp, wp = pr["hp"][lvl], pr["wp"][lvl]
        acc = torch.zeros((bsz * hp * wp, c), dtype=torch.float32, device=dev)
        sel = torch.nonzero((levels == lvl) & (pr["nty"] > 0)).flatten()
        for lo in range(0, sel.numel(), chunk):
            r = sel[lo:lo + chunk]
            # transpose of the forward's products, Rx first as in the kernel
            t = torch.einsum("kpqc,kqx->kpxc", gf[r], rx[r])
            dwin = torch.einsum("kpy,kpxc->kyxc", ry[r], t)
            cell = ((bids[r, None, None] * hp + y0[r, None, None] + wy[:, None]) * wp
                    + x0[r, None, None] + wx)
            # index_add_ sums in index order on the CPU (index_put_'s
            # accumulate may not), so the plain version is deterministic there
            acc.index_add_(0, cell.reshape(-1), dwin.reshape(-1, c))
        grads.append(acc.reshape(bsz, hp, wp, c)[:, :h, :w].contiguous())
    return grads


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


def _record_of(pr: dict) -> torch.Tensor:
    """The (T, 5) int32 record (level, y0, x0, nty, ntx) of a `_prepare`
    result."""
    return torch.stack([pr[k] for k in RECORD], dim=1).to(torch.int32)


def _roi_record(level_shapes: Sequence[Sequence[int]], boxes: torch.Tensor, *,
                strides: Sequence[int], output_size: int, sampling_ratio: int,
                aligned: bool, min_level: int = 2,
                valid: Optional[torch.Tensor] = None,
                adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """The per-ROI record (level, y0, x0, nty, ntx) as K1's fused prologue
    (`csrc/roi_align_prologue.cuh`) computes it: (T, 5) int32.

    The torch twin of the device code, operation for operation: it works
    per ROI from the sample start, bin size and sample count, takes an
    axis's extreme samples in closed form (the first and last sample,
    swapped for a negative bin) instead of reducing (T, P, S) coordinates,
    and divides by a constant as torch's CUDA `div` does for a Python
    scalar, by multiplying with its float32 reciprocal.  `_prepare` gives
    the same integers; the tests and `chip_smoke.py` hold the three
    (`_prepare`, this, the kernel) against each other.
    """
    p = output_size
    dev = boxes.device
    fb = boxes.reshape(-1, 4).to(torch.float32)
    n_levels = len(level_shapes)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32).to(dev)

    def recip(d):
        return (torch.tensor(1.0, dtype=torch.float32)
                / torch.tensor(float(d), dtype=torch.float32)).to(dev)

    area = (fb[:, 2] - fb[:, 0]).clamp(min=0) * (fb[:, 3] - fb[:, 1]).clamp(min=0)
    t = torch.sqrt(area) * recip(224.0) + f32(1e-8)
    base = (torch.floor(f32(4.0) + torch.log2(t))
            .clamp(min_level, min_level + n_levels - 1).to(torch.int64) - min_level)

    scale_table = f32([1.0 / s for s in strides])
    off = f32(0.5 if aligned else 0.0)
    inv_p = recip(p)

    def extent(lo, hi, scale):
        start = lo * scale - off
        length = (hi * scale - off) - start
        if not aligned:
            length = length.clamp(min=1.0)
        bin_sz = length * inv_p
        if sampling_ratio > 0:
            n = torch.full_like(start, float(sampling_ratio))
        else:
            n = torch.ceil(bin_sz).to(torch.int32).clamp(1, adaptive_cap).to(torch.float32)
        first = start + (f32(0.0) + f32(0.5) / n) * bin_sz
        last = start + (f32(float(p - 1)) + ((n - 1.0) + f32(0.5)) / n) * bin_sz
        pos = bin_sz >= 0
        return torch.where(pos, first, last), torch.where(pos, last, first)

    def extents(levels):
        scale = scale_table[levels]
        return (*extent(fb[:, 1], fb[:, 3], scale), *extent(fb[:, 0], fb[:, 2], scale))

    # the window bump (`pallas_level_idx`)
    y_min, y_max, x_min, x_max = extents(base)
    need_y = (torch.floor(y_max) + f32(2.0)) - (torch.floor(y_min) - f32(1.0)).clamp(min=0.0)
    x0_al = torch.floor((torch.floor(x_min) - f32(1.0)).clamp(min=0.0) * f32(0.125)) * f32(8.0)
    need_x = (torch.floor(x_max) + f32(2.0)) - x0_al
    overflow = (need_y > SPAN_Y) | (need_x > SPAN_X)
    over = torch.maximum((y_max - y_min) * recip(SPAN_Y - 4),
                         (x_max - x_min) * recip(SPAN_X - 11))
    b_req = torch.ceil(torch.log2(over.clamp(min=1.0))).to(torch.int64)
    levels = torch.where(overflow, (base + b_req.clamp(min=1)).clamp(max=n_levels - 1), base)

    # window origin and tile counts at the pooled level (`_prepare`)
    y_min, y_max, x_min, x_max = extents(levels)
    hp = [max(int(s[1]), SPAN_Y) for s in level_shapes]
    wp = [(max(int(s[2]), SPAN_X) + 7) // 8 * 8 for s in level_shapes]
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    y0 = (torch.floor(y_min).to(torch.int64) - 1).clamp(min=0)
    x0 = (torch.floor(x_min).to(torch.int64) - 1).clamp(min=0)
    x0 = torch.div(x0, 8, rounding_mode="floor") * 8
    y0 = torch.minimum(y0, as_t([h - SPAN_Y for h in hp])[levels])
    x0 = torch.minimum(x0, as_t([w - SPAN_X for w in wp])[levels])
    need_y = torch.floor(y_max).to(torch.int64) + 2 - y0
    need_x = torch.floor(x_max).to(torch.int64) + 2 - x0
    nty = torch.div(need_y + TILE_Y - 1, TILE_Y, rounding_mode="floor").clamp(1, N_TILES)
    ntx = torch.div(need_x + TILE_X - 1, TILE_X, rounding_mode="floor").clamp(1, N_TILES)
    if valid is not None:
        nty = torch.where(valid.reshape(-1), nty, torch.zeros_like(nty))
    return torch.stack([levels, y0, x0, nty, ntx], dim=1).to(torch.int32)


# --------------------------------------------------------------------------- #
# the kernels: build, bind, launch
# --------------------------------------------------------------------------- #

_SOURCES = {"roi_align_fwd": "roi_align_fwd.cu", "roi_align_adj": "roi_align_adj.cu"}
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _source_files(src: str) -> List[str]:
    """A source and every file of `csrc/` it includes, directly or not."""
    files, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path) as f:
            todo += [os.path.join(os.path.dirname(path), m)
                     for m in re.findall(r'^#include "([^"]+)"', f.read(), re.M)]
    return files


def _lib_path(name: str) -> Tuple[str, str]:
    """(source, shared library) of one kernel; the library's name carries
    a digest of the source, the headers it includes and the flags."""
    src = os.path.join(_CSRC, _SOURCES[name])
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _source_files(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_kernels(names: Sequence[str] = tuple(_SOURCES),
                  verbose: bool = False) -> Dict[str, str]:
    """Compile each kernel source into `_build/` (once per source version),
    one `nvcc` per source, all started together.  Returns {name: path}."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        src, path = _lib_path(name)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", tmp, src]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(f"[build] {name}\n{err}", flush=True)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name)[1] for name in names}


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_OPTS = [_F, _F, _F, _F,                                  # 1/stride per level
         _I, _I, _I, _I, _I, _I]                          # C, P, ratio, aligned,
                                                          # min_level, cap (0: none)
_ARGTYPES = {
    "roi_align_fwd": [_VP, _VP, _VP, _VP, _I,             # f2..f5, dtype
                      _I, _I, _I, _I, _I, _I, _I, _I,     # h2, w2 .. h5, w5
                      *_OPTS,
                      _VP, _VP, _I,                       # boxes, valid, N
                      _VP, _VP, _I, _VP],                 # record, out, T, stream
    "roi_align_adj": [_VP, _VP, _VP, _VP,                 # d2..d5 (float32)
                      _I, _I, _I, _I, _I, _I, _I, _I,     # h2, w2 .. h5, w5
                      *_OPTS,
                      _VP, _VP, _I,                       # boxes, record, N
                      _VP, _I, _VP],                      # g, T, stream
}


def _load(name: str = "roi_align_fwd"):
    if name not in _libs:
        lib = ctypes.CDLL(build_kernels((name,))[name])
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels per 16-byte load


def _hw(shapes: Sequence[Sequence[int]]) -> List[int]:
    hw = []
    for s in shapes:
        hw += [int(s[1]), int(s[2])]
    return hw


def _opt_args(opts: dict, c: int) -> list:
    """The kernels' option arguments: 1/stride per level as float32 (the
    values of the prologue's scale table), C, P, the ratio, aligned, the
    min level and the adaptive cap (0: uncapped)."""
    scales = torch.tensor([1.0 / s for s in opts["strides"]], dtype=torch.float32).tolist()
    cap = opts.get("adaptive_cap")
    if cap is not None and int(cap) < 1:
        raise ValueError(f"adaptive_cap must be None or at least 1, got {cap}")
    return [*scales, int(c), int(opts["output_size"]), int(opts["sampling_ratio"]),
            int(bool(opts["aligned"])), int(opts.get("min_level", 2)), int(cap or 0)]


def _launch(features: Sequence[torch.Tensor], boxes: torch.Tensor,
            valid: Optional[torch.Tensor], opts: dict, record: torch.Tensor,
            out: torch.Tensor) -> None:
    """K1 on checked inputs: boxes (B, N, 4) float32, valid (B, N) bool or
    None; writes record (T, 5) int32 and out (T, P, P, C) float32."""
    lib = _load("roi_align_fwd")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.roi_align_fwd(
        *[f.data_ptr() for f in features], _DTYPES[features[0].dtype],
        *_hw([f.shape for f in features]), *_opt_args(opts, features[0].shape[-1]),
        boxes.data_ptr(), None if valid is None else valid.data_ptr(),
        int(boxes.shape[1]), record.data_ptr(), out.data_ptr(), int(record.shape[0]),
        stream)
    if err != 0:
        raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {err}")


def _launch_adj(g: torch.Tensor, boxes: torch.Tensor, record: torch.Tensor,
                opts: dict, grads: Sequence[torch.Tensor]) -> None:
    """K2 on checked inputs: adds into the zeroed float32 level gradients."""
    lib = _load("roi_align_adj")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.roi_align_adj(
        *[d.data_ptr() for d in grads], *_hw([d.shape for d in grads]),
        *_opt_args(opts, g.shape[-1]), boxes.data_ptr(), record.data_ptr(),
        int(boxes.shape[1]), g.data_ptr(), int(record.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"roi_align_adj launch failed: CUDA error {err}")


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _kernel_boxes(boxes: torch.Tensor, valid: Optional[torch.Tensor],
                  output_size: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Boxes as the kernels read them, float32 and contiguous (no copy when
    they already are), and `valid` contiguous."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError("boxes must be (B, N, 4)")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != boxes.shape[:2]
                              or valid.device != boxes.device):
        raise TypeError("valid must be a bool (B, N) tensor on the boxes' device")
    if not 1 <= output_size <= MAX_P:
        raise ValueError(f"output_size must be in [1, {MAX_P}]")
    return (boxes.to(torch.float32).contiguous(),
            None if valid is None else valid.contiguous())


def _check_features(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    if len(features) != 4:
        raise ValueError("the kernel pools exactly four levels (p2..p5)")
    dtype = features[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in features):
        raise TypeError(f"features must all be float32 or bfloat16, got "
                        f"{[f.dtype for f in features]}")
    c = features[0].shape[-1]
    for f in features:
        if (f.device != boxes.device or f.dim() != 4 or f.shape[-1] != c
                or f.shape[0] != boxes.shape[0] or not f.is_contiguous()
                or not _aligned16(f)):
            raise ValueError("features must be contiguous, 16-byte aligned "
                             "(B, H, W, C) tensors on the boxes' device")
    if c % _VEC[dtype] != 0:
        raise ValueError(f"C must be a multiple of {_VEC[dtype]} for {dtype}, got {c}")


def _forward_kernel(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                    valid: Optional[torch.Tensor],
                    opts: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, prologue fused in: ((T, P, P, C) float32, (T, 5) int32 record);
    counts the launch."""
    _check_features(features, boxes)
    boxes, valid = _kernel_boxes(boxes, valid, opts["output_size"])
    total, p = boxes.shape[0] * boxes.shape[1], opts["output_size"]
    out = torch.empty((total, p, p, features[0].shape[-1]), dtype=torch.float32,
                      device=boxes.device)
    record = torch.empty((total, len(RECORD)), dtype=torch.int32, device=boxes.device)
    if total:
        _launch(features, boxes, valid, opts, record, out)
        multilevel_roi_align_cuda.launches += 1
    return out, record


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, *,
                              strides: Sequence[int], output_size: int,
                              sampling_ratio: int, aligned: bool,
                              min_level: int = 2,
                              valid: Optional[torch.Tensor] = None,
                              adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """Batched FPN ROIAlign: features (B, H_l, W_l, C) x 4 (float32 or
    bfloat16, channels-last, C a multiple of 4 or 8), boxes (B, N, 4)
    float32, valid (B, N) bool -> (B, N, P, P, C) float32.  Invalid ROIs
    give zeros and cost no reads.

    CUDA tensors launch K1 (one launch, no torch prologue); CPU tensors
    take the plain version.
    """
    kw = dict(strides=strides, output_size=output_size, sampling_ratio=sampling_ratio,
              aligned=aligned, min_level=min_level, adaptive_cap=adaptive_cap)
    if boxes.device.type == "cpu":
        return multilevel_roi_align_separable(features, boxes, valid=valid, **kw)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    bsz, n = boxes.shape[:2]
    out, _ = _forward_kernel(features, boxes, valid, kw)
    return out.reshape(bsz, n, output_size, output_size, -1)


multilevel_roi_align_cuda.launches = 0


def multilevel_roi_align_adjoint_cuda(g: torch.Tensor,
                                      feat_shapes: Sequence[Sequence[int]],
                                      boxes: torch.Tensor, record: torch.Tensor, *,
                                      strides: Sequence[int], output_size: int,
                                      sampling_ratio: int, aligned: bool,
                                      min_level: int = 2,
                                      adaptive_cap: Optional[int] = None
                                      ) -> List[torch.Tensor]:
    """K2: the gradient of K1 with respect to the features.

    g: (T, P, P, C) or (B, N, P, P, C) float32 pooled cotangent;
    feat_shapes: per level (B, H_l, W_l, C); boxes (B, N, 4) and record
    (T, 5) int32: the forward's boxes and K1's record (nty = 0 marks an
    invalid ROI, whose cotangent rows are never read); the options are the
    forward's.  Returns float32 (B, H_l, W_l, C) gradients.  CUDA tensors
    launch `csrc/roi_align_adj.cu`, which rebuilds K1's weights from the
    boxes bit for bit (float32 atomics: the sum order varies between
    runs); CPU tensors take `multilevel_roi_align_adjoint_separable` on the
    `_prepare` of the same boxes.
    """
    kw = dict(strides=strides, output_size=output_size, sampling_ratio=sampling_ratio,
              aligned=aligned, min_level=min_level, adaptive_cap=adaptive_cap)
    if g.device.type == "cpu":
        pr = _prepare(feat_shapes, boxes, valid=record[:, 3] > 0, **kw)
        return multilevel_roi_align_adjoint_separable(g, feat_shapes, pr)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if len(feat_shapes) != 4:
        raise ValueError("the kernel scatters into exactly four levels (p2..p5)")
    p, c = int(g.shape[-2]), int(g.shape[-1])
    if (g.dtype != torch.float32 or not g.is_contiguous() or g.shape[-3] != p
            or not _aligned16(g)):
        raise TypeError("g must be a contiguous, 16-byte aligned float32 (..., P, P, C) tensor")
    boxes, _ = _kernel_boxes(boxes, None, output_size)
    total = boxes.shape[0] * boxes.shape[1]
    if p != output_size or c % 4 != 0 or g.numel() != total * p * p * c:
        raise ValueError("g must be (T, P, P, C) for the boxes, with C a multiple of 4")
    if (record.dtype != torch.int32 or tuple(record.shape) != (total, len(RECORD))
            or not record.is_contiguous() or record.device != g.device
            or boxes.device != g.device):
        raise TypeError("record must be K1's contiguous int32 (T, 5) record on g's device")
    if any(int(s[-1]) != c or int(s[0]) != boxes.shape[0] for s in feat_shapes):
        raise ValueError("feat_shapes do not match g's channels or the boxes' batch")
    grads = [torch.zeros((int(s[0]), int(s[1]), int(s[2]), c), dtype=torch.float32,
                         device=g.device) for s in feat_shapes]
    if total:
        _launch_adj(g, boxes, record, kw, grads)
        multilevel_roi_align_adjoint_cuda.launches += 1
    return grads


multilevel_roi_align_adjoint_cuda.launches = 0


# --------------------------------------------------------------------------- #
# K3: the training pooler
# --------------------------------------------------------------------------- #

class _TrainPool(torch.autograd.Function):
    """Forward K1 (plain version on the CPU), backward K2; the counterpart
    of JAX `_train_pool` with `use_pallas=True`.  The forward saves the
    boxes, `valid` and the (T, 5) int32 record, and the backward rebuilds
    the weights from them (JAX rebuilds the whole prologue, the same math).
    Boxes get a zero cotangent and `valid` none (roi_align_pallas.py:837-843).
    """

    @staticmethod
    def forward(ctx, boxes, valid, opts, *features):
        p = opts["output_size"]
        with torch.autocast(boxes.device.type, enabled=False):
            if boxes.device.type == "cuda":
                out, record = _forward_kernel(features, boxes, valid, opts)
            else:
                pr = _prepare([f.shape for f in features], boxes, valid=valid, **opts)
                out = _separable_forward(features, pr, p)
                record = _record_of(pr)
        ctx.save_for_backward(boxes, valid, record)
        ctx.opts = opts
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.dtypes = [f.dtype for f in features]
        # invalid ROIs (nty = 0) pool to exact zeros in both versions
        return out.reshape(*boxes.shape[:2], p, p, -1)

    @staticmethod
    def backward(ctx, g):
        boxes, valid, record = ctx.saved_tensors
        g = g.to(torch.float32)
        if g.device.type == "cpu" and valid is not None:
            g = torch.where(valid[..., None, None, None], g, torch.zeros_like(g))
        # on the card K2 skips the invalid rows (nty = 0): g goes in as it is
        dfeats = multilevel_roi_align_adjoint_cuda(g.contiguous(), ctx.shapes, boxes,
                                                   record, **ctx.opts)
        return (torch.zeros_like(boxes), None, None,
                *[d.to(t) for d, t in zip(dfeats, ctx.dtypes)])


def multilevel_roi_align_train(features: Sequence[torch.Tensor],
                               boxes: torch.Tensor, *,
                               strides: Sequence[int], output_size: int,
                               sampling_ratio: int, aligned: bool,
                               impl: str, valid: Optional[torch.Tensor] = None,
                               min_level: int = 2,
                               adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """Batched FPN ROIAlign for training (JAX `multilevel_roi_align_train`):
    features (B, H_l, W_l, C) x 4, boxes (B, N, 4), valid (B, N) bool ->
    (B, N, P, P, C) float32; invalid ROIs pool to zeros and send no
    gradient to the features.

    impl "cuda": `_TrainPool`, K1 forward and K2 backward (their plain
    versions for CPU tensors); the boxes get a zero gradient.  impl
    "torch": the gather formulation `ops/roi_align.py::multilevel_roi_align`
    at detectron2's levels under torch autograd, the counterpart of JAX
    `use_pallas=False`; the boxes are detached.  The model resolves its
    "auto" setting before calling (`PlaneRCNN._pooler_impl`).
    """
    kw = dict(strides=tuple(strides), output_size=int(output_size),
              sampling_ratio=int(sampling_ratio), aligned=bool(aligned),
              min_level=int(min_level), adaptive_cap=adaptive_cap)
    if impl == "cuda":
        return _TrainPool.apply(boxes, valid, kw, *features)
    if impl != "torch":
        raise ValueError(f"unknown pooler impl {impl!r}")
    boxes = boxes.detach()
    out = torch.stack([multilevel_roi_align([f[i] for f in features], boxes[i],
                                            chunk=32, **kw).to(torch.float32)
                       for i in range(boxes.shape[0])])
    if valid is not None:
        out = torch.where(valid[..., None, None, None], out, torch.zeros_like(out))
    return out
