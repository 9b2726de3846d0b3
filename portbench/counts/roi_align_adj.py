"""The least time of one multilevel ROIAlign adjoint call (K2) on an H100,
computed from the boxes alone, as `chip_smoke.py::_adjoint_bound` counts:
the cotangent rows of the valid ROIs read once, (P, P, C) float32 each, and
every float32 cell of the four (B, H_l, W_l, C) level gradients written
once, over 3.35 TB/s (a kernel that gathers per output cell needs no
more: the zero fill and the scatter's read-modify-write are costs of a
design, not of the function); and one multiply-add per channel for each
pair of an output row's and an output column's touched cells, summed over
the P rows and P columns of each valid ROI (the separable adjoint), over
67 TFLOP/s.  The call's time is the larger of the two.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..peaks import FP32_FLOPS, HBM_BYTES_PER_S
from .roi_align import STRIDES, levels


def _row_supports(lo: np.ndarray, size: np.ndarray, p: int, ratio: int, n: int) -> np.ndarray:
    """(R,) sums over the P output rows of one axis of the number of cells
    each row's samples touch (bilinear taps, detectron2's border rule)."""
    grid = np.full_like(size, ratio) if ratio > 0 else np.maximum(np.ceil(size / p), 1)
    b = size / p
    i = np.arange(p)[None, :]
    first = lo[:, None] + (i + 0.5 / grid[:, None]) * b[:, None]
    last = lo[:, None] + (i + 1 - 0.5 / grid[:, None]) * b[:, None]
    inside = (last >= -1.0) & (first <= n)
    a = np.minimum(np.floor(np.maximum(first, 0.0)), n - 1)
    z = np.minimum(np.floor(np.maximum(last, 0.0)) + 1, n - 1)
    return np.where(inside, z - a + 1, 0).sum(1)


def bound_seconds(shapes: Sequence[Tuple[int, int]], boxes: np.ndarray, valid: np.ndarray,
                  p: int, ratio: int, aligned: bool, channels: int = 256) -> Tuple[float, str]:
    """(least seconds, "bytes" | "operations") of one K2 call over (B, N, 4)
    boxes with (B, N) valid flags and p2..p5 maps of (h, w) each."""
    b = boxes.shape[0]
    lv = levels(boxes)
    off = 0.5 if aligned else 0.0
    flops = 0
    for i, (h, w) in enumerate(shapes):
        sel = valid & (lv == i + 2)
        if not sel.any():
            continue
        bx = boxes[sel].astype(np.float64) / STRIDES[i] - off
        ys, xs = bx[:, 3] - bx[:, 1], bx[:, 2] - bx[:, 0]
        if not aligned:
            ys, xs = np.maximum(ys, 1.0), np.maximum(xs, 1.0)
        sy = _row_supports(bx[:, 1], ys, p, ratio, h)
        sx = _row_supports(bx[:, 0], xs, p, ratio, w)
        flops += int((2 * channels * sy * sx).sum())
    cells = b * sum(h * w for h, w in shapes)
    nbytes = int(valid.sum()) * p * p * channels * 4 + cells * channels * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
