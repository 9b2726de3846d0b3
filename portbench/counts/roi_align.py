"""The least time of one multilevel ROIAlign forward call (K1) on an H100:
a frozen copy of `chip_smoke.py::_bound` (475-506), computed from the boxes
alone.  Each input cell that some ROI's samples touch is read once (the
union over ROIs of the rectangle between each ROI's first and last touched
cell, per level and image), boxes and valid flags read once, and the whole
(B, N, P, P, C) float32 output written once, over 3.35 TB/s; operations
count one multiply-add per output value of a valid ROI (a lower bound),
over 67 TFLOP/s.  The call's time is the larger of the two.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..peaks import FP32_FLOPS, HBM_BYTES_PER_S

STRIDES = (4, 8, 16, 32)


def levels(boxes: np.ndarray) -> np.ndarray:
    """detectron2's FPN level (2..5) of each (..., 4) box."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lvl = np.floor(4 + np.log2(np.sqrt(np.maximum(area, 0)) / 224.0 + 1e-8))
    return np.clip(lvl, 2, 5).astype(np.int64)


def _cells(lo, size, p, ratio, n, aligned):
    """First and last cell (inclusive) one axis's samples touch, and
    whether any sample lies inside [-1, n]."""
    size = size if aligned else np.maximum(size, 1.0)
    grid = np.full_like(size, ratio) if ratio > 0 else np.maximum(np.ceil(size / p), 1)
    first = lo + 0.5 * size / p / grid
    last = lo + (p - 0.5 / grid) * size / p
    inside = (last >= -1.0) & (first <= n)
    a = np.minimum(np.floor(np.maximum(first, 0.0)), n - 1)
    b = np.minimum(np.floor(np.maximum(last, 0.0)) + 1, n - 1)
    return a.astype(np.int64), b.astype(np.int64), inside


def touched_cells(shapes: Sequence[Tuple[int, int]], boxes: np.ndarray, valid: np.ndarray,
                  p: int, ratio: int, aligned: bool) -> int:
    """Cells of the p2..p5 maps, (h, w) each, that the valid ROIs of (B, N, 4)
    boxes read, counted once per image."""
    lv = levels(boxes)
    off = 0.5 if aligned else 0.0
    total = 0
    for b in range(boxes.shape[0]):
        for i, (h, w) in enumerate(shapes):
            sel = valid[b] & (lv[b] == i + 2)
            if not sel.any():
                continue
            bx = boxes[b, sel].astype(np.float64) / STRIDES[i] - off
            y0, y1, iy = _cells(bx[:, 1], bx[:, 3] - bx[:, 1], p, ratio, h, aligned)
            x0, x1, ix = _cells(bx[:, 0], bx[:, 2] - bx[:, 0], p, ratio, w, aligned)
            ok = iy & ix
            diff = np.zeros((h + 1, w + 1), np.int64)
            np.add.at(diff, (y0[ok], x0[ok]), 1)
            np.add.at(diff, (y0[ok], x1[ok] + 1), -1)
            np.add.at(diff, (y1[ok] + 1, x0[ok]), -1)
            np.add.at(diff, (y1[ok] + 1, x1[ok] + 1), 1)
            total += int((diff.cumsum(0).cumsum(1)[:h, :w] > 0).sum())
    return total


def bound_seconds(shapes: Sequence[Tuple[int, int]], boxes: np.ndarray, valid: np.ndarray,
                  p: int, ratio: int, aligned: bool, channels: int = 256,
                  in_bytes: int = 2) -> Tuple[float, str]:
    """(least seconds, "bytes" | "operations") of one K1 call over (B, N, 4)
    boxes with (B, N) valid flags, maps of `in_bytes` per value."""
    cells = touched_cells(shapes, boxes, valid, p, ratio, aligned)
    b, n = boxes.shape[:2]
    nbytes = cells * channels * in_bytes + b * n * 16 + b * n + b * n * p * p * channels * 4
    flops = 2 * int(valid.sum()) * p * p * channels
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
