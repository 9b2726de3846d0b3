"""Axis codec: 2D line segment <-> (sin, cos, offset) about a box center.

Counterpart of the numpy half of `articulation3d_tpu/data/axis_codec.py`
(the reference's `planercnn_transforms.py:31-176`):

* ``axis_to_angle_offset``: segment [x1,y1,x2,y2] (image pixels) -> line
  parameters about ``center``: x·cos + y·sin = p with p = |C|/|(A,B)| / 100,
  direction signed by sign(C); sign(0) = 0 (center exactly on the line ->
  sin = cos = 0) is kept.
* ``angle_offset_to_axis``: inverse via boundary-point intersection with the
  image rectangle, truncating to int like the reference, with the fallback
  [0,0,1,1] for degenerate axes.

Host-side numpy, used by the temporal optimizer, the visualisation and the
mesh export; ``axis_to_angle_offset_torch`` is the forward codec on tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def axis_to_angle_offset(axis: np.ndarray, centers: np.ndarray,
                         valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Encode line segments as (N, 4) float32 [sin, cos, offset, valid].

    axis (N, 4) [x1, y1, x2, y2] in absolute pixels; rows with
    ``valid == 0`` are replaced by the placeholder [0,0,1,1].  centers
    (N, 2) box centers (cx, cy); valid defaults to all rows.
    """
    axis = np.asarray(axis, np.float64).reshape(-1, 4).copy()
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    if valid is None:
        valid = np.ones(axis.shape[0], bool)
    else:
        valid = np.asarray(valid, bool).reshape(-1)
    axis[~valid] = (0.0, 0.0, 1.0, 1.0)

    rel = axis - np.concatenate([centers, centers], axis=1)
    x1, y1, x2, y2 = rel[:, 0], rel[:, 1], rel[:, 2], rel[:, 3]
    a = y1 - y2
    b = x2 - x1
    c = x1 * y2 - x2 * y1
    norm = np.sqrt(a * a + b * b)
    # a degenerate segment (p1 == p2) gives nan, as in the reference
    norm = np.where(norm == 0, np.nan, norm)
    offset = np.abs(c) / norm / 100.0
    sgn = np.sign(c)
    cos = -a * sgn / norm
    sin = -b * sgn / norm
    out = np.stack([sin, cos, offset, valid.astype(np.float64)], axis=1)
    return out.astype(np.float32)


def axis_to_angle_offset_torch(axis: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Tensor twin of `axis_to_angle_offset` on (..., 4) segments and
    (..., 2) centres, every row taken as given: (..., 4) [sin, cos,
    offset, valid], valid 0 (and the rest 0) where the segment is a point."""
    rel = axis - torch.cat([centers, centers], dim=-1)
    x1, y1, x2, y2 = rel.unbind(-1)
    a = y1 - y2
    b = x2 - x1
    c = x1 * y2 - x2 * y1
    norm = torch.sqrt(a * a + b * b)
    safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    offset = c.abs() / safe / 100.0
    sgn = torch.sign(c)
    cos = -a * sgn / safe
    sin = -b * sgn / safe
    valid = (norm > 0).to(axis.dtype)
    return torch.stack([sin, cos, offset, valid], dim=-1)


def get_boundary_point(y: float, x: float, angle: float, H: int, W: int
                       ) -> Tuple[Optional[Tuple[int, int]], Optional[Tuple[int, int]]]:
    """Intersect the line through (x, y) at ``angle`` with the image border
    (the reference's branch cascade, int truncation, first two hits)."""
    point1 = None
    point2 = None
    if angle == -np.pi / 2:
        point1 = (x, 0)
        point2 = (x, H - 1)
    elif angle == 0.0:
        point1 = (0, y)
        point2 = (W - 1, y)
    else:
        k = np.tan(angle)
        if 0 <= y - k * x < H:  # left border
            if point1 is None:
                point1 = (0, int(y - k * x))
            elif point2 is None:
                point2 = (0, int(y - k * x))
                if point2 == point1:
                    point2 = None
        if 0 <= k * (W - 1) + y - k * x < H:  # right border
            if point1 is None:
                point1 = (W - 1, int(k * (W - 1) + y - k * x))
            elif point2 is None:
                point2 = (W - 1, int(k * (W - 1) + y - k * x))
                if point2 == point1:
                    point2 = None
        if 0 <= x - y / k < W:  # top border
            if point1 is None:
                point1 = (int(x - y / k), 0)
            elif point2 is None:
                point2 = (int(x - y / k), 0)
                if point2 == point1:
                    point2 = None
        if 0 <= x - y / k + (H - 1) / k < W:  # bottom border
            if point1 is None:
                point1 = (int(x - y / k + (H - 1) / k), H - 1)
            elif point2 is None:
                point2 = (int(x - y / k + (H - 1) / k), H - 1)
                if point2 == point1:
                    point2 = None
        if point2 is None:
            point2 = point1
    return point1, point2


def angle_offset_to_axis(angle_offsets: np.ndarray, centers: np.ndarray,
                         H: int = 480, W: int = 640) -> np.ndarray:
    """Decode (sin, cos, offset) rows back to boundary-clipped segments:
    (N, 4) int64 [x1, y1, x2, y2], [0,0,1,1] where the line misses the
    image."""
    angle_offsets = np.asarray(angle_offsets, np.float64).reshape(-1, 3)
    centers = np.asarray(centers, np.float64).reshape(-1, 2)
    out = []
    for (sin, cos, p), (x0, y0) in zip(angle_offsets, centers):
        p = p * 100.0
        if sin == 0:
            angle = -np.pi / 2
        else:
            angle = -np.arctan(cos / sin)
        x, y = p * cos + x0, p * sin + y0
        p1, p2 = get_boundary_point(y, x, angle, H, W)
        if p1 is None or p2 is None:
            out.append([0, 0, 1, 1])
        else:
            out.append([p1[0], p1[1], p2[0], p2[1]])
    return np.asarray(out, np.int64)
