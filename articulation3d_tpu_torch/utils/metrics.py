"""Line/plane/axis comparison metrics (numpy, vectorized).

A copy of `articulation3d_tpu/utils/metrics.py` (numpy only), which
re-implements the reference metric kernel
(`articulation3d/articulation3d/utils/metrics.py:5-102`):

* ``Line``: [y0, x0, y1, x1] endpoint container with ``angle()``;
* ``sa_metric`` / ``se_metric`` / ``EA_metric``: squared angle-similarity x
  squared endpoint-center similarity (`metrics.py:52-68`);
* ``compare_planes`` / ``compare_axis``: pairwise normal-angle and offset-L1
  cost matrices, with the reference's chord->angle conversion
  2*asin(d/2) (`metrics.py:5-51`);

plus batched ``ea_matrix`` which evaluates all (pred, gt) line pairs at once
in place of the evaluator's O(P*G) Python loops
(`evaluation/arti_evaluation.py:262-665`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class Line:
    """Line segment [y0, x0, y1, x1] (reference `metrics.py:71-102`)."""

    def __init__(self, coordinates: Sequence[float] = (0, 0, 1, 1)):
        coordinates = list(coordinates)
        assert len(coordinates) == 4
        assert coordinates[0] != coordinates[2] or coordinates[1] != coordinates[3]
        self._coord = coordinates

    @property
    def coord(self) -> List[float]:
        return self._coord

    @property
    def length(self) -> float:
        start = np.array(self.coord[:2])
        end = np.array(self.coord[2:])
        return float(np.sqrt(((start - end) ** 2).sum()))

    def angle(self) -> float:
        y0, x0, y1, x1 = self.coord
        if x0 == x1:
            return -np.pi / 2
        return float(np.arctan((y0 - y1) / (x0 - x1)))

    def rescale(self, rh: float, rw: float) -> None:
        coor = np.array(self._coord)
        r = np.array([rh, rw, rh, rw])
        self._coord = np.round(coor * r).astype(np.int64).tolist()

    def __repr__(self):
        return str(self.coord)


def sa_metric(angle_p: float, angle_g: float) -> float:
    d = np.abs(angle_p - angle_g)
    d = min(d, np.pi - d)
    d = d * 2 / np.pi
    return max(0.0, 1.0 - d) ** 2


def se_metric(coord_p: Sequence[float], coord_g: Sequence[float],
              size: Tuple[int, int] = (640, 480)) -> float:
    c_p = [(coord_p[0] + coord_p[2]) / 2, (coord_p[1] + coord_p[3]) / 2]
    c_g = [(coord_g[0] + coord_g[2]) / 2, (coord_g[1] + coord_g[3]) / 2]
    d = np.sqrt((c_p[0] - c_g[0]) ** 2 + (c_p[1] - c_g[1]) ** 2) / max(size)
    return max(0.0, 1.0 - d) ** 2


def EA_metric(l_pred: Line, l_gt: Line,
              size: Tuple[int, int] = (640, 480)) -> float:
    return sa_metric(l_pred.angle(), l_gt.angle()) * \
        se_metric(l_pred.coord, l_gt.coord, size=size)


def _seg_angles(segs: np.ndarray) -> np.ndarray:
    """Vectorized Line.angle over (N, 4) [y0, x0, y1, x1] rows."""
    y0, x0, y1, x1 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    dx = x0 - x1
    with np.errstate(divide="ignore", invalid="ignore"):
        ang = np.arctan((y0 - y1) / dx)
    return np.where(dx == 0, -np.pi / 2, ang)


def ea_matrix(pred_segs: np.ndarray, gt_segs: np.ndarray,
              size: Tuple[int, int] = (640, 480)) -> np.ndarray:
    """All-pairs EA scores: (P, 4) x (G, 4) [y0,x0,y1,x1] -> (P, G).

    Batched equivalent of the per-pair EA_metric loops in
    `evaluation/arti_evaluation.py` — identical values, one shot.
    """
    pred_segs = np.asarray(pred_segs, np.float64).reshape(-1, 4)
    gt_segs = np.asarray(gt_segs, np.float64).reshape(-1, 4)
    if pred_segs.shape[0] == 0 or gt_segs.shape[0] == 0:
        return np.zeros((pred_segs.shape[0], gt_segs.shape[0]))
    ap = _seg_angles(pred_segs)[:, None]
    ag = _seg_angles(gt_segs)[None, :]
    d_ang = np.abs(ap - ag)
    d_ang = np.minimum(d_ang, np.pi - d_ang) * 2 / np.pi
    sa = np.maximum(0.0, 1.0 - d_ang) ** 2

    cp = (pred_segs[:, :2] + pred_segs[:, 2:]) / 2
    cg = (gt_segs[:, :2] + gt_segs[:, 2:]) / 2
    d = np.linalg.norm(cp[:, None, :] - cg[None, :, :], axis=-1) / max(size)
    se = np.maximum(0.0, 1.0 - d) ** 2
    return sa * se


def compare_planes(pred_planes: np.ndarray, gt_planes: np.ndarray
                   ) -> Dict[str, np.ndarray]:
    """Pairwise normal angle (deg) + offset L1 matrices (`metrics.py:5-19`)."""
    pred = np.asarray(pred_planes, np.float32).reshape(-1, 3)
    gt = np.asarray(gt_planes, np.float32).reshape(-1, 3)
    pred_off = np.linalg.norm(pred, axis=1) + 1e-5
    gt_off = np.linalg.norm(gt, axis=1) + 1e-5
    pred_n = pred / pred_off[:, None]
    gt_n = gt / gt_off[:, None]
    chord = np.clip(np.linalg.norm(
        pred_n[:, None, :] - gt_n[None, :, :], axis=-1), 0, 2)
    norm_angle = 2 * np.arcsin(chord / 2) / np.pi * 180
    offset = np.abs(pred_off[:, None] - gt_off[None, :])
    return {"norm": norm_angle, "offset": offset}


def compare_planes_one_to_one(pred_planes: np.ndarray, gt_planes: np.ndarray
                              ) -> Dict[str, float]:
    """Means of row-wise l2 / normal angle (rad) / offset errors
    (`metrics.py:21-32`)."""
    pred = np.asarray(pred_planes, np.float32).reshape(-1, 3)
    gt = np.asarray(gt_planes, np.float32).reshape(-1, 3)
    pred_off = np.maximum(np.linalg.norm(pred, axis=1), 1e-5)
    gt_off = np.maximum(np.linalg.norm(gt, axis=1), 1e-5)
    pred_n = pred / pred_off[:, None]
    gt_n = gt / gt_off[:, None]
    l2 = np.linalg.norm(pred - gt, axis=1).mean()
    norm = np.arccos(np.clip((pred_n * gt_n).sum(axis=1), -1, 1)).mean()
    offset = np.abs(pred_off - gt_off).mean()
    return {"l2": float(l2), "norm": float(norm), "offset": float(offset)}


def compare_axis(pred_axis: np.ndarray, gt_axis: np.ndarray
                 ) -> Dict[str, np.ndarray]:
    """Pairwise (sin,cos) chord-angle + offset matrices (`metrics.py:36-51`)."""
    pred_axis = np.asarray(pred_axis, np.float32).reshape(-1, 3)
    gt_axis = np.asarray(gt_axis, np.float32).reshape(-1, 3)
    if pred_axis.shape[0] == 0 or gt_axis.shape[0] == 0:
        return {"norm": np.zeros((pred_axis.shape[0], gt_axis.shape[0])),
                "offset": np.zeros((pred_axis.shape[0], gt_axis.shape[0]))}
    chord = np.clip(np.linalg.norm(
        pred_axis[:, None, :2] - gt_axis[None, :, :2], axis=-1), 0, 2)
    norm_angle = 2 * np.arcsin(chord / 2) / np.pi * 180
    offset = np.abs(pred_axis[:, 2, None] - gt_axis[None, :, 2])
    return {"norm": norm_angle, "offset": offset}
