"""Pinhole camera constants and back-projection rays (numpy).

Counterpart of the parts of `articulation3d_tpu/utils/camera.py` that the
inference path uses.  Two focal lengths are in play, as in the reference:
FOCAL_OPT 517.97 for the temporal optimizer and mesh lifting, FOCAL_EVAL
571.623718 with principal point (319.5, 239.5) for the depth and
evaluation paths.
"""

from __future__ import annotations

import numpy as np

FOCAL_OPT = 517.97
FOCAL_EVAL = 571.623718


def intrinsics_eval() -> np.ndarray:
    """K of the eval/depth path."""
    return np.array([[FOCAL_EVAL, 0.0, 319.5],
                     [0.0, FOCAL_EVAL, 239.5],
                     [0.0, 0.0, 1.0]])


def get_k_inv_dot_xy_1_eval(h: int = 480, w: int = 640) -> np.ndarray:
    """(3, h*w) float64 back-projection rays with the EVAL intrinsics."""
    k_inv = np.linalg.inv(intrinsics_eval())
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    homo = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)], axis=0)
    return k_inv @ homo
