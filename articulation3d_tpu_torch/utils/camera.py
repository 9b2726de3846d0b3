"""Pinhole camera constants, lifting and projection (numpy, float64).

Counterpart of `articulation3d_tpu/utils/camera.py`, in numpy float64.
Two focal lengths are in play, as in the reference:
FOCAL_OPT 517.97 with the principal point at the image center for the
temporal optimizer and mesh lifting, FOCAL_EVAL 571.623718 with principal
point (319.5, 239.5) for the depth and evaluation paths.  Do not mix them.
"""

from __future__ import annotations

import numpy as np

FOCAL_OPT = 517.97
FOCAL_EVAL = 571.623718


def intrinsics(h: int = 480, w: int = 640,
               focal_length: float = FOCAL_OPT) -> np.ndarray:
    """K with the principal point at the image center."""
    return np.array([[focal_length, 0.0, w / 2.0],
                     [0.0, focal_length, h / 2.0],
                     [0.0, 0.0, 1.0]])


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


def get_pcd(verts: np.ndarray, normal: np.ndarray, offset, h: int = 480,
            w: int = 640, focal_length: float = FOCAL_OPT) -> np.ndarray:
    """Lift (N, 2) pixels (x, y) to the plane n . p = offset: depth =
    offset / (n . K^-1 q) -> (N, 3) camera-space points."""
    k_inv = np.linalg.inv(intrinsics(h, w, focal_length))
    homo = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1)
    ray = homo @ k_inv.T
    depth = np.asarray(offset) / (ray @ np.asarray(normal))
    return depth[:, None] * ray


def get_pcd_depth(verts: np.ndarray, depth_map: np.ndarray, h: int = 480,
                  w: int = 640, focal_length: float = FOCAL_OPT) -> np.ndarray:
    """Lift (N, 2) pixels (x, y) through a depth map -> (N, 3) points.
    The reference reads `depth[tuple(verts.T)]`, i.e. depth[x, y] with
    (x, y) pixels; that indexing is kept as it is."""
    k_inv = np.linalg.inv(intrinsics(h, w, focal_length))
    homo = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1)
    ray = homo @ k_inv.T
    vi = np.asarray(verts).astype(np.int32)
    d = np.asarray(depth_map)[vi[:, 0], vi[:, 1]]
    return d[:, None] * ray


def precompute_K_inv_dot_xy_1(h: int = 480, w: int = 640) -> np.ndarray:
    """(3, h, w) float64 back-projection rays at focal 517.97 and principal
    point (320, 240), the pixel grid rescaled to 640x480."""
    k_inv = np.linalg.inv(np.array([[FOCAL_OPT, 0, 320.0],
                                    [0, FOCAL_OPT, 240.0],
                                    [0, 0, 1.0]]))
    ys = np.arange(h, dtype=np.float64) / h * 480
    xs = np.arange(w, dtype=np.float64) / w * 640
    xx, yy = np.meshgrid(xs, ys)
    homo = np.stack([xx, yy, np.ones_like(xx)], axis=0)
    return np.einsum("ij,jhw->ihw", k_inv, homo)


def project2D(pcd: np.ndarray, h: int = 480, w: int = 640,
              focal_length: float = FOCAL_OPT) -> np.ndarray:
    """Project (N, 3) camera-space points to (N, 2) pixels."""
    k = intrinsics(h, w, focal_length)
    proj = pcd @ k.T
    return proj[:, :2] / proj[:, 2][:, None]
