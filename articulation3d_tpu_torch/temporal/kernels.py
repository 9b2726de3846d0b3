"""Hypothesis sweeps of the temporal optimizer, as batched torch ops.

Counterpart of `articulation3d_tpu/temporal/kernels.py` (the reference's
per-angle loop, `utils/opt_utils.py:382-682`):

  * all H*W pixels are lifted through the plane once (off-mask pixels carry
    weight 0, so the scatter equals a gather of the mask's pixels);
  * the A hypotheses (45 rotation angles, 30 for the final pass, 20
    translation steps) transform the (HW, 3) points in one batched op to
    (A, HW, 3): Rodrigues rotation about the axis in pytorch3d's row-vector
    convention, `(p - p0) @ R + p0`;
  * each is projected with FOCAL_OPT 517.97 about the image center,
    clamped in float to the image, truncated to int and scatter-maxed into
    an (A, H*W) mask;
  * the per-frame IoU against every hypothesis is one (F, HW) @ (HW, A)
    product of 0/1 masks in float32, exact up to 2^24 pixels.

Numerics held to the JAX package:

  * the ray table is built on the host in float32 (an IEEE division, as
    XLA's), so CPU and card start from the same values;
  * the 3-term products are written as separate torch multiplies and adds,
    never a matmul, so no TF32 or FMA setting changes them;
  * JAX truncates the projected pixel to int32 (saturating) and then
    clips; a torch cast of an out-of-range float is not saturating (and
    undefined on the card), so the port clamps in float to [0, W-1] and
    [0, H-1] first, which gives the same pixel for every finite input
    (`nan_to_num` runs before, as in JAX);
  * the IoU product runs with autocast off: under bf16 autocast the counts
    would round.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.camera import FOCAL_OPT


def pixel_rays(h: int, w: int, device) -> torch.Tensor:
    """(H*W, 3) float32 rays ((x - w/2) / f, (y - h/2) / f, 1), row-major
    over (y, x), with f = FOCAL_OPT."""
    fx = np.float32(FOCAL_OPT)
    rx = (np.arange(w, dtype=np.float32) - np.float32(w / 2.0)) / fx
    ry = (np.arange(h, dtype=np.float32) - np.float32(h / 2.0)) / fx
    rx = torch.from_numpy(rx).to(device)
    ry = torch.from_numpy(ry).to(device)
    return torch.stack([rx[None, :].expand(h, w), ry[:, None].expand(h, w),
                        torch.ones((h, w), dtype=torch.float32, device=device)],
                       dim=-1).reshape(h * w, 3)


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about unit `axis` (3,) by `angle` (...,) ->
    (..., 3, 3), standard column convention, in the dtype of `axis`."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    x, y, z = axis[0], axis[1], axis[2]
    zero = torch.zeros((), dtype=axis.dtype, device=axis.device)
    k = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                     torch.stack([-y, x, zero])])
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * k + (1.0 - c) * (k @ k)


def _rotate(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(N, 3) row vectors times (A, 3, 3) -> (A, N, 3), as three separate
    multiply-adds per output (no matmul, so no TF32 and no FMA)."""
    p = p[None]
    return (p[..., 0:1] * r[:, None, 0, :] + p[..., 1:2] * r[:, None, 1, :]
            + p[..., 2:3] * r[:, None, 2, :])


def _lift(mask: torch.Tensor, normal: torch.Tensor, offset: torch.Tensor,
          h: int, w: int):
    """All-pixels plane lift: (HW, 3) points and (HW,) mask weights."""
    ray = pixel_rays(h, w, mask.device)
    denom = ray[:, 0] * normal[0] + ray[:, 1] * normal[1] + ray[:, 2] * normal[2]
    depth = offset / torch.where(denom == 0, torch.full_like(denom, float("nan")), denom)
    return depth[:, None] * ray, mask.reshape(-1).to(torch.float32)


def _project_scatter(pcd_t: torch.Tensor, weights: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """(A, HW, 3) transformed points -> (A, H, W) scatter-max of weights."""
    fx = FOCAL_OPT
    z = pcd_t[..., 2]
    px = fx * pcd_t[..., 0] / z + w / 2.0
    py = fx * pcd_t[..., 1] / z + h / 2.0
    px = torch.nan_to_num(px, nan=0.0, posinf=0.0, neginf=0.0)
    py = torch.nan_to_num(py, nan=0.0, posinf=0.0, neginf=0.0)
    # clamp in float, then truncate: equals JAX's saturating int32 cast
    # followed by the clip, for every finite input
    col = px.clamp(0.0, float(w - 1)).to(torch.int64)
    row = py.clamp(0.0, float(h - 1)).to(torch.int64)
    flat = row * w + col
    a = pcd_t.shape[0]
    out = torch.zeros((a, h * w), dtype=torch.float32, device=pcd_t.device)
    out.scatter_reduce_(1, flat, weights[None].expand(a, -1), reduce="amax",
                        include_self=True)
    return out.reshape(a, h, w)


def rotation_sweep(mask: torch.Tensor, normal: torch.Tensor, offset: torch.Tensor,
                   axis_point: torch.Tensor, dir_vec: torch.Tensor,
                   angles: torch.Tensor, *, h: int, w: int) -> torch.Tensor:
    """(A, H, W) projected masks of `mask` rotated about the 3D axis through
    `axis_point` along `dir_vec` by each angle (`opt_utils.py:418-456`).
    All inputs float32 tensors on one device."""
    pcd, weights = _lift(mask, normal, offset, h, w)
    pcd_t = _rotate(pcd - axis_point, rodrigues(dir_vec, angles)) + axis_point
    return _project_scatter(pcd_t, weights, h, w)


def translation_sweep(mask: torch.Tensor, normal: torch.Tensor,
                      offset: torch.Tensor, dir_vec: torch.Tensor,
                      steps: torch.Tensor, *, h: int, w: int) -> torch.Tensor:
    """(A, H, W) projected masks of `mask` translated along `dir_vec` by
    each step (`opt_utils.py:723-749`)."""
    pcd, weights = _lift(mask, normal, offset, h, w)
    pcd_t = pcd[None] + steps[:, None, None] * dir_vec
    return _project_scatter(pcd_t, weights, h, w)


def iou_matrix(masks: torch.Tensor, proj_masks: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (F, H, W) frame masks and (A, H, W) hypothesis
    masks -> (F, A) float32; 0/0 stays NaN."""
    with torch.autocast(device_type=masks.device.type, enabled=False):
        f = (masks > 0.5).reshape(masks.shape[0], -1).to(torch.float32)
        a = (proj_masks > 0.5).reshape(proj_masks.shape[0], -1).to(torch.float32)
        inter = f @ a.T
        union = f.sum(1)[:, None] + a.sum(1)[None, :] - inter
        return inter / union


def transform_normals(normal: torch.Tensor, dir_vec: torch.Tensor,
                      angles: torch.Tensor) -> torch.Tensor:
    """(A, 3) plane normals rotated by each angle (pytorch3d
    transform_normals == n @ R for pure rotations, `opt_utils.py:579`)."""
    return _rotate(normal[None], rodrigues(dir_vec, angles))[:, 0]
