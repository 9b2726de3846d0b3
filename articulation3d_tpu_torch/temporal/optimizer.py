"""Temporal articulation optimization: RANSAC clustering over tracked planes.

Counterpart of `articulation3d_tpu/temporal/optimizer.py` (the reference's
`utils/opt_utils.py:49-974`): the hypothesis sweeps and the IoU product run
on the device (`kernels.py`), the small RANSAC and cluster bookkeeping
stays on the host in numpy/scipy, line for line as in JAX:

  * `optimize_planes(preds, planes, '3dc')` = translation pass, then
    rotation pass on its output;
  * per track, 5 RANSAC rounds: a seed frame from Python's `random.choice`
    (so `random.seed(2020)` reproduces the reference tools), its mask
    lifted through its plane, swept about (along) its decoded axis; a
    frame is an inlier when its best hypothesis IoU exceeds 0.5;
  * cluster score r^2 of `scipy.stats.linregress(order, best angles)`,
    0 under 5 inliers; all scores < 0.3 => `has_rot = False`;
  * the winning cluster's center frame gives the canonical axis, re-encoded
    about each frame's box center (rotation) or copied (translation);
    scores of non-conforming detections are multiplied by 0.6.

Each track's frame masks go to the device once and serve every round and
the regularisation pass; each round fetches its IoU matrix in one transfer.
Kept from the reference: the inlier loop removes from `id_list` while
walking it, so the element after each removal is skipped; the regularised
masks and normals are stored on the track and never applied.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.stats import linregress

from ..data.axis_codec import angle_offset_to_axis, axis_to_angle_offset
from ..structures import resolve_device
from ..utils.camera import get_pcd
from ..utils.coords import camera_to_plane, plane_to_camera
from ..utils.metrics import EA_metric, Line
from .kernels import iou_matrix, rotation_sweep, transform_normals, translation_sweep

SCORE_DOWNWEIGHT = 0.6
INLIER_IOU = 0.5
MIN_CLUSTER = 5
MIN_RSQ = 0.3
NUM_RANSAC = 5


def fit_plane_from_normals(normals: np.ndarray) -> np.ndarray:
    """Smallest right singular vector of normals^T normals
    (`opt_utils.py:49-72`)."""
    normals = np.asarray(normals, np.float64)
    sts = normals.T @ normals
    _, _, vh = np.linalg.svd(sts)
    return vh[2, :]


def _decode_axis(p, kind: str, h: int, w: int) -> np.ndarray:
    """All boxes' axis segments for one frame: (N, 4) int [x1, y1, x2, y2]."""
    centers = p.box_centers
    if kind == "rot":
        params = p.rot_axis
    else:
        params = np.concatenate(
            [p.tran_axis, np.zeros((len(p.tran_axis), 1), np.float32)], axis=1)
    return angle_offset_to_axis(params, centers, H=h, W=w)


def _seed_geometry(p, box_id: int, kind: str, h: int, w: int
                   ) -> Optional[Tuple[np.ndarray, ...]]:
    """(normal, offset, axis_p0, dir_vec) of one seed detection, float64
    (`opt_utils.py:400-420`); None on degenerate geometry."""
    plane_cam = plane_to_camera(p.planes[box_id].astype(np.float64))
    offset = np.linalg.norm(plane_cam)
    if offset < 1e-8:
        return None
    normal = plane_cam / offset
    pts = _decode_axis(p, kind, h, w)[box_id].reshape(2, 2).astype(np.float64)
    axis_3d = np.asarray(get_pcd(pts, normal, offset, h=h, w=w))
    dir_vec = axis_3d[1] - axis_3d[0]
    n = np.linalg.norm(dir_vec)
    if not np.isfinite(n) or n < 1e-12 or not np.all(np.isfinite(axis_3d)):
        return None
    return normal, offset, axis_3d[0], dir_vec / n


def _sweep(mask: torch.Tensor, seed, kind: str, hyp: torch.Tensor,
           h: int, w: int) -> torch.Tensor:
    """(A, H, W) hypothesis masks of a seed mask on its device."""
    normal, offset, p0, dir_vec = (torch.from_numpy(np.asarray(v, np.float32)).to(mask.device)
                                   for v in seed)
    if kind == "rot":
        return rotation_sweep(mask, normal, offset, p0, dir_vec, hyp, h=h, w=w)
    return translation_sweep(mask, normal, offset, dir_vec, hyp, h=h, w=w)


def _track_masks(preds: Sequence, plane: Dict, device) -> torch.Tensor:
    """(T, H, W) float32 masks of a track's frames, in `plane['ids']`
    order, on the device (one upload per track)."""
    stack = np.stack([np.asarray(preds[i].masks[b]) for i, b in plane["ids"].items()])
    return torch.from_numpy(stack).to(device).to(torch.float32)


def _cluster_pass(preds: Sequence, plane: Dict, kind: str, hyp: np.ndarray,
                  h: int, w: int, masks: torch.Tensor) -> List[Dict]:
    """5 RANSAC rounds over one track -> clusters (`opt_utils.py:390-500`).
    `masks`: the track's frame masks from `_track_masks`."""
    row_of = {idx: k for k, idx in enumerate(plane["ids"])}
    hyp_t = torch.from_numpy(np.asarray(hyp, np.float32)).to(masks.device)
    id_list = list(plane["ids"].keys())
    clusters: List[Dict] = []
    for _ in range(NUM_RANSAC):
        if len(id_list) == 0:
            break
        select_idx = random.choice(id_list)
        seed = _seed_geometry(preds[select_idx], plane["ids"][select_idx],
                              kind, h, w)
        cluster = {"center_id": select_idx, "inliners": [],
                   "angles": [], "ious": []}
        if seed is not None:
            proj = _sweep(masks[row_of[select_idx]], seed, kind, hyp_t, h, w)
            rows = torch.tensor([row_of[i] for i in id_list], device=masks.device)
            ious = iou_matrix(masks[rows], proj).cpu().numpy()
            # CPython for-loop + remove() skips the element after each removal
            pos = {idx: k for k, idx in enumerate(id_list)}
            i = 0
            while i < len(id_list):
                idx = id_list[i]
                row = ious[pos[idx]]
                if np.max(row) > INLIER_IOU:
                    cluster["inliners"].append(idx)
                    cluster["angles"].append(float(hyp[int(np.argmax(row))]))
                    cluster["ious"].append(float(np.max(row)))
                    id_list.remove(idx)
                i += 1
        cluster["angles"] = np.asarray(cluster["angles"], np.float32)
        clusters.append(cluster)
    return clusters


def _cluster_rsqs(clusters: List[Dict]) -> np.ndarray:
    """r^2 of angle-vs-order per cluster (`opt_utils.py:503-516`)."""
    rsqs = []
    for cluster in clusters:
        if len(cluster["inliners"]) < MIN_CLUSTER:
            rsqs.append(0.0)
            continue
        reg = linregress(range(cluster["angles"].shape[0]), cluster["angles"])
        rsqs.append(reg.rvalue ** 2)
    return np.array(rsqs) if rsqs else np.array([0.0])


def _regularize(preds, plane, kind: str, hyp_final: np.ndarray,
                select_idx: int, h: int, w: int, masks: torch.Tensor) -> None:
    """Winning-cluster sweep -> per-frame regularised masks (+ normals for
    rotation), stored on the track, never applied (`opt_utils.py:600-649`)."""
    seed = _seed_geometry(preds[select_idx], plane["ids"][select_idx], kind, h, w)
    if seed is None:
        return
    frame_ids = list(plane["ids"].keys())
    hyp_t = torch.from_numpy(np.asarray(hyp_final, np.float32)).to(masks.device)
    proj = _sweep(masks[frame_ids.index(select_idx)], seed, kind, hyp_t, h, w)
    ious = iou_matrix(masks, proj).cpu().numpy()
    proj = proj.cpu().numpy()
    normals_t = None
    if kind == "rot":
        normal, _, _, dir_vec = (torch.from_numpy(np.asarray(v, np.float32)).to(masks.device)
                                 for v in seed)
        normals_t = transform_normals(normal, dir_vec, hyp_t).cpu().numpy()
    plane["reg_masks"] = {}
    plane["reg_normals"] = {}
    for k, idx in enumerate(frame_ids):
        aid = int(np.argmax(ious[k]))
        plane["reg_masks"][idx] = proj[aid]
        if normals_t is not None:
            plane["reg_normals"][idx] = camera_to_plane(normals_t[aid])


def _optimize_kind(preds: Sequence, planes: List[Dict], kind: str,
                   h: int, w: int, device) -> List:
    """Shared body of optimize_planes_3dc / _3d_trans."""
    if kind == "rot":
        hyp_cluster = np.arange(-np.pi / 2, np.pi, np.pi / 30)
        hyp_final = np.arange(-np.pi / 2, np.pi / 2, np.pi / 30)
    else:
        hyp_cluster = np.arange(-1.0, 1.0, 0.1)
        hyp_final = hyp_cluster

    for plane in planes:
        masks = _track_masks(preds, plane, device)
        clusters = _cluster_pass(preds, plane, kind, hyp_cluster, h, w, masks)
        rsqs = _cluster_rsqs(clusters)
        if rsqs.max() < MIN_RSQ:
            plane["has_rot"] = False
            continue
        plane["has_rot"] = True
        final_cluster = clusters[int(np.argmax(rsqs))]
        select_idx = final_cluster["center_id"]
        box_id = plane["ids"][select_idx]
        center_pred = preds[select_idx]
        if kind == "rot":
            plane["std_axis"] = _decode_axis(center_pred, "rot", h, w)[box_id]
        else:
            plane["std_axis"] = center_pred.tran_axis[box_id].copy()
        _regularize(preds, plane, kind, hyp_final, select_idx, h, w, masks)

    # apply back (`opt_utils.py:652-682` / `905-959`)
    opt_preds = []
    other_class = 1 if kind == "rot" else 0
    for idx, p in enumerate(preds):
        new_p = p.copy()
        chosen = np.zeros(len(p), bool)
        chosen[p.classes == other_class] = True  # other category untouched
        for plane in planes:
            if idx not in plane["ids"]:
                continue
            box_id = plane["ids"][idx]
            if not plane["has_rot"]:
                chosen[box_id] = False
                continue
            chosen[box_id] = True
            if kind == "rot":
                center = p.box_centers[box_id]
                enc = axis_to_angle_offset(
                    np.asarray(plane["std_axis"], np.float64)[None],
                    center[None])[0]
                new_p.rot_axis[box_id] = enc[:3]
            else:
                new_p.tran_axis[box_id] = plane["std_axis"]
        new_p.scores = np.where(chosen, new_p.scores,
                                new_p.scores * SCORE_DOWNWEIGHT)
        opt_preds.append(new_p)
    return opt_preds


def optimize_planes_3dc(preds: Sequence, planes: List[Dict], frames=None,
                        h: int = 480, w: int = 640, device=None) -> List:
    """Rotation pass (`opt_utils.py:382-682`); sweeps on `device` (default
    the card)."""
    return _optimize_kind(preds, planes, "rot", h, w, resolve_device(device))


def optimize_planes_3d_trans(preds: Sequence, planes: List[Dict], frames=None,
                             h: int = 480, w: int = 640, device=None) -> List:
    """Translation pass (`opt_utils.py:685-959`); sweeps on `device`."""
    return _optimize_kind(preds, planes, "trans", h, w, resolve_device(device))


def optimize_planes_average(preds: Sequence, planes: List[Dict]) -> List:
    """Mean-axis baseline (`opt_utils.py:77-110`): re-encode each frame's
    rot axis about the image center (320, 240), average over the track,
    write the mean back to every track frame (host only)."""
    h, w = 480, 640
    for plane in planes:
        std_axes = []
        img_center = np.array([[320.0, 240.0]])
        for idx, box_id in plane["ids"].items():
            p = preds[idx]
            pts = _decode_axis(p, "rot", h, w)
            std = axis_to_angle_offset(pts.astype(np.float64),
                                       np.repeat(img_center, len(pts), axis=0))
            std_axes.append(std[box_id, :3])
        plane["std_axis"] = np.mean(np.stack(std_axes), axis=0)

    opt_preds = []
    for idx, p in enumerate(preds):
        new_p = p.copy()
        for plane in planes:
            if idx in plane["ids"]:
                new_p.rot_axis[plane["ids"][idx]] = plane["std_axis"]
        opt_preds.append(new_p)
    return opt_preds


def optimize_planes(preds: Sequence, planes, method: str, frames=None,
                    h: int = 480, w: int = 640, device=None) -> List:
    """Dispatcher (`opt_utils.py:962-974`): '3dc' runs the translation pass
    first, then the rotation pass on its output, with the sweeps on
    `device` (default the card; raises without one)."""
    if method == "average":
        return optimize_planes_average(preds, planes)
    if method == "3dc":
        device = resolve_device(device)
        opt = optimize_planes_3d_trans(preds, planes["trans"], frames=frames,
                                       h=h, w=w, device=device)
        return optimize_planes_3dc(opt, planes["rot"], frames=frames, h=h, w=w,
                                   device=device)
    raise NotImplementedError(method)


# --------------------------------------------------------------------------- #
# diagnostics (`opt_utils.py:977-1065`)
# --------------------------------------------------------------------------- #

def _axis_consistency(segments: np.ndarray) -> List[float]:
    """Pairwise EA of decoded axis segments ((x1,y1,x2,y2) rows -> Line takes
    [y, x] pairs, reference `check_axis:1012-1031`)."""
    scores = []
    n = segments.shape[0]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            try:
                pi, pj = segments[i], segments[j]
                line_i = Line([pi[1], pi[0], pi[3], pi[2]])
                line_j = Line([pj[1], pj[0], pj[3], pj[2]])
                scores.append(EA_metric(line_i, line_j))
            except Exception:
                scores.append(0.0)
    return scores


def check_monotonic(preds: Sequence, opt_preds: Sequence, planes: List[Dict],
                    method: str = "", frames=None
                    ) -> Tuple[List[List[float]], List[List[float]]]:
    """Normal-bundle planarity diagnostic (reference `check_monotonic`,
    `utils/opt_utils.py:1068-1152`): per track, mean |n . plane_n| of the
    frames' camera-space normals against their SVD-fitted plane, for the
    raw and the optimised predictions, as lists of 1-element lists."""
    def track_fit(pred_list, plane) -> float:
        normals = []
        for idx in plane["ids"]:
            box_id = plane["ids"][idx]
            p = pred_list[idx]
            cam = plane_to_camera(p.planes[box_id:box_id + 1])
            n = cam / np.maximum(np.linalg.norm(cam, axis=1, keepdims=True),
                                 1e-12)
            normals.append(n)
        normals = np.concatenate(normals, axis=0)
        plane_n = fit_plane_from_normals(normals)
        return float(np.abs(normals @ plane_n).mean())

    corrs = [[track_fit(preds, pl)] for pl in planes]
    opt_corrs = [[track_fit(opt_preds, pl)] for pl in planes]
    return corrs, opt_corrs


def check_axis(preds: Sequence, opt_preds: Sequence, planes: List[Dict],
               method: str = "", frames=None, h: int = 480, w: int = 640
               ) -> Tuple[List[float], List[float]]:
    """Pre/post-optimisation axis EA-consistency (reference `check_axis`).
    Tracks whose mean score dropped >= 0.1 are excluded (same gate)."""
    scores_all: List[float] = []
    opt_scores_all: List[float] = []
    for plane in planes:
        id_list = list(plane["ids"].keys())

        def collect(pred_list):
            segs, box_scores = [], []
            for idx in id_list:
                box_id = plane["ids"][idx]
                p = pred_list[idx]
                segs.append(_decode_axis(p, "rot", h, w)[box_id])
                box_scores.append(p.scores[box_id])
            return np.stack(segs), np.asarray(box_scores)

        segs, box_scores = collect(preds)
        opt_segs, opt_box_scores = collect(opt_preds)
        scores = _axis_consistency(segs)
        opt_scores = _axis_consistency(opt_segs)
        if box_scores.mean() - opt_box_scores.mean() < 0.1:
            scores_all.extend(scores)
            opt_scores_all.extend(opt_scores)
    return scores_all, opt_scores_all
