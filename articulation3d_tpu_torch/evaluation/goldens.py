"""Whole-model golden-tensor parity harness.

Counterpart of `articulation3d_tpu/evaluation/goldens.py`.  A fixture is one
`.npz` per probe image, written by `tools/make_goldens.py` in the reference
environment, by `tools/make_goldens_oracle.py` (the reference model's
stand-in), or by `save_goldens` from this port's own outputs:

  image          (H, W, 3) uint8 BGR raw frame (pre-normalization)
  p2..p6         (C, Hl, Wl) float32 FPN features (torch NCHW layout)
  proposal_boxes (N, 4) float32 XYXY post-NMS RPN proposals
  proposal_logits(N,)  float32 objectness
  det_boxes      (D, 4), det_scores (D,), det_classes (D,) int64
  pred_masks     (D, 28, 28) float32 mask-head probabilities   [optional]
  pred_planes    (D, 3)                                        [optional]
  pred_rot_axis  (D, 3), pred_tran_axis (D, 2)                 [optional]
  depth          (480, 640) float32                            [optional]
  meta_*         the small config an oracle fixture was made with

`compare_goldens` runs the port's `PlaneRCNN.inference_probe` (where the
JAX package runs `run_probe`) on the stored image and reports the same
per-stage error statistics.  Detections are greedily matched by box IoU
(score order) before the per-field errors, so a benign NMS ordering
difference does not read as a parity failure.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.preprocess import preprocess_images
from ..weights import d2_key_shapes

FEATURE_KEYS = ("p2", "p3", "p4", "p5", "p6")


def save_goldens(path: str, goldens: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **goldens)


def load_goldens(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / np.clip(union, 1e-9, None)
    # degenerate (zero-area) boxes: coincident corners count as a match, so
    # random-weight self-consistency checks do not fail spuriously
    corner_close = np.all(np.abs(a[:, None] - b[None]) < 1e-3, axis=-1)
    return np.where(union <= 1e-9, corner_close.astype(iou.dtype), iou)


def match_detections(ref_boxes: np.ndarray, out_boxes: np.ndarray,
                     iou_thresh: float = 0.7):
    """Greedy IoU matching; returns (ref_idx, out_idx) index arrays."""
    if len(ref_boxes) == 0 or len(out_boxes) == 0:
        return np.zeros(0, int), np.zeros(0, int)
    iou = _box_iou(ref_boxes, out_boxes)
    ref_idx, out_idx = [], []
    used = np.zeros(len(out_boxes), bool)
    for i in range(len(ref_boxes)):
        j = int(np.argmax(np.where(used, -1.0, iou[i])))
        if iou[i, j] >= iou_thresh and not used[j]:
            used[j] = True
            ref_idx.append(i)
            out_idx.append(j)
    return np.asarray(ref_idx, int), np.asarray(out_idx, int)


def full_d2_key_shapes(num_classes: int = 2) -> Dict[str, tuple]:
    """{d2 state-dict key: shape} of every key the shipped `model_final.pth`
    carries: PlaneRCNN R50-FPN with the mask, plane, axis and depth heads
    (reference `config/config.yaml`), the anchor generator's buffers
    included."""
    return d2_key_shapes(num_classes)


def run_probe(model, image_bgr: np.ndarray) -> Dict[str, Any]:
    """The port's probe on one raw BGR uint8 frame, on the model's device:
    preprocess, then `PlaneRCNN.inference_probe`; tensors come back as
    numpy (the detections as a `Detections` of numpy arrays)."""
    cfg = model.config
    dev = next(model.parameters()).device
    frames = torch.from_numpy(np.ascontiguousarray(image_bgr[None])).to(dev)
    images = preprocess_images(frames, cfg.input.pixel_mean, cfg.input.pixel_std,
                               height=cfg.input.height, width=cfg.input.width,
                               size_divisibility=cfg.input.size_divisibility)
    out = model.inference_probe(images)
    to_np = lambda t: None if t is None else t.detach().cpu().numpy()
    det = out["detections"]
    out["detections"] = type(det)(**{f: to_np(getattr(det, f))
                                     for f in det.__dataclass_fields__})
    out["features"] = {k: to_np(v) for k, v in out["features"].items()}
    for k in ("proposal_boxes", "proposal_logits", "proposal_valid", "depth"):
        out[k] = to_np(out[k])
    return out


def compare_goldens(goldens: Dict[str, np.ndarray], model,
                    score_thresh: float = 0.05) -> Dict[str, float]:
    """Per-stage parity report of `model` (a `PlaneRCNN` in eval mode)
    against a fixture: {stage: max abs error, or a statistic}."""
    probe = run_probe(model, goldens["image"])
    report: Dict[str, float] = {}

    for k in FEATURE_KEYS:
        if k not in goldens:
            continue
        ref = goldens[k]                       # (C, H, W)
        ours = probe["features"][k][0]
        if ref.shape != ours.shape:
            report[f"feat_{k}_max_err"] = float("inf")
            continue
        report[f"feat_{k}_max_err"] = float(np.abs(ref - ours).max())

    if "proposal_boxes" in goldens:
        ref_boxes = goldens["proposal_boxes"]
        valid = probe["proposal_valid"][0]
        ours = probe["proposal_boxes"][0][valid]
        n = min(len(ref_boxes), len(ours), 100)  # top-100 by score order
        ri, oi = match_detections(ref_boxes[:n], ours[:n], iou_thresh=0.9)
        report["proposal_top100_match_frac"] = len(ri) / max(n, 1)

    dets = probe["detections"]
    keep = dets.valid[0] & (dets.scores[0] > score_thresh)
    out_boxes = dets.boxes[0][keep]
    ref_keep = goldens["det_scores"] > score_thresh
    ref_boxes = goldens["det_boxes"][ref_keep]
    ri, oi = match_detections(ref_boxes, out_boxes)
    report["det_ref_count"] = float(len(ref_boxes))
    report["det_out_count"] = float(len(out_boxes))
    report["det_match_frac"] = len(ri) / max(len(ref_boxes), 1)
    if len(ri):
        report["det_box_max_err"] = float(
            np.abs(ref_boxes[ri] - out_boxes[oi]).max())
        report["det_score_max_err"] = float(np.abs(
            goldens["det_scores"][ref_keep][ri] - dets.scores[0][keep][oi]).max())
        for field, key in (("pred_masks", "masks"), ("pred_planes", "planes"),
                           ("pred_rot_axis", "rot_axis"),
                           ("pred_tran_axis", "tran_axis")):
            if field in goldens and getattr(dets, key) is not None:
                ref_v = goldens[field][ref_keep][ri]
                out_v = getattr(dets, key)[0][keep][oi]
                report[f"{key}_max_err"] = float(np.abs(ref_v - out_v).max())

    if "depth" in goldens and probe.get("depth") is not None:
        report["depth_max_err"] = float(
            np.abs(goldens["depth"] - probe["depth"][0]).max())
    return report


def goldens_from_probe(model, image_bgr: np.ndarray,
                       meta: Dict[str, Any] | None = None) -> Dict[str, np.ndarray]:
    """A fixture in the format above from the port's own probe on one
    frame (valid proposals and detections only); `meta` adds `meta_*`
    entries, e.g. the small config `compare_goldens`'s CLI rebuilds."""
    probe = run_probe(model, image_bgr)
    g: Dict[str, np.ndarray] = {"image": np.asarray(image_bgr, np.uint8)}
    for k, v in probe["features"].items():
        g[k] = v[0].astype(np.float32)
    pv = probe["proposal_valid"][0]
    g["proposal_boxes"] = probe["proposal_boxes"][0][pv].astype(np.float32)
    g["proposal_logits"] = probe["proposal_logits"][0][pv].astype(np.float32)
    det = probe["detections"]
    dv = det.valid[0]
    g["det_boxes"] = det.boxes[0][dv].astype(np.float32)
    g["det_scores"] = det.scores[0][dv].astype(np.float32)
    g["det_classes"] = det.classes[0][dv].astype(np.int64)
    for field, key in (("pred_masks", "masks"), ("pred_planes", "planes"),
                       ("pred_rot_axis", "rot_axis"), ("pred_tran_axis", "tran_axis")):
        v = getattr(det, key)
        if v is not None:
            g[field] = v[0][dv].astype(np.float32)
    if probe.get("depth") is not None:
        g["depth"] = probe["depth"][0].astype(np.float32)
    for k, v in (meta or {}).items():
        g[f"meta_{k}"] = np.asarray(v)
    return g
