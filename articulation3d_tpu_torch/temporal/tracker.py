"""Greedy IoU plane tracker over video frames (host-side, tiny).

A copy of `articulation3d_tpu/temporal/tracker.py`, which re-implements the
reference `track_planes` (`utils/opt_utils.py:1156-1208`):
per frame, per detection (by class: 0 = rot, 1 = trans), match against the
first existing same-class track whose last box has IoU > 0.5 and whose last
frame is <= 5 frames back; otherwise open a new track.  Tracks shorter than
10 frames are dropped.

Frame predictions are any objects exposing numpy ``boxes`` (N, 4 XYXY) and
``classes`` (N,) attributes (`structures.FramePrediction` fits).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MAX_FRAME_GAP = 5
MIN_TRACK_LEN = 10
TRACK_IOU = 0.5


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    ub = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = ua + ub - inter
    return inter / union if union > 0 else 0.0


def track_planes(preds: Sequence) -> Dict[str, List[dict]]:
    """preds: per-frame predictions -> {'rot': [track], 'trans': [track]}.

    Track dict: {'bbox': last box (4,), 'ids': {frame_idx: box_id},
    'latest_frame': int} — the reference's exact structure.
    """
    planes: Dict[str, List[dict]] = {"rot": [], "trans": []}

    for idx, p in enumerate(preds):
        boxes = np.asarray(p.boxes, np.float64).reshape(-1, 4)
        classes = np.asarray(p.classes).reshape(-1)
        for box_id in range(boxes.shape[0]):
            current_box = boxes[box_id]
            plane_cat = "trans" if classes[box_id] == 1 else "rot"

            has_overlap = False
            for plane in planes[plane_cat]:
                if idx - plane["latest_frame"] > MAX_FRAME_GAP:
                    continue
                if _iou(current_box, plane["bbox"]) > TRACK_IOU:
                    has_overlap = True
                    plane["ids"][idx] = box_id
                    plane["bbox"] = current_box
                    plane["latest_frame"] = idx
                    break

            if not has_overlap:
                planes[plane_cat].append({
                    "bbox": current_box,
                    "ids": {idx: box_id},
                    "latest_frame": idx,
                })

    for cat in planes:
        planes[cat] = [p for p in planes[cat] if len(p["ids"]) >= MIN_TRACK_LEN]
    return planes
