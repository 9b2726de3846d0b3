"""Fixed-capacity detection structures (counterpart of `structures.py`).

Every per-image collection is padded to a static capacity and carries an
explicit `valid` mask, as in the JAX package, so batched code needs no
ragged shapes.  Boxes are XYXY float in absolute pixels (detectron2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Detections:
    """A fixed-capacity batch of detections, tensors of shape (..., N, ...).

    boxes (..., N, 4), scores (..., N), classes (..., N) int64,
    valid (..., N) bool; optional masks (..., N, M, M) mask probabilities,
    planes (..., N, 3), rot_axis (..., N, 3) [sin, cos, offset],
    tran_axis (..., N, 2) [sin, cos].
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    planes: Optional[torch.Tensor] = None
    rot_axis: Optional[torch.Tensor] = None
    tran_axis: Optional[torch.Tensor] = None


class FramePrediction:
    """Per-frame prediction for the temporal pipeline (host numpy).

    boxes (N, 4 XYXY), scores (N,), classes (N,), masks (N, H, W) bool at
    image resolution, planes (N, 3), rot_axis (N, 3) [sin, cos, offset],
    tran_axis (N, 2) [sin, cos].
    """

    def __init__(self, boxes, scores, classes, masks, planes,
                 rot_axis, tran_axis):
        self.boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        self.scores = np.asarray(scores, np.float32).reshape(-1)
        self.classes = np.asarray(classes, np.int64).reshape(-1)
        self.masks = np.asarray(masks)
        self.planes = np.asarray(planes, np.float32).reshape(-1, 3)
        self.rot_axis = np.asarray(rot_axis, np.float32).reshape(-1, 3)
        self.tran_axis = np.asarray(tran_axis, np.float32).reshape(-1, 2)

    def __len__(self):
        return len(self.boxes)

    @property
    def box_centers(self) -> np.ndarray:
        return (self.boxes[:, :2] + self.boxes[:, 2:]) / 2.0

    def copy(self) -> "FramePrediction":
        """A copy whose boxes, scores, classes, planes and axes are new
        arrays (the temporal optimizer writes into them); the masks are
        shared, as in the JAX package."""
        return FramePrediction(self.boxes.copy(), self.scores.copy(),
                               self.classes.copy(), self.masks,
                               self.planes.copy(), self.rot_axis.copy(),
                               self.tran_axis.copy())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when no card is found and none was named; it never
    falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")
