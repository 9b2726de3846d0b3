"""Fixed-capacity detection structures (counterpart of `structures.py`).

Every per-image collection is padded to a static capacity and carries an
explicit `valid` mask, as in the JAX package, so batched code needs no
ragged shapes.  Boxes are XYXY float in absolute pixels (detectron2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def num_valid(self) -> torch.Tensor:
        """Valid detections per image, (...,) int64."""
        return self.valid.sum(-1)

    def replace(self, **kw) -> "Detections":
        return dataclasses.replace(self, **kw)

    def asdict(self) -> Dict[str, torch.Tensor]:
        """The fields that are set, by name (the tensors themselves)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @classmethod
    def empty(cls, capacity: int, with_masks: Optional[int] = None,
              planes: bool = False, axes: bool = False, *,
              device) -> "Detections":
        """One image's all-invalid detections of `capacity` rows on
        `device`, with (capacity, M, M) masks for `with_masks` = M, planes
        and the two axes when asked."""
        zeros = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=device)
        d = cls(boxes=zeros(capacity, 4), scores=zeros(capacity),
                classes=zeros(capacity, dtype=torch.int64),
                valid=zeros(capacity, dtype=torch.bool))
        if with_masks is not None:
            d.masks = zeros(capacity, with_masks, with_masks)
        if planes:
            d.planes = zeros(capacity, 3)
        if axes:
            d.rot_axis, d.tran_axis = zeros(capacity, 3), zeros(capacity, 2)
        return d

    def to_host(self) -> "HostDetections":
        """One image's valid rows as numpy arrays (bfloat16 as float32)."""
        valid = self.valid.detach().cpu().numpy()
        assert valid.ndim == 1, "to_host operates on a single image"
        keep = np.nonzero(valid)[0]
        out = {}
        for name, v in self.asdict().items():
            if name == "valid":
                continue
            v = v.detach().cpu()
            out[name] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()[keep]
        return HostDetections(**out)


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


class HostDetections:
    """Trimmed numpy detections for host-side stages (tracker, eval,
    export); `full_masks` (N, H, W) are the pasted binary masks."""

    def __init__(self, boxes, scores, classes, masks=None, planes=None,
                 rot_axis=None, tran_axis=None, full_masks=None):
        self.boxes = boxes
        self.scores = scores
        self.classes = classes
        self.masks = masks
        self.planes = planes
        self.rot_axis = rot_axis
        self.tran_axis = tran_axis
        self.full_masks = full_masks

    def __len__(self):
        return len(self.boxes)


def pad_to(t: torch.Tensor, n: int, axis: int = 0, value=0) -> torch.Tensor:
    """Pad (or truncate) `t` to size `n` along `axis` with `value`."""
    cur = t.shape[axis]
    if cur >= n:
        return t.narrow(axis, 0, n)
    shape = list(t.shape)
    shape[axis] = n - cur
    return torch.cat([t, t.new_full(shape, value)], dim=axis)


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
