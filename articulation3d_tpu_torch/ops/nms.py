"""Exact greedy NMS on fixed-capacity, batched box sets.

Counterpart of `articulation3d_tpu/ops/nms.py`.  Boxes are visited in
descending score order (a stable sort, so ties keep input order, as the
JAX package's `jnp.argsort` does); a box is suppressed iff it overlaps an
earlier KEPT box with IoU > threshold.  Invalid entries never suppress.

Instead of a loop over rows, the keep mask is found as the fixed point of

    keep[j] = valid[j] and not any_{i < j} (keep[i] and iou[i, j] > t)

iterated from keep = valid.  After k sweeps the first k positions in sorted
order are final, so the sweep ends within N steps; in practice suppression
chains are short and it ends after a handful.  The relation has exactly one
fixed point, the greedy result, so stopping at the first sweep that changes
nothing is exact.  Every leading dimension is a batch of independent sets.
"""

from __future__ import annotations

import torch

from .. import tracing
from .box_ops import pairwise_iou

NEG_INF = -1e10


def top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (a stable sort of
    the negated values, like the JAX package's sort-based top_k)."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask, aligned with the INPUT order.

    boxes (..., N, 4), scores (..., N), valid (..., N) bool -> (..., N) bool.
    """
    tracing.count("nms.calls")
    with tracing.span("nms"):
        n = boxes.shape[-2]
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        order = torch.sort(-masked, dim=-1, stable=True).indices
        sboxes = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
        svalid = torch.gather(valid, -1, order)

        later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
        sup = (pairwise_iou(sboxes, sboxes) > iou_threshold) & later
        keep = svalid
        for _ in range(n):
            killed = (keep[..., :, None] & sup).any(dim=-2)
            new = svalid & ~killed
            with tracing.sync("nms", new):      # one host wait per sweep
                same = torch.equal(new, keep)
            if same:
                break
            keep = new
        return torch.zeros_like(keep).scatter(-1, order, keep)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     classes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Class-wise NMS via the coordinate-offset trick (detectron2
    batched_nms); the offset is taken per set over its valid boxes."""
    vb = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = vb.flatten(-2).max(dim=-1).values + 1.0
    offsets = classes.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold)


def select_top(scores: torch.Tensor, keep: torch.Tensor, k: int):
    """Top-k kept entries by score: (indices (..., k), valid (..., k)),
    indices into the input ordered by descending score; `valid` is False
    where fewer than k survive."""
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    top_scores, idx = top_k(masked, k)
    return idx, top_scores > NEG_INF / 2
