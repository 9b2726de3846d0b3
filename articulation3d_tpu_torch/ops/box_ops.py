"""Box geometry: IoU, Box2BoxTransform encode and decode, clipping,
emptiness, smooth L1.

Counterpart of `articulation3d_tpu/ops/box_ops.py` (detectron2 semantics:
box-head weights (10, 10, 5, 5), RPN weights (1, 1, 1, 1), dw/dh clamped at
log(1000/16)).  All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import math

import torch

# detectron2 clamps dw/dh at log(1000/16)
_SCALE_CLAMP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M) intersection areas."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M) IoU, 0 where the union is empty."""
    inter = pairwise_intersection(boxes1, boxes2)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def decode_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: (..., 4) deltas onto (..., 4) boxes."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=_SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=_SCALE_CLAMP)

    pred_cx = dx * widths + cx
    pred_cy = dy * heights + cy
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, width),
                        boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width),
                        boxes[..., 3].clamp(0, height)], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return (((boxes[..., 2] - boxes[..., 0]) > threshold)
            & ((boxes[..., 3] - boxes[..., 1]) > threshold))


def encode_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor,
                  weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box2BoxTransform.get_deltas: regression targets src -> target."""
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h
    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    eps = 1e-12
    dx = wx * (tgt_cx - src_cx) / src_w.clamp(min=eps)
    dy = wy * (tgt_cy - src_cy) / src_h.clamp(min=eps)
    dw = ww * torch.log(tgt_w.clamp(min=eps) / src_w.clamp(min=eps))
    dh = wh * torch.log(tgt_h.clamp(min=eps) / src_h.clamp(min=eps))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """fvcore smooth_l1, elementwise: plain L1 when beta is 0 (the
    reference's setting)."""
    diff = (pred - target).abs()
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
