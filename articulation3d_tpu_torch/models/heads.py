"""ROI heads: box (FastRCNN), mask, plane and articulation-axis heads.

Counterpart of `articulation3d_tpu/models/heads.py`, with detectron2 /
reference module names (`box_head.fc{i}`, `box_predictor.{cls_score,
bbox_pred}`, `mask_head.{mask_fcn{i},deconv,predictor}`,
`plane_head.{plane_conv{i},plane_fc1,param_pred}`,
`axis_head.{axis_R_*,axis_T_*,rotation,offset,translation}`).

Pooled features arrive channels-last (R, P, P, C), as the poolers return
them; each head permutes them to (R, C, P, P) first, so the first FC
flattens in d2's (C, P, P) order and d2 weights load as they are.

`fast_rcnn_inference` is detectron2's `fast_rcnn_inference_single_image`
with static shapes, batched over images: the (R, C) score matrix flattens
to R*C candidates that are score-thresholded, class-wise NMS'd and cut to
the top `detections_per_image`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import (AxisHeadConfig, BoxHeadConfig, MaskHeadConfig,
                      PlaneHeadConfig, ROIHeadsConfig)
from ..ops.box_ops import clip_boxes, decode_deltas
from ..ops.nms import batched_nms_mask, select_top


def safe_unit(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize the last axis; all-zero rows stay zero."""
    sq = (v * v).sum(dim=-1, keepdim=True)
    nz = sq > 0
    n = torch.sqrt(torch.where(nz, sq, torch.ones_like(sq)))
    return torch.where(nz, v / n.clamp(min=eps), torch.zeros_like(v))


def double_angle(sin_cos: torch.Tensor) -> torch.Tensor:
    """[sin a, cos a] -> [sin 2a, cos 2a]."""
    sin, cos = sin_cos[..., 0], sin_cos[..., 1]
    return torch.stack([2 * sin * cos, cos ** 2 - sin ** 2], dim=-1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead with num_conv = 0: flatten -> FC + relu, x num_fc."""

    def __init__(self, cfg: BoxHeadConfig, in_channels: int = 256):
        super().__init__()
        self.num_fc = cfg.num_fc
        dim = in_channels * cfg.pooler_resolution ** 2
        for i in range(cfg.num_fc):
            setattr(self, f"fc{i + 1}", nn.Linear(dim, cfg.fc_dim))
            dim = cfg.fc_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x).flatten(1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class BoxPredictor(nn.Module):
    """FastRCNNOutputLayers: class logits (C + 1) and per-class deltas."""

    def __init__(self, cfg: BoxHeadConfig, num_classes: int):
        super().__init__()
        n_reg = 1 if cfg.cls_agnostic_bbox_reg else num_classes
        self.cls_score = nn.Linear(cfg.fc_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(cfg.fc_dim, n_reg * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            return self.cls_score(x), self.bbox_pred(x)


def fast_rcnn_inference(scores: torch.Tensor, deltas: torch.Tensor,
                        proposal_boxes: torch.Tensor,
                        proposal_valid: torch.Tensor, *, image_height: int,
                        image_width: int, cfg: ROIHeadsConfig,
                        bbox_reg_weights=(10.0, 10.0, 5.0, 5.0)) -> Dict[str, torch.Tensor]:
    """scores (B, R, C+1) logits, deltas (B, R, C*4 or 4), proposal boxes
    (B, R, 4), valid (B, R) -> dict(boxes (B, D, 4), scores (B, D),
    classes (B, D), valid (B, D)), D = cfg.detections_per_image."""
    c = cfg.num_classes
    b, r = scores.shape[:2]
    probs = torch.softmax(scores, dim=-1)[..., :c]
    deltas = deltas.reshape(b, r, -1, 4).expand(b, r, c, 4)
    boxes = clip_boxes(decode_deltas(deltas, proposal_boxes[:, :, None, :],
                                     bbox_reg_weights), image_height, image_width)
    flat_scores = probs.reshape(b, r * c)
    flat_boxes = boxes.reshape(b, r * c, 4)
    flat_classes = torch.arange(c, device=scores.device).repeat(r).expand(b, r * c)
    flat_valid = (proposal_valid.repeat_interleave(c, dim=1)
                  & (flat_scores > cfg.score_thresh_test))
    keep = batched_nms_mask(flat_boxes, flat_scores, flat_classes, flat_valid,
                            cfg.nms_thresh_test)
    idx, valid = select_top(flat_scores, keep, cfg.detections_per_image)
    top = torch.gather(flat_scores, 1, idx)
    return {
        "boxes": torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "scores": torch.where(valid, top, torch.zeros_like(top)),
        "classes": torch.gather(flat_classes, 1, idx),
        "valid": valid,
    }


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead: num_conv x (3x3 conv + relu), 2x2/s2 deconv
    + relu, 1x1 predictor.  (R, P, P, C) -> logits (R, n_out, 2P, 2P)."""

    def __init__(self, cfg: MaskHeadConfig, num_classes: int, in_channels: int = 256):
        super().__init__()
        self.num_conv = cfg.num_conv
        cin = in_channels
        for i in range(cfg.num_conv):
            setattr(self, f"mask_fcn{i + 1}", nn.Conv2d(cin, cfg.conv_dim, 3, padding=1))
            cin = cfg.conv_dim
        self.deconv = nn.ConvTranspose2d(cin, cfg.conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(cfg.conv_dim, 1 if cfg.cls_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x)).to(torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            return self.predictor(x)


def _add_conv_fc_tower(module: nn.Module, prefix: str, num_conv: int,
                       conv_dim: int, num_fc: int, fc_dim: int,
                       in_channels: int, resolution: int) -> None:
    """Register a plain conv + FC tower (`{prefix}_conv{i}`, `{prefix}_fc{i}`)
    directly on `module`, where the d2 checkpoint keys put it."""
    cin = in_channels
    for i in range(num_conv):
        setattr(module, f"{prefix}_conv{i + 1}", nn.Conv2d(cin, conv_dim, 3, padding=1))
        cin = conv_dim
    dim = cin * resolution * resolution
    for i in range(num_fc):
        setattr(module, f"{prefix}_fc{i + 1}", nn.Linear(dim, fc_dim))
        dim = fc_dim


def _conv_fc_tower(module: nn.Module, prefix: str, x: torch.Tensor,
                   num_conv: int, num_fc: int) -> torch.Tensor:
    """Run the tower registered by `_add_conv_fc_tower` on NCHW `x`."""
    for i in range(num_conv):
        x = F.relu(getattr(module, f"{prefix}_conv{i + 1}")(x))
    x = x.flatten(1)
    for i in range(num_fc):
        x = F.relu(getattr(module, f"{prefix}_fc{i + 1}")(x))
    return x.to(torch.float32)


class PlaneHead(nn.Module):
    """Plane-parameter head: tower -> param_pred, unit-normalized when
    normal_only."""

    def __init__(self, cfg: PlaneHeadConfig, in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        _add_conv_fc_tower(self, "plane", cfg.num_conv, cfg.conv_dim, cfg.num_fc,
                           cfg.fc_dim, in_channels, cfg.pooler_resolution)
        self.param_pred = nn.Linear(cfg.fc_dim, cfg.param_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = _conv_fc_tower(self, "plane", _nchw(x), self.cfg.num_conv, self.cfg.num_fc)
        with torch.autocast(t.device.type, enabled=False):
            p = self.param_pred(t)
        return safe_unit(p) if self.cfg.normal_only else p


class AxisHead(nn.Module):
    """Twin rotation/translation towers.  Returns rot_axis (R, 3) =
    [sin, cos, offset] with (sin, cos) unit, and tran_axis (R, 2) unit."""

    def __init__(self, cfg: AxisHeadConfig, in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        for rt in ("R", "T"):
            _add_conv_fc_tower(self, f"axis_{rt}", cfg.num_conv, cfg.conv_dim,
                               cfg.num_fc, cfg.fc_dim, in_channels,
                               cfg.pooler_resolution)
        self.rotation = nn.Linear(cfg.fc_dim, 2)
        self.offset = nn.Linear(cfg.fc_dim, 1)
        self.translation = nn.Linear(cfg.fc_dim, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _nchw(x)
        xr = _conv_fc_tower(self, "axis_R", x, self.cfg.num_conv, self.cfg.num_fc)
        xt = _conv_fc_tower(self, "axis_T", x, self.cfg.num_conv, self.cfg.num_fc)
        with torch.autocast(x.device.type, enabled=False):
            rot = torch.cat([safe_unit(self.rotation(xr)), self.offset(xr)], dim=-1)
            tran = safe_unit(self.translation(xt))
        return rot, tran
