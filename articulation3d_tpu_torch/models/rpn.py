"""Region Proposal Network: anchors, head, fixed-capacity proposal selection.

Counterpart of `articulation3d_tpu/models/rpn.py` (detectron2 RPN /
StandardRPNHead / DefaultAnchorGenerator / find_top_rpn_proposals): one
anchor size per level x ratios (0.5, 1, 2), offset 0; per level the top
`pre_nms_topk` anchors by objectness are decoded (weights 1,1,1,1),
clipped, filtered (non-empty, finite) and NMS'd at 0.7; across levels the
top `post_nms_topk` survivors are kept.  The batch is a leading dimension,
and the result is a fixed-capacity (B, K, 4) array with a valid mask.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tracing
from ..config import AnchorConfig, RPNConfig
from ..ops.box_ops import clip_boxes, decode_deltas, nonempty
from ..ops.nms import NEG_INF, nms_mask, select_top, top_k
from .fpn import FPN_STRIDES


def generate_cell_anchors(size: float, aspect_ratios: Sequence[float]) -> np.ndarray:
    """detectron2 `generate_cell_anchors`: centred XYXY anchors of one size."""
    anchors = []
    area = size * size
    for ar in aspect_ratios:
        w = math.sqrt(area / ar)
        h = ar * w
        anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, np.float32)


def anchors_for_level(feat_h: int, feat_w: int, stride: int, size: float,
                      aspect_ratios: Sequence[float], offset: float = 0.0) -> np.ndarray:
    """(H*W*A, 4) anchors of one level, row-major over (y, x, anchor)."""
    cell = generate_cell_anchors(size, aspect_ratios)
    sx, sy = np.meshgrid((np.arange(feat_w) + offset) * stride,
                         (np.arange(feat_h) + offset) * stride)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).astype(np.float32)
    return (shifts[:, :, None, :] + cell[None, None, :, :]).reshape(-1, 4)


class RPNHead(nn.Module):
    """StandardRPNHead: 3x3 conv + relu -> 1x1 objectness and 1x1 deltas.

    `num_conv` > 1 is the DRPN head (reference `drpn.py:13-28`, JAX
    rpn.py:59-96): `conv` is a Sequential of `num_conv` plain 3x3 convs with
    no activation between them, and the one ReLU follows the stack."""

    def __init__(self, in_channels: int, num_anchors: int, num_conv: int = 1):
        super().__init__()
        conv = lambda: nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.conv = conv() if num_conv == 1 else nn.Sequential(
            *[conv() for _ in range(num_conv)])
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


def select_proposals(level_logits: Sequence[torch.Tensor],
                     level_deltas: Sequence[torch.Tensor],
                     level_anchors: Sequence[torch.Tensor], *,
                     image_height: int, image_width: int, pre_nms_topk: int,
                     post_nms_topk: int, nms_thresh: float, min_size: float,
                     bbox_reg_weights=(1.0, 1.0, 1.0, 1.0)
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched `select_proposals_single`.  Per level: logits (B, n),
    deltas (B, n, 4) in (y, x, anchor) order, anchors (n, 4).
    Returns boxes (B, K, 4), scores (B, K), valid (B, K), K = post_nms_topk.

    The levels are stacked as (B, L, N) sets, N the largest level's top-k,
    each padded with invalid rows (which leave its keep mask unchanged):
    one decode and one `nms_mask` call serve every level.
    """
    sizes = [min(pre_nms_topk, a.shape[0]) for a in level_anchors]
    b, n = level_logits[0].shape[0], max(sizes)
    dev = level_anchors[0].device
    set_scores = torch.zeros((b, len(sizes), n), dtype=torch.float32, device=dev)
    set_deltas = torch.zeros((b, len(sizes), n, 4), dtype=torch.float32, device=dev)
    set_anchors = torch.zeros((b, len(sizes), n, 4), dtype=torch.float32, device=dev)
    in_level = torch.zeros((b, len(sizes), n), dtype=torch.bool, device=dev)
    for i, (scores, deltas, anchors) in enumerate(zip(level_logits, level_deltas,
                                                      level_anchors)):
        k = sizes[i]
        top_scores, idx = top_k(scores.to(torch.float32), k)
        set_scores[:, i, :k] = top_scores
        set_deltas[:, i, :k] = torch.gather(deltas.to(torch.float32), 1,
                                            idx[..., None].expand(-1, -1, 4))
        set_anchors[:, i, :k] = anchors[idx]
        in_level[:, i, :k] = True
    boxes = clip_boxes(decode_deltas(set_deltas, set_anchors, bbox_reg_weights),
                       image_height, image_width)
    valid = in_level & nonempty(boxes, min_size) & torch.isfinite(boxes).all(dim=-1)
    keep = nms_mask(boxes, set_scores, valid, nms_thresh)
    # back to the levels' concatenation
    boxes, scores, kept = (torch.cat([t[:, i, :k] for i, k in enumerate(sizes)], dim=1)
                           for t in (boxes, set_scores, keep))
    idx, out_valid = select_top(scores, kept, post_nms_topk)
    top_scores = torch.gather(scores, 1, idx)
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.where(out_valid, top_scores, torch.full_like(top_scores, NEG_INF)),
            out_valid)


class RPN(nn.Module):
    """RPN over the FPN levels (d2 key prefix `proposal_generator`)."""

    def __init__(self, cfg: RPNConfig = RPNConfig(),
                 anchor_cfg: AnchorConfig = AnchorConfig(), in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        self.anchor_cfg = anchor_cfg
        self.rpn_head = RPNHead(in_channels, len(anchor_cfg.aspect_ratios), cfg.head_convs)

    def anchors(self, shapes: Sequence[Tuple[int, int]], device) -> List[torch.Tensor]:
        out = []
        for i, (name, (h, w)) in enumerate(zip(self.cfg.in_features, shapes)):
            a = torch.from_numpy(anchors_for_level(
                h, w, FPN_STRIDES[name], self.anchor_cfg.sizes[i][0],
                self.anchor_cfg.aspect_ratios, self.anchor_cfg.offset))
            with tracing.sync("anchors", device):
                out.append(a.to(device))
        return out

    def forward(self, features: Dict[str, torch.Tensor], *, image_height: int,
                image_width: int, training: bool = False):
        """features: {p2..p6} NCHW -> proposals dict(boxes (B, K, 4),
        scores (B, K), valid (B, K)), made without gradient.

        Inference returns the proposals alone.  `training=True` selects
        with the train top-k (`pre_nms_topk_train`, `post_nms_topk_train`)
        and returns (proposals, raw) with raw = dict(logits [(B, n_l)],
        deltas [(B, n_l, 4)], anchors [(n_l, 4)]) per level in (y, x,
        anchor) order, the outputs `train.targets.rpn_losses` reads.
        """
        feats = [features[f] for f in self.cfg.in_features]
        with tracing.span("rpn.head"):
            logits, deltas = self.rpn_head(feats)
        b = feats[0].shape[0]
        # (B, A, H, W) -> (B, H*W*A) and (B, A*4, H, W) -> (B, H*W*A, 4):
        # the (y, x, anchor) order of the anchors
        logits = [lg.permute(0, 2, 3, 1).reshape(b, -1) for lg in logits]
        deltas = [dl.permute(0, 2, 3, 1).reshape(b, -1, 4) for dl in deltas]
        cfg = self.cfg
        with torch.no_grad(), tracing.span("rpn.select"):
            anchors = self.anchors([f.shape[2:] for f in feats], feats[0].device)
            boxes, scores, valid = select_proposals(
                [lg.detach() for lg in logits], [dl.detach() for dl in deltas],
                anchors, image_height=image_height, image_width=image_width,
                pre_nms_topk=cfg.pre_nms_topk_train if training else cfg.pre_nms_topk_test,
                post_nms_topk=cfg.post_nms_topk_train if training else cfg.post_nms_topk_test,
                nms_thresh=cfg.nms_thresh, min_size=cfg.min_size,
                bbox_reg_weights=cfg.bbox_reg_weights)
        proposals = {"boxes": boxes, "scores": scores, "valid": valid}
        if not training:
            return proposals
        return proposals, {"logits": logits, "deltas": deltas, "anchors": anchors}
