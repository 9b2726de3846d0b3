"""PlaneRCNN meta-architecture: eval-mode and training forwards.

Counterpart of `articulation3d_tpu/models/planercnn.py` (`features`,
`_pool`, `inference`, `inference_probe`, `train_forward`):

    R50 -> FPN -> RPN -> box pool + box head + class-wise NMS ->
      cascade on the final boxes: mask -> plane -> axis    -> depth head
      [-> refine head: refined full-image masks and plane offsets]

Module names are the detectron2 checkpoint's (`backbone`,
`proposal_generator`, `roi_heads.{box_head,box_predictor,mask_head,
plane_head,axis_head}`, `depth_head`), so a d2 state dict loads with
`load_state_dict`.  Pooler conventions of the reference: box ROIAlignV2
7x7 sampling ratio 0; mask ROIAlign 14x14 ratio 2; plane/axis ROIAlign
14x14 ratio 0.

The trunk and heads run NCHW in `model.dtype` (bfloat16 through autocast,
weights float32); features, ROI outputs and depth are float32.  The ROI
poolers take the p2..p5 maps channels-last, permuted once per forward;
inference pools them in the compute dtype with the kernel, training pools
float32 maps through `multilevel_roi_align_train` (K1 forward, K2
backward).

With `refine_on` (and the mask, plane and depth heads) the refine head
(`models/refine_head.py`) runs in float32 after the cascade, one image at
a time (JAX vmaps it over the batch: the same numbers, at one image's
activations).  Inference returns its masks as `full_masks` and its plane
offsets as the planes; training runs the detection cascade without
gradient on the sampled proposals and returns the refine head's inputs
and logits as `outputs["refine"]` (JAX planercnn.py:261-277, 303-326,
412-451).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from .. import tracing
from ..config import Config
from ..ops.roi_align import multilevel_roi_align
from ..ops.roi_align_cuda import (multilevel_roi_align_cuda,
                                 multilevel_roi_align_train)
from ..structures import Detections, resolve_device
from ..ops.mask_paste import paste_masks
from .depth_head import DepthHead
from .fpn import FPN
from .heads import (AxisHead, BoxHead, BoxPredictor, MaskHead, PlaneHead,
                    fast_rcnn_inference)
from .refine_head import RefineHead, refine_inference_masks
from .resnet import ResNet
from .rpn import RPN

ROI_STRIDES = (4, 8, 16, 32)  # p2..p5


class ROIHeads(nn.Module):
    """Container with the reference's `roi_heads.*` key names."""

    def __init__(self, config: Config):
        super().__init__()
        mcfg = config.model
        nc = mcfg.roi_heads.num_classes
        c = mcfg.fpn.out_channels
        self.box_head = BoxHead(mcfg.box_head, c)
        self.box_predictor = BoxPredictor(mcfg.box_head, nc)
        if mcfg.mask_on:
            self.mask_head = MaskHead(mcfg.mask_head, nc, c)
        if mcfg.plane_on:
            self.plane_head = PlaneHead(mcfg.plane_head, c)
        if mcfg.axis_on:
            self.axis_head = AxisHead(mcfg.axis_head, c)


class PlaneRCNN(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        mcfg = config.model
        self.config = config
        self.compute_dtype = (torch.bfloat16 if mcfg.dtype == "bfloat16"
                              else torch.float32)
        self.backbone = FPN(ResNet(mcfg.resnet), mcfg.fpn)
        self.proposal_generator = RPN(mcfg.rpn, mcfg.anchors, mcfg.fpn.out_channels)
        self.roi_heads = ROIHeads(config)
        if mcfg.depth_on:
            self.depth_head = DepthHead(mcfg.depth_head, mcfg.fpn.out_channels)
        if mcfg.refine_on:
            self.refine_head = RefineHead(mcfg.refine_head)

    def _refines(self) -> bool:
        m = self.config.model
        return m.refine_on and m.mask_on and m.plane_on and m.depth_on

    def _autocast(self, device: torch.device):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.compute_dtype)

    # ------------------------------------------------------------------ #
    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: preprocessed (B, H, W, 3) -> {p2..p6} float32 NCHW maps."""
        x = images.permute(0, 3, 1, 2).contiguous()
        with self._autocast(x.device):
            feats = self.backbone(x)
        return {k: v.to(torch.float32) for k, v in feats.items()}

    def _pooler_impl(self, device: torch.device) -> str:
        impl = self.config.model.roi_pooler_impl
        if impl == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if impl not in ("cuda", "torch"):
            raise ValueError(f"unknown roi_pooler_impl {impl!r}")
        return impl

    def roi_features(self, features: Dict[str, torch.Tensor],
                     training: bool = False) -> List[torch.Tensor]:
        """p2..p5 permuted once to channels-last (B, H, W, C), in the dtype
        the configured pooler reads: for inference the compute dtype with
        the kernel and float32 for the gather formulation; for training
        always float32 (the JAX training pooler does not cast)."""
        feats = [features[f] for f in self.config.model.roi_heads.in_features]
        dtype = (self.compute_dtype if not training
                 and self._pooler_impl(feats[0].device) == "cuda" else torch.float32)
        return [f.permute(0, 2, 3, 1).contiguous().to(dtype) for f in feats]

    def _pool(self, roi_feats: List[torch.Tensor], boxes: torch.Tensor, *,
              resolution: int, sampling_ratio: int, aligned: bool,
              valid: Optional[torch.Tensor] = None,
              training: bool = False) -> torch.Tensor:
        """Multilevel ROIAlign over the batch: (B, N, 4) -> (B, N, P, P, C).
        With the kernel, invalid ROIs pool to zeros at no cost.  `training`
        pools through `multilevel_roi_align_train` with the boxes detached:
        no gradient reaches ROI coordinates (d2 creates proposals under
        no_grad; JAX planercnn.py:97-108)."""
        kw = dict(strides=ROI_STRIDES, output_size=resolution,
                  sampling_ratio=sampling_ratio, aligned=aligned)
        impl = self._pooler_impl(boxes.device)
        if training:
            return multilevel_roi_align_train(roi_feats, boxes.detach(), valid=valid,
                                              impl=impl, **kw)
        if impl == "cuda":
            return multilevel_roi_align_cuda(roi_feats, boxes, valid=valid, **kw)
        return torch.stack([
            multilevel_roi_align([f[i] for f in roi_feats], boxes[i], chunk=32, **kw)
            for i in range(boxes.shape[0])])

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def inference(self, images: torch.Tensor,
                  gt_boxes: Optional[torch.Tensor] = None,
                  gt_classes: Optional[torch.Tensor] = None,
                  gt_valid: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Eval-mode forward on preprocessed (B, H, W, 3) frames.

        gt_*: optional (B, N, ...) boxes that replace detection (the
        reference's TEST.EVAL_GT_BOX path).  Returns dict(detections=
        Detections, depth=(B, H_out, W_out), pool_valid={stage: (B,) valid
        ROI counts}, features, proposals).
        """
        cfg = self.config
        mcfg = cfg.model
        h, w = cfg.input.height, cfg.input.width
        with tracing.span("model.backbone"):
            feats = self.features(images)
            roi_feats = self.roi_features(feats)
        pool_valid: Dict[str, torch.Tensor] = {}
        proposals = None

        if gt_boxes is None:
            with tracing.span("model.rpn"), self._autocast(images.device):
                proposals = self.proposal_generator(feats, image_height=h,
                                                    image_width=w)
        with tracing.span("model.roi_heads"):
            if gt_boxes is not None:
                dets = {"boxes": gt_boxes, "scores": gt_valid.to(torch.float32),
                        "classes": gt_classes, "valid": gt_valid}
            else:
                b, k = proposals["boxes"].shape[:2]
                with tracing.span("roi_heads.box_pool"):
                    pooled = self._pool(roi_feats, proposals["boxes"],
                                        resolution=mcfg.box_head.pooler_resolution,
                                        sampling_ratio=mcfg.box_head.pooler_sampling_ratio,
                                        aligned=True, valid=proposals["valid"])
                    pool_valid["box"] = proposals["valid"].sum(dim=1)
                with tracing.span("roi_heads.box_head"):
                    with self._autocast(images.device):
                        x = self.roi_heads.box_head(pooled.reshape(b * k, *pooled.shape[2:]))
                    scores, deltas = self.roi_heads.box_predictor(x)
                with tracing.span("roi_heads.class_nms"):
                    dets = fast_rcnn_inference(
                        scores.reshape(b, k, -1), deltas.reshape(b, k, -1),
                        proposals["boxes"], proposals["valid"], image_height=h,
                        image_width=w, cfg=mcfg.roi_heads,
                        bbox_reg_weights=mcfg.box_head.bbox_reg_weights)

            out = dict(dets)
            b, d = dets["boxes"].shape[:2]

            def pool(hcfg, stage: str) -> torch.Tensor:
                with tracing.span("roi_heads.cascade_pool"):
                    pooled = self._pool(roi_feats, dets["boxes"],
                                        resolution=hcfg.pooler_resolution,
                                        sampling_ratio=hcfg.pooler_sampling_ratio,
                                        aligned=False, valid=dets["valid"])
                    pool_valid[stage] = dets["valid"].sum(dim=1)
                return pooled

            shared = None
            if (mcfg.share_detection_pool and mcfg.mask_on
                    and (mcfg.plane_on or mcfg.axis_on)
                    and mcfg.mask_head.pooler_resolution == mcfg.plane_head.pooler_resolution):
                shared = pool(mcfg.plane_head, "shared")
            if mcfg.mask_on:
                mp = pool(mcfg.mask_head, "mask") if shared is None else shared
                with tracing.span("roi_heads.mask"):
                    with self._autocast(images.device):
                        logits = self.roi_heads.mask_head(mp.reshape(b * d, *mp.shape[2:]))
                    probs = torch.sigmoid(logits)
                    if mcfg.mask_head.cls_agnostic:
                        probs = probs[:, 0]
                    else:
                        cls = dets["classes"].reshape(b * d).long()
                        probs = probs[torch.arange(b * d, device=probs.device), cls]
                    out["masks"] = probs.reshape(b, d, *probs.shape[1:])

            if mcfg.plane_on or mcfg.axis_on:
                pp = pool(mcfg.plane_head, "plane") if shared is None else shared
                flat = pp.reshape(b * d, *pp.shape[2:])
                with tracing.span("roi_heads.plane_axis"), self._autocast(images.device):
                    if mcfg.plane_on:
                        out["planes"] = self.roi_heads.plane_head(flat).reshape(b, d, -1)
                    if mcfg.axis_on:
                        rot, tran = self.roi_heads.axis_head(flat)
                        out["rot_axis"] = rot.reshape(b, d, -1)
                        out["tran_axis"] = tran.reshape(b, d, -1)

        result: Dict[str, Any] = {
            "detections": Detections(
                boxes=out["boxes"], scores=out["scores"], classes=out["classes"],
                valid=out["valid"], masks=out.get("masks"),
                planes=out.get("planes"), rot_axis=out.get("rot_axis"),
                tran_axis=out.get("tran_axis")),
            "pool_valid": pool_valid,
            "features": feats,
            "proposals": proposals,
        }
        if mcfg.depth_on:
            with tracing.span("model.depth"), self._autocast(images.device):
                result["depth"] = self.depth_head(feats).to(torch.float32)
        if self._refines():
            # the reference's eval path with REFINE_ON: soft masks pasted
            # at threshold -1, gated by the box score threshold; the refine
            # head replaces the masks and the planes
            det = result["detections"]
            refined = self._refine(images, det, result["depth"])
            result["full_masks"] = torch.stack([
                refine_inference_masks(lg, vl, h, w)
                for lg, vl in zip(refined["logits"], refined["valid"])])
            result["detections"] = dataclasses.replace(det, planes=refined["plane_params"])
        return result

    @torch.no_grad()
    def inference_probe(self, images: torch.Tensor) -> Dict[str, Any]:
        """Inference with the per-stage intermediates exposed, for the
        goldens harness (`evaluation/goldens.py`; JAX
        `PlaneRCNN.inference_probe`, the reference's eval stages
        `modeling/meta_arch/planercnn.py:148-184`): FPN features p2-p6
        (NCHW), RPN proposals (boxes, objectness scores, valid), the final
        detections and the depth."""
        out = self.inference(images)
        proposals = out["proposals"]
        return {"features": out["features"],
                "proposal_boxes": proposals["boxes"],
                "proposal_logits": proposals["scores"],
                "proposal_valid": proposals["valid"],
                "detections": out["detections"],
                "depth": out.get("depth")}

    def _refine(self, images: torch.Tensor, dets: Detections,
                depth: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The refine pass shared by inference and training: soft masks
        pasted at image resolution (threshold -1), valid where the score
        exceeds `test.box_score_threshold`, and the raw 0..255 image
        recovered by inverting the (linear) preprocess.  Returns logits
        (B, D+1, hr, wr), plane_params (B, D, 3), soft_masks (B, D, H, W)
        and valid (B, D)."""
        cfg = self.config
        h, w = images.shape[1:3]
        valid = dets.valid & (dets.scores > cfg.test.box_score_threshold)
        soft = torch.stack([
            paste_masks(dets.masks[i].to(torch.float32), dets.boxes[i], valid[i], h, w,
                        threshold=-1.0, nms=cfg.model.mask_head.nms)
            for i in range(images.shape[0])])
        mean = torch.tensor(cfg.input.pixel_mean, dtype=images.dtype, device=images.device)
        std = torch.tensor(cfg.input.pixel_std, dtype=images.dtype, device=images.device)
        raw = images * std + mean
        outs = [self.refine_head(raw[i], soft[i], dets.planes[i].to(torch.float32),
                                 depth[i], valid[i]) for i in range(images.shape[0])]
        return {"logits": torch.stack([o[0] for o in outs]),
                "plane_params": torch.stack([o[1] for o in outs]),
                "soft_masks": soft, "valid": valid}

    def forward(self, images: torch.Tensor, *train_args, **train_kw) -> Any:
        """`inference(images)`; with the training arguments (gt_boxes,
        gt_classes, gt_valid, generators[, over_ranks]) `train_forward`, the
        call that DistributedDataParallel wraps (`train/train_step.py`)."""
        if train_args:
            return self.train_forward(images, *train_args, **train_kw)
        return self.inference(images)

    # ------------------------------------------------------------------ #
    def train_forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                      generators: Sequence[torch.Generator], over_ranks: bool = False):
        """Training forward: trunk -> RPN -> proposal sampling -> heads.

        images: preprocessed (B, H, W, 3); gt_* padded (B, G, ...);
        generators: one per image (`train.targets.per_image_keys`);
        over_ranks: the depth head's train-mode BatchNorm takes the global
        batch's statistics (`train/train_step.py`), else this rank's.
        Returns (outputs for `train.targets.detection_losses` and
        `rpn_losses`, SampledROIs).  Frozen heads are not run; with
        "backbone" frozen the features are detached, so no gradient reaches
        the poolers' features and the adjoint never runs (JAX 347-356).
        The train-mode proposals and the SampledROIs are kept as
        "train.rois" (`tracing.keep`).
        """
        from ..train.targets import sample_rois  # local: avoids an import cycle

        cfg = self.config
        mcfg = cfg.model
        h, w = cfg.input.height, cfg.input.width
        ac = lambda: self._autocast(images.device)
        with tracing.span("train.backbone"):
            feats = self.features(images)
        if "backbone" in mcfg.freeze:
            feats = {k: v.detach() for k, v in feats.items()}
        with tracing.span("train.rpn"), ac():
            proposals, rpn_raw = self.proposal_generator(
                feats, image_height=h, image_width=w, training=True)
        with tracing.span("train.sample_rois"):
            rois = sample_rois(proposals["boxes"], proposals["valid"], gt_boxes,
                               gt_classes, gt_valid, generators, cfg)
        tracing.keep("train.rois", proposals=proposals, rois=rois)
        roi_boxes = rois.boxes.detach()
        roi_feats = self.roi_features(feats, training=True)
        b, s = roi_boxes.shape[:2]
        pool = lambda hcfg, aligned: self._pool(
            roi_feats, roi_boxes, resolution=hcfg.pooler_resolution,
            sampling_ratio=hcfg.pooler_sampling_ratio, aligned=aligned,
            valid=rois.is_sampled, training=True)

        with tracing.span("train.box_pool"):
            pooled = pool(mcfg.box_head, True)
        with tracing.span("train.box_head"):
            with ac():
                x = self.roi_heads.box_head(pooled.reshape(b * s, *pooled.shape[2:]))
            scores, deltas = self.roi_heads.box_predictor(x)
        outputs: Dict[str, Any] = {
            "proposals": proposals, "rpn_raw": rpn_raw,
            "box_scores": scores.reshape(b, s, -1),
            "box_deltas": deltas.reshape(b, s, -1),
        }
        trains = lambda name: name not in mcfg.freeze
        if mcfg.mask_on and trains("roi_heads.mask_head"):
            mp = pool(mcfg.mask_head, False)
            with ac():
                logits = self.roi_heads.mask_head(mp.reshape(b * s, *mp.shape[2:]))
            outputs["mask_logits"] = logits.reshape(b, s, *logits.shape[1:])
        plane = mcfg.plane_on and trains("roi_heads.plane_head")
        axis = mcfg.axis_on and trains("roi_heads.axis_head")
        if plane or axis:
            pp = pool(mcfg.plane_head, False)
            flat = pp.reshape(b * s, *pp.shape[2:])
            with ac():
                if plane:
                    outputs["plane_pred"] = self.roi_heads.plane_head(flat).reshape(b, s, -1)
                if axis:
                    rot, tran = self.roi_heads.axis_head(flat)
                    outputs["rot_pred"] = rot.reshape(b, s, -1)
                    outputs["tran_pred"] = tran.reshape(b, s, -1)
        if mcfg.depth_on and trains("depth_head"):
            with ac():
                outputs["depth_pred"] = self.depth_head(
                    feats, train=True, over_ranks=over_ranks).to(torch.float32)
        if self._refines():
            outputs["refine"] = self._refine_cascade(images, feats, roi_feats, roi_boxes,
                                                     rois.is_sampled, outputs)
        return outputs, rois

    def _refine_cascade(self, images, feats, roi_feats, roi_boxes, is_sampled,
                        outputs) -> Dict[str, torch.Tensor]:
        """The reference's training with REFINE_ON: the detection cascade
        without gradient on the sampled proposals (fast R-CNN inference,
        then the mask and plane pools, through K1 alone, and heads), then
        the refine head, which takes gradients, as does the depth head
        through the plane-offset recompute when it trains (JAX
        planercnn.py:412-451)."""
        mcfg = self.config.model
        h, w = self.config.input.height, self.config.input.width
        b = roi_boxes.shape[0]
        with torch.no_grad():
            dd = fast_rcnn_inference(
                outputs["box_scores"].detach(), outputs["box_deltas"].detach(), roi_boxes,
                is_sampled, image_height=h, image_width=w, cfg=mcfg.roi_heads,
                bbox_reg_weights=mcfg.box_head.bbox_reg_weights)
            nd = dd["boxes"].shape[1]
            pool = lambda hcfg: self._pool(
                roi_feats, dd["boxes"], resolution=hcfg.pooler_resolution,
                sampling_ratio=hcfg.pooler_sampling_ratio, aligned=False,
                valid=dd["valid"], training=True)
            mp = pool(mcfg.mask_head)
            pp = pool(mcfg.plane_head)
            with self._autocast(images.device):
                mlog = self.roi_heads.mask_head(mp.reshape(b * nd, *mp.shape[2:]))
                planes = self.roi_heads.plane_head(pp.reshape(b * nd, *pp.shape[2:]))
            mprob = torch.sigmoid(mlog.to(torch.float32))[:, 0].reshape(b, nd, *mlog.shape[2:])
            depth = outputs.get("depth_pred")
            if depth is None:      # the depth head is frozen: predict without it training
                with self._autocast(images.device):
                    depth = self.depth_head(feats).to(torch.float32)
        dets = Detections(boxes=dd["boxes"], scores=dd["scores"], classes=dd["classes"],
                          valid=dd["valid"], masks=mprob,
                          planes=planes.to(torch.float32).reshape(b, nd, -1))
        return self._refine(images, dets, depth)


def build_model(config: Config, device=None,
                state_dict: Optional[Dict[str, Any]] = None) -> PlaneRCNN:
    """PlaneRCNN in eval mode on `device` (the card unless the caller names
    another), optionally loaded from a d2-schema state dict."""
    dev = resolve_device(device)
    model = PlaneRCNN(config)
    if state_dict is not None:
        from ..weights import load_d2_state_dict
        load_d2_state_dict(model, state_dict)
    return model.to(dev).eval()
