"""The single-device training step: forward -> losses -> SGD update.

Counterpart of `articulation3d_tpu/train/train_step.py` (`unpack_bitmasks`,
`compute_losses`, the body of `make_train_step`).  Frozen modules neither
compute losses nor receive updates (`optimizer.freeze_mask`).  The JAX
package's k-step fused dispatch (`make_multi_step`, `make_repeat_step`)
pays down a TPU client's per-dispatch cost and is not ported; data
parallelism (`make_sharded_train_step`) is not ported yet.

Batch contract (fixed shapes, padded), tensors or numpy arrays:
  images     (B, H, W, 3)  raw BGR pixels, uint8 (normalised on the device)
  gt_boxes   (B, G, 4)     XYXY absolute pixels
  gt_classes (B, G) int
  gt_valid   (B, G) bool
  gt_masks   (B, G, H, W) binary float, or gt_masks_packed (B, G, H,
             ceil(W/8)) uint8 from np.packbits along W       [mask_on]
  gt_planes  (B, G, 3)                                       [plane_on]
  gt_rot_axis / gt_tran_axis (B, G, 4) (sin, cos, offset, valid) [axis_on]
  gt_depth   (B, H_d, W_d) float metres, or gt_depth_mm uint16 [depth_on]
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from .optimizer import clip_gradients
from .targets import detection_losses, per_image_keys, rpn_losses


def unpack_bitmasks(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of `np.packbits(masks, axis=-1)` on the device:
    (..., ceil(W/8)) uint8 -> (..., W) float32 in {0, 1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits[..., :width].to(torch.float32)


def to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (non-array entries are
    dropped)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if torch.is_tensor(v):
            out[k] = v.to(device, non_blocking=True)
    return out


def compute_losses(model, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """All enabled losses for one batch (tensors on the model's device).

    Each image samples from its own generator, split from `generator`
    (`targets.per_image_keys`): ROI sampling draws first, then the RPN
    anchor subsampling.  Images arrive as raw pixels and are normalised
    here, as the JAX train path does (JAX train_step.py:88-91)."""
    cfg: Config = model.config
    icfg = cfg.input
    dev = batch["images"].device
    mean = torch.tensor(icfg.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(icfg.pixel_std, dtype=torch.float32, device=dev)
    images = (batch["images"].to(torch.float32) - mean) / std
    gens = per_image_keys(generator, images.shape[0])
    gt_boxes = batch["gt_boxes"].to(torch.float32)
    gt_valid = batch["gt_valid"].to(torch.bool)
    outputs, rois = model.train_forward(images, gt_boxes, batch["gt_classes"],
                                        gt_valid, gens)
    losses: Dict[str, torch.Tensor] = {}
    if "proposal_generator" not in cfg.model.freeze:
        losses.update(rpn_losses(outputs["rpn_raw"], gt_boxes, gt_valid, gens, cfg))
    gt = {"boxes": gt_boxes, "classes": batch["gt_classes"], "valid": gt_valid}
    for src, dst in (("gt_masks", "masks"), ("gt_planes", "planes"),
                     ("gt_rot_axis", "rot_axis"), ("gt_tran_axis", "tran_axis"),
                     ("gt_depth", "depth")):
        if src in batch:
            gt[dst] = batch[src]
    if "gt_masks_packed" in batch:
        gt["masks"] = unpack_bitmasks(batch["gt_masks_packed"], images.shape[2])
    if "gt_depth_mm" in batch:
        gt["depth"] = batch["gt_depth_mm"].to(torch.float32) / 1000.0
    losses.update(detection_losses(outputs, rois, gt, cfg))
    return losses


def train_step(model, optimizer: torch.optim.Optimizer, scheduler,
               batch: Mapping[str, torch.Tensor],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One SGD step.  Returns the losses and `total_loss`, detached."""
    optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(model, batch, generator)
    total = sum(v.to(torch.float32) for v in losses.values())
    total.backward()
    clip_gradients(model.config, model)
    optimizer.step()
    scheduler.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    return metrics
