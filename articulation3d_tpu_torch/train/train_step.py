"""The single-device training step: forward -> losses -> SGD update.

Counterpart of `articulation3d_tpu/train/train_step.py` (`unpack_bitmasks`,
`compute_losses`, the body of `make_train_step`).  Frozen modules neither
compute losses nor receive updates (`optimizer.freeze_mask`).  The JAX
package's k-step fused dispatch (`make_multi_step`, `make_repeat_step`)
pays down a TPU client's per-dispatch cost and is not ported.

Data parallelism (JAX `make_sharded_train_step`): under a process group of
W ranks the model is wrapped in DistributedDataParallel and each rank holds
a contiguous 1/W of the global batch.  A W-rank step computes what the
one-process step computes on the global batch, as JAX's mesh step does:

  * each rank draws the global batch's per-image generators and keeps the
    ones of its own images;
  * every loss normaliser that counts over the batch (sampled and
    foreground ROIs, valid axis rows, valid depth pixels, the RPN's images)
    is summed over the ranks (`targets.py`), so a rank's loss is its share
    of the global loss, and the depth head's train-mode BatchNorm
    normalises with the global batch's statistics (`models/depth_head.py`);
  * each rank's loss is scaled by W before backward, so that DDP's mean of
    the gradients is the global batch's gradient; the clip runs after
    DDP's all-reduce, as in one process;
  * the returned losses are summed over the ranks: the global batch's.

A world of one takes the one-process path: no wrapper, no collective.

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
from torch.nn.parallel import DistributedDataParallel

from ..config import Config
from ..parallel.dist import process_count, process_index
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


def unwrap(model) -> torch.nn.Module:
    """The model inside a DistributedDataParallel wrapper (or the model)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def compute_losses(model, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """All enabled losses for this rank's rows of the batch (tensors on the
    model's device); `model` is a `PlaneRCNN` or its DDP wrapper.

    Each image samples from its own generator, split from `generator`
    (`targets.per_image_keys`) over the global batch: ROI sampling draws
    first, then the RPN anchor subsampling.  Images arrive as raw pixels
    and are normalised here, as the JAX train path does (JAX
    train_step.py:88-91)."""
    cfg: Config = unwrap(model).config
    icfg = cfg.input
    dev = batch["images"].device
    mean = torch.tensor(icfg.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(icfg.pixel_std, dtype=torch.float32, device=dev)
    images = (batch["images"].to(torch.float32) - mean) / std
    b, rank = images.shape[0], process_index()
    gens = per_image_keys(generator, b * process_count())[rank * b:(rank + 1) * b]
    gt_boxes = batch["gt_boxes"].to(torch.float32)
    gt_valid = batch["gt_valid"].to(torch.bool)
    # through __call__, the forward DistributedDataParallel hooks
    outputs, rois = model(images, gt_boxes, batch["gt_classes"], gt_valid, gens)
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
    """One SGD step on this rank's rows of the global batch (module
    docstring).  Returns the global batch's losses and `total_loss`,
    detached."""
    net = unwrap(model)
    world = process_count()
    optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(model, batch, generator)
    total = sum(v.to(torch.float32) for v in losses.values())
    (total * world if world > 1 else total).backward()
    clip_gradients(net.config, net)
    optimizer.step()
    scheduler.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    if world > 1:
        stacked = torch.stack([v.to(torch.float32) for v in metrics.values()])
        torch.distributed.all_reduce(stacked)
        metrics = dict(zip(metrics, stacked.unbind()))
    return metrics
