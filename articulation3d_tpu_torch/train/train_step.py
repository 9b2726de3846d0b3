"""The training steps: forward -> losses -> SGD update.

Counterpart of `articulation3d_tpu/train/train_step.py` (`unpack_bitmasks`,
`compute_losses`, the bodies of `make_train_step` and
`make_sharded_train_step`).  Frozen modules neither
compute losses nor receive updates (`optimizer.freeze_mask`).  The JAX
package's k-step fused dispatch (`make_multi_step`, `make_repeat_step`)
pays down a TPU client's per-dispatch cost and is not ported.

Data parallelism: under a process group of W ranks the model is wrapped in
DistributedDataParallel, each rank holds a contiguous 1/W of the global
batch and draws the global batch's per-image generators, keeping the ones
of its own images.  There are two steps, one for each of JAX's
`make_sharded_train_step` and `make_train_step`:

  * `sharded_train_step`, the `Trainer`'s at W > 1, is the counterpart of
    JAX's `make_sharded_train_step` (train_step.py:218-330), which JAX's
    `Trainer` runs on a mesh of more than one device: the losses, every
    normaliser that counts over the batch and the depth head's train-mode
    BatchNorm statistics are this rank's rows' (DDP's semantics, not the
    global batch's); DDP's mean gives the trainable gradients (the frozen
    set takes no gradient, as JAX's `tmask` keeps it out of the psum), in
    float32 or, with `solver.grad_sync_dtype: bfloat16`, through
    `parallel.dist.bf16_grad_sync_hook`; then one float32 all-reduce
    averages the depth head's new running statistics and the metrics;
    the clip and the SGD update follow, as in JAX;
  * `train_step` is the counterpart of JAX's `make_train_step` jitted over
    a mesh, the global-batch program: every normaliser is summed over the
    ranks (`targets.py`, `over_ranks=True`) so a rank's loss is its share
    of the global loss, the BatchNorm takes the global batch's statistics
    (`models/depth_head.py`), the loss is scaled by W before backward so
    that DDP's mean is the global batch's gradient, and the returned
    losses are summed over the ranks.  A W-rank step computes what one
    process computes on the whole batch.

A world of one takes the one-process path: no wrapper, no collective, and
both steps compute the same update.

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

from .. import tracing
from ..config import Config
from ..models.depth_head import BatchNorm2d
from ..parallel.dist import mean_over_ranks, process_count, process_index
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


def compute_losses(model, batch: Mapping[str, torch.Tensor], generator: torch.Generator,
                   over_ranks: bool = False) -> Dict[str, torch.Tensor]:
    """All enabled losses for this rank's rows of the batch (tensors on the
    model's device); `model` is a `PlaneRCNN` or its DDP wrapper.  The
    normalisers and the depth head's BatchNorm statistics are this rank's
    rows', or with `over_ranks` the global batch's.

    Each image samples from its own generator, split from `generator`
    (`targets.per_image_keys`) over the global batch: ROI sampling draws
    first, then the RPN anchor subsampling.  `generator` may also be this
    rank's list of per-image generators, as JAX's `compute_losses` takes a
    key or per-image keys.  Images arrive as raw pixels and are normalised
    here, as the JAX train path does (JAX train_step.py:88-91)."""
    cfg: Config = unwrap(model).config
    icfg = cfg.input
    dev = batch["images"].device
    with tracing.sync("train_pixel_stats", dev):
        mean = torch.tensor(icfg.pixel_mean, dtype=torch.float32, device=dev)
    with tracing.sync("train_pixel_stats", dev):
        std = torch.tensor(icfg.pixel_std, dtype=torch.float32, device=dev)
    images = (batch["images"].to(torch.float32) - mean) / std
    b, rank = images.shape[0], process_index()
    if isinstance(generator, torch.Generator):
        with tracing.sync("train_keys", dev):       # the seeds come back to the host
            gens = per_image_keys(generator, b * process_count())[rank * b:(rank + 1) * b]
    else:
        gens = list(generator)
        assert len(gens) == b, (len(gens), b)
    gt_boxes = batch["gt_boxes"].to(torch.float32)
    gt_valid = batch["gt_valid"].to(torch.bool)
    # through __call__, the forward DistributedDataParallel hooks
    outputs, rois = model(images, gt_boxes, batch["gt_classes"], gt_valid, gens,
                          over_ranks=over_ranks)
    losses: Dict[str, torch.Tensor] = {}
    if "proposal_generator" not in cfg.model.freeze:
        with tracing.span("train.losses"):      # the anchor matching is "train.rpn_targets"
            losses.update(rpn_losses(outputs["rpn_raw"], gt_boxes, gt_valid, gens, cfg,
                                     over_ranks=over_ranks))
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
    with tracing.span("train.losses"):
        losses.update(detection_losses(outputs, rois, gt, cfg, over_ranks=over_ranks))
    return losses


def _backward(loss: torch.Tensor) -> None:
    with tracing.span("train.backward"):
        loss.backward()


def _update(net, optimizer: torch.optim.Optimizer, scheduler) -> None:
    """The clip (`solver.clip_gradients`), the SGD update and the schedule,
    after the gradients are synced."""
    with tracing.span("train.clip"):
        clip_gradients(net.config, net)
    with tracing.span("train.optimizer"):
        optimizer.step()
        scheduler.step()


def train_step(model, optimizer: torch.optim.Optimizer, scheduler,
               batch: Mapping[str, torch.Tensor],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One SGD step of the global-batch program (JAX's `make_train_step`
    over a mesh; module docstring) on this rank's rows of the global
    batch.  Returns the global batch's losses and `total_loss`, detached."""
    net = unwrap(model)
    world = process_count()
    optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(model, batch, generator, over_ranks=True)
    total = sum(v.to(torch.float32) for v in losses.values())
    _backward(total * world if world > 1 else total)
    _update(net, optimizer, scheduler)
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    if world > 1:
        stacked = torch.stack([v.to(torch.float32) for v in metrics.values()])
        torch.distributed.all_reduce(stacked)
        metrics = dict(zip(metrics, stacked.unbind()))
    return metrics


def running_statistics(net: torch.nn.Module):
    """The stored statistics of the train-mode BatchNorms (the depth
    head's), which JAX keeps in `batch_stats`."""
    return [buf for m in net.modules() if isinstance(m, BatchNorm2d)
            for buf in (m.running_mean, m.running_var)]


def sharded_train_step(model, optimizer: torch.optim.Optimizer, scheduler,
                       batch: Mapping[str, torch.Tensor],
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One SGD step of the `Trainer` at W > 1, JAX's
    `make_sharded_train_step` (module docstring): this rank's losses on its
    rows, DDP's mean of the trainable gradients, then the ranks' mean of
    the new running statistics and of the metrics in one float32
    all-reduce, then the clip and the update.  Returns the ranks' mean of
    the losses and of `total_loss`, detached."""
    net = unwrap(model)
    optimizer.zero_grad(set_to_none=True)
    losses = compute_losses(model, batch, generator)
    total = sum(v.to(torch.float32) for v in losses.values())
    _backward(total)
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    stats = running_statistics(net)
    names = list(metrics)
    synced = mean_over_ranks(stats + [torch.stack([metrics[k].to(torch.float32)
                                                   for k in names])])
    with torch.no_grad():
        for buf, new in zip(stats, synced):
            buf.copy_(new)
    _update(net, optimizer, scheduler)
    return dict(zip(names, synced[-1].unbind()))
