"""The comparison that decides `correct` for a stage-3 training step.

A judged step's answer is what the program's step produced: its discrete
choices (the train-mode proposals and the sampled ROIs with their
foreground flags and matched GT, and the plane and depth predictions
whose differences from the GT give its two L1s' signs), its three losses, every trained
tensor's gradient, the depth decoder's stored statistics after the step,
and the parameters and momentum buffers after its update.  The judge
first checks that the ROI sample is one a valid step can make, then
recomputes the step with the plain reference (`train_s3.py`, float32, TF32
off) on that sample, with the L1s' gradient signs the program's.

The numbers, each the worst over the judged steps, with their limits
(`limits/planercnn_r50fpn_train_s3.json`) and why, from the readings of
`control_train_s3.py` on an H100 (54 seeds of the program, 16 of the
float8 control, each planted fault at 2 to 6 seeds; for grad_plane and
grad_depth, with the program's signs, 34 seeds of the program, 11 of the
float8 control and each fault at 2; `PERF.md` §6):

  roi_labels   sampled ROIs that are not a valid proposal or GT box of the
               image, appear twice, or whose foreground flag, class or
               matched GT break the IoU-0.5 labelling, plus how far the
               foreground and background counts lie from detectron2's
               (`judge_train.roi_violations`).  Limit 0: a count of
               violations, 0 on every reading
  mask_targets  foreground ROIs' GT crop pixels (the 28x28 targets the
               program kept, "train.mask_targets") that differ from the
               reference's crop thresholded at 0.5, where the reference's
               value lies more than TIE from 0.5.  Limit 0: 0 on every
               sound reading, 245 or more with the crops half a pixel off
  loss_mask, loss_plane, depth_loss  |loss - the reference's on the same
               sample| / |the reference's|.  Limits 5e-3, 1e-2, 3e-3: at
               least three times the largest sound reading (1.0e-3, 3.0e-3,
               1.0e-4; with 50-140 foreground rows a step the heads' losses
               move with bfloat16 by as much as float8 moves them, so
               float8 does not separate these), and well under the faults
               they catch (the mask loss over the sampled rows 0.98, the
               planes unnormalised 1.5, the depth holes counted 0.095)
  grad_mask, grad_plane, grad_depth  ||gradient - reference|| /
               ||reference|| over the head's tensors taken together, but
               the biases that feed a train-mode BatchNorm, whose gradient
               is rounding noise on both sides (`train_s3.feeds_batch_norm`).
               grad_mask: limit 0.055, between the largest sound reading
               (0.025) and the smallest float8 one (0.12).  grad_plane:
               limit 0.28, between the largest sound reading (0.20) and
               the smallest float8 one (0.34), and under a plane head
               that gets no gradient (1.0) and the planes unnormalised
               (4.9).  With the reference's own signs, a term of the L1
               whose two sides lie within rounding flipped its gradient,
               and sound readings reached 0.43, float8 ones 0.26.
               grad_depth: limit 0.15, 2.5 times the largest sound reading
               (0.060; 0.089 with the reference's own signs: the depth
               loss's gradient is nearly the same at every pixel, which
               the train-mode BatchNorms remove, so what they pass back is
               a small difference of large terms).  It has no upper
               reading: float8 reads 0.014-0.48 (5 of 11 above the limit) and
               the depth holes counted 0.13-0.23 (they fail depth_loss)
  depth_stats  the largest ||stored statistic after - the reference's|| /
               ||the reference's - the one before|| over the depth
               decoder's running means and variances: the gap against the
               step's own move of the statistic (1 when it did not move).
               Limit 0.035, between the largest sound reading (0.015) and
               the smallest float8 one (0.080)
  update       the largest |parameter or momentum after - the reference's
               SGD on the program's own state before and gradients| in
               units of float32 spacing (ulp) of the reference's value.
               Limit 1, as the stage-1 cell's: 0 on every reading

Float8 fails grad_mask, grad_plane and depth_stats on every reading; a
planted fault fails the number named with it above, and the BatchNorms on
stored statistics read NaN in the depth loss and statistics.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import planercnn as ref
from . import train_s1, train_s3
from .judge import TINY
from .judge_train import _ulps, roi_violations

NUMBERS = ("roi_labels", "mask_targets", "loss_mask", "loss_plane", "depth_loss", "grad_mask",
           "grad_plane", "grad_depth", "depth_stats", "update")
TIE = 1e-4      # a crop value this near 0.5 may round to either side


def target_violations(masks_packed: torch.Tensor, rois: Dict[str, torch.Tensor],
                      targets: torch.Tensor) -> float:
    """Foreground crop pixels of the program's (B, S, 28, 28) `targets`
    that differ from the reference's away from a tie (`mask_targets`)."""
    masks = train_s3.unpack_masks(masks_packed, masks_packed.shape[-1] * 8)
    bad = 0
    for i in range(targets.shape[0]):
        fg = (rois["is_fg"][i] & rois["is_sampled"][i]).to(torch.bool)
        if not bool(fg.any()):
            continue
        v = train_s3.mask_targets(masks[i], rois["matched_idx"][i][fg].to(torch.int64),
                                  rois["boxes"][i][fg].to(torch.float32), raw=True)
        differ = (targets[i][fg] >= 0.5) != (v >= 0.5)
        bad += int((differ & ((v - 0.5).abs() > TIE)).sum())
    return float(bad)


def judge_step(sd: Dict[str, torch.Tensor], bufs: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor], answer: dict, cfg: dict, it: int,
               block: int = 4) -> Dict[str, float]:
    """The readings of one step.  sd: every weight and stored statistic
    before the step (detectron2 keys; the trained ones as the program held
    them); bufs: the momentum buffers before it (trained keys); batch:
    images uint8 (B, H, W, 3), gt_boxes, gt_classes, gt_valid,
    gt_masks_packed, gt_planes, gt_depth_mm; answer: {"choices":
    {"proposals", "rois"} of (B, ...) tensors and "pred" (the program's
    plane and depth predictions, `train_s3.step`), "mask_targets": (B, S, 28,
    28), "losses": {name: float}, "grads", "after", "bufs_after",
    "stats_after": {key: tensor}}; it: the
    updates made before this step (for the learning rate)."""
    m = cfg["model"]
    ch = answer["choices"]
    out: Dict[str, float] = {}
    bad = 0.0
    for i in range(batch["images"].shape[0]):
        bad += roi_violations({k: v[i] for k, v in ch["proposals"].items()},
                              batch["gt_boxes"][i].to(torch.float32), batch["gt_classes"][i],
                              batch["gt_valid"][i].to(torch.bool),
                              {k: v[i] for k, v in ch["rois"].items()}, m["roi_heads"])
    out["roi_labels"] = bad
    with ref.exact_float32():
        out["mask_targets"] = target_violations(batch["gt_masks_packed"], ch["rois"],
                                                answer["mask_targets"])
    with ref.exact_float32():
        r = train_s3.step(sd, batch, ch, cfg, block=block)
    for k in train_s3.LOSSES:
        want = float(r["losses"][k])
        out[k] = abs(answer["losses"][k] - want) / max(abs(want), TINY)
    def gap(keys):
        diff = sum(float((answer["grads"][k].to(torch.float32) - r["grads"][k]).square().sum())
                   for k in keys)
        ref_sq = sum(float(r["grads"][k].square().sum()) for k in keys)
        return (diff / max(ref_sq, TINY ** 2)) ** 0.5

    judged = [k for k in r["grads"] if not train_s3.feeds_batch_norm(k)]
    for h in train_s3.HEADS:
        out[f"grad_{h}"] = gap([k for k in judged if train_s3.head_of(k) == h])
    out["depth_stats"] = max(
        float((answer["stats_after"][k].to(torch.float32) - want).norm()
              / (want - sd[k].to(torch.float32)).norm().clamp(min=TINY))
        for k, want in r["stats"].items())
    s = cfg["solver"]
    params = {k: sd[k].to(torch.float32) for k in r["grads"]}
    new_p, new_b = train_s3.sgd(params, {k: answer["grads"][k] for k in params}, bufs,
                                train_s1.lr_at(s, it), s["momentum"], s["weight_decay"])
    out["update"] = max(max(_ulps(answer["after"][k], new_p[k]) for k in new_p),
                        max(_ulps(answer["bufs_after"][k], new_b[k]) for k in new_b))
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the judged steps."""
    if not readings:
        return {}
    return {k: max(r[k] for r in readings) for k in NUMBERS}
