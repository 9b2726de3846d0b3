"""Target assignment, proposal sampling and losses.

Counterpart of `articulation3d_tpu/train/targets.py` (detectron2's
two-stage training semantics):

  * RPN anchor matching (`Matcher([0.3, 0.7], [0, -1, 1],
    allow_low_quality_matches=True)`) and 256 anchors per image at a 0.5
    positive fraction;
  * ROI proposal labelling (IoU 0.5, no low-quality matches), GT appended to
    the proposals, 512 ROIs per image at a 0.25 positive fraction;
  * FastRCNN losses (softmax CE and smooth-L1 box regression over the
    sampled count), RPN losses (over 256 x images);
  * mask BCE on crops of the GT bitmasks (d2 `crop_and_resize`, as two
    separable products per ROI);
  * plane L1 over the foreground count, axis losses with per-GT valid bits
    and the translation's double-angle space, depth L1 on valid pixels;
  * the refine head's weighted cross-entropy, summed over the images.

Batches are fixed-capacity: GT arrives padded per image with a valid mask,
boxes (B, G, 4) XYXY pixels, classes (B, G), valid (B, G), masks
(B, G, H, W), planes (B, G, 3), rot_axis / tran_axis (B, G, 4) as
[sin, cos, offset, valid], depth (B, H_d, W_d).

Under a process group each rank holds a contiguous share of the batch.
Every normaliser that counts over the batch (sampled and foreground ROIs,
valid axis rows, valid depth pixels, the RPN's images) counts this rank's
rows, as JAX's sharded step does, or with `over_ranks` the global batch's
(`parallel.dist.global_count`), so that a rank's losses are its share of
the global batch's, as under JAX's `make_train_step` over a mesh
(`train_step.py` holds both steps).

Randomness: each image draws from its own `torch.Generator`
(`per_image_keys`), and every draw goes through `_uniform`; random
permutations are uniform priorities ranked by a stable argsort, as in the
JAX package.  The draws differ from `jax.random`'s, so the parity tests
replace `_uniform` with the JAX package's draws.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..config import Config
from ..models.depth_head import depth_l1_loss_masked
from ..models.heads import double_angle
from ..models.refine_head import refine_loss_single
from ..ops.box_ops import encode_deltas, pairwise_iou, smooth_l1_loss
from ..ops.roi_align import _sample_coords
from ..ops.roi_align_cuda import _separable_weights
from ..parallel.dist import global_count, process_count


def _uniform(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1): the only random draw of training."""
    return torch.rand(n, generator=generator, device=device)


def per_image_keys(generator: torch.Generator, b: int) -> List[torch.Generator]:
    """Split a generator into one generator per image, seeded from it, on
    the generator's device."""
    seeds = torch.randint(0, 2 ** 62, (b,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(int(s))
            for s in seeds]


# --------------------------------------------------------------------------- #
# matchers
# --------------------------------------------------------------------------- #

def match_anchors(iou: torch.Tensor, gt_valid: torch.Tensor,
                  low_thresh: float, high_thresh: float,
                  allow_low_quality: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher, batched over leading dimensions.

    iou (..., A, G) between anchors (proposals) and padded GT boxes;
    gt_valid (..., G).  Returns matched_idx (..., A) the best GT per anchor
    and labels (..., A): 1 positive, 0 negative, -1 ignored.
    """
    gv = gt_valid[..., None, :]
    iou = torch.where(gv, iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=-1)
    # argmax returns the first index among ties, as jnp.argmax does
    matched_idx = iou.argmax(dim=-1)
    labels = torch.where(matched_vals >= high_thresh, 1,
                         torch.where(matched_vals >= low_thresh, -1, 0))
    if allow_low_quality:
        # anchors sharing a GT's best IoU become positive (ties included)
        per_gt_max = iou.amax(dim=-2, keepdim=True)
        is_best = (iou == per_gt_max) & gv & (per_gt_max > 0)
        labels = torch.where(is_best.any(dim=-1), 1, labels)
    # no valid GT at all: everything negative
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, 0)
    return matched_idx, labels


def _select_ranked(is_set: torch.Tensor, count: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """Choose `count` (per row) entries of `is_set` uniformly without
    replacement: rank uniform priorities with the unset entries pushed
    last, keep the first `count`."""
    rank = u + (~is_set).to(u.dtype) * 2.0
    order = torch.argsort(rank, dim=-1, stable=True)
    n = is_set.shape[-1]
    keep = torch.arange(n, device=u.device) < count[..., None]
    return torch.zeros_like(is_set).scatter(-1, order, keep)


def subsample_labels(labels: torch.Tensor, num_samples: int,
                     positive_fraction: float,
                     generators: Sequence[torch.Generator]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """d2 `subsample_labels` per row of labels (B, n): random positives up
    to num * fraction, negatives to fill.  Each image draws its positive
    priorities, then its negative ones, from its own generator.  Returns
    boolean (pos, neg) masks with |pos| + |neg| <= num_samples per row."""
    b, n = labels.shape
    draws = [(_uniform(g, n, labels.device), _uniform(g, n, labels.device))
             for g in generators]
    u_pos = torch.stack([d[0] for d in draws])
    u_neg = torch.stack([d[1] for d in draws])
    is_pos = labels == 1
    is_neg = labels == 0
    num_pos = is_pos.sum(dim=-1).clamp(max=int(num_samples * positive_fraction))
    num_neg = torch.minimum(is_neg.sum(dim=-1), num_samples - num_pos)
    pos = _select_ranked(is_pos, num_pos, u_pos) & is_pos
    neg = _select_ranked(is_neg, num_neg, u_neg) & is_neg
    return pos, neg


# --------------------------------------------------------------------------- #
# RPN losses
# --------------------------------------------------------------------------- #

def _bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def rpn_losses(rpn_raw: Dict, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               generators: Sequence[torch.Generator], cfg: Config,
               over_ranks: bool = False) -> Dict[str, torch.Tensor]:
    """RPN objectness and anchor regression losses over the batch (with
    `over_ranks`, normalised over the global batch's images).

    rpn_raw: logits [(B, n_l)], deltas [(B, n_l, 4)], anchors [(n_l, 4)]
    per level (`RPN.forward(training=True)`).  The anchor sample is kept as
    "train.anchors" (`tracing.keep`): matched_idx, labels (1, 0, -1), pos
    and neg (B, A).
    """
    rcfg = cfg.model.rpn
    anchors = torch.cat(rpn_raw["anchors"], dim=0)                     # (A, 4)
    logits = torch.cat(rpn_raw["logits"], dim=1).to(torch.float32)    # (B, A)
    deltas = torch.cat(rpn_raw["deltas"], dim=1).to(torch.float32)    # (B, A, 4)
    b = logits.shape[0]
    with torch.no_grad(), tracing.span("train.rpn_targets"):
        iou = pairwise_iou(anchors[None], gt_boxes)                    # (B, A, G)
        matched_idx, labels = match_anchors(
            iou, gt_valid, rcfg.iou_thresholds[0], rcfg.iou_thresholds[1],
            allow_low_quality=True)
        pos, neg = subsample_labels(labels, rcfg.batch_size_per_image,
                                    rcfg.positive_fraction, generators)
        matched = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
        tgt = encode_deltas(anchors[None], matched, rcfg.bbox_reg_weights)
    tracing.keep("train.anchors", matched_idx=matched_idx, labels=labels, pos=pos, neg=neg)

    # every rank holds the same number of images
    images = b * process_count() if over_ranks else b
    normalizer = float(rcfg.batch_size_per_image * images)
    ce = _bce_with_logits(logits, pos.to(torch.float32))
    loss_cls = torch.where(pos | neg, ce, torch.zeros_like(ce)).sum() / normalizer
    reg = smooth_l1_loss(deltas, tgt, rcfg.smooth_l1_beta)
    loss_reg = torch.where(pos[..., None], reg, torch.zeros_like(reg)).sum() / normalizer
    return {"loss_rpn_cls": loss_cls * rcfg.loss_weight,
            "loss_rpn_loc": loss_reg * rcfg.loss_weight}


# --------------------------------------------------------------------------- #
# ROI sampling
# --------------------------------------------------------------------------- #

class SampledROIs(NamedTuple):
    boxes: torch.Tensor        # (B, S, 4)
    classes: torch.Tensor      # (B, S) int64; num_classes = background
    matched_idx: torch.Tensor  # (B, S) index into the GT rows
    is_sampled: torch.Tensor   # (B, S) bool: a real sampled proposal
    is_fg: torch.Tensor        # (B, S) bool


@torch.no_grad()
def sample_rois(proposal_boxes: torch.Tensor, proposal_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                gt_valid: torch.Tensor, generators: Sequence[torch.Generator],
                cfg: Config) -> SampledROIs:
    """d2 `label_and_sample_proposals` for the batch: GT appended to the
    proposals, labelled at the IoU threshold, sampled, and the sampled rows
    gathered to the front (stable order)."""
    hcfg = cfg.model.roi_heads
    s = hcfg.batch_size_per_image
    boxes = torch.cat([proposal_boxes, gt_boxes.to(proposal_boxes.dtype)], dim=1)
    valid = torch.cat([proposal_valid, gt_valid], dim=1)
    iou = pairwise_iou(boxes, gt_boxes)
    iou = torch.where(valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_idx, labels = match_anchors(iou, gt_valid, hcfg.iou_threshold,
                                        hcfg.iou_threshold, allow_low_quality=False)
    cls = torch.where(labels == 1, torch.gather(gt_classes.long(), 1, matched_idx),
                      hcfg.num_classes)
    # invalid rows are never picked
    labels = torch.where(valid, labels, -1)
    pos, neg = subsample_labels(labels, s, hcfg.positive_fraction, generators)
    sampled = pos | neg
    take = torch.argsort((~sampled).to(torch.int8), dim=1, stable=True)[:, :s]
    pick = lambda t: torch.gather(t, 1, take)
    return SampledROIs(
        boxes=torch.gather(boxes, 1, take[..., None].expand(-1, -1, 4)),
        classes=pick(cls), matched_idx=pick(matched_idx),
        is_sampled=pick(sampled), is_fg=pick(pos))


# --------------------------------------------------------------------------- #
# detection losses
# --------------------------------------------------------------------------- #

def crop_gt_masks(gt_masks: torch.Tensor, matched_idx: torch.Tensor,
                  boxes: torch.Tensor, mask_size: int,
                  chunk: int = 64) -> torch.Tensor:
    """d2 `BitMasks.crop_and_resize` for one image: aligned ROIAlign
    (scale 1, sampling ratio 2) of each matched GT bitmask (G, H, W) in its
    box (S, 4), thresholded at 0.5 -> (S, M, M) float32.

    ROIAlign of a full-image single-channel map is separable, so each crop
    is crop[s] = Ry[s] (M, H) @ mask (H, W) @ Rx[s]^T (W, M), with Ry/Rx
    from the kernels' `_separable_weights` (JAX targets.py:215-269)."""
    _, h, w = gt_masks.shape
    s = boxes.shape[0]
    dev = boxes.device
    ys, xs, y_mask, x_mask = _sample_coords(boxes.to(torch.float32), 1.0,
                                            mask_size, 2, True)
    n2 = torch.full((s,), 2, dtype=torch.int64, device=dev)
    zero = torch.zeros((s,), dtype=torch.int64, device=dev)
    ry = _separable_weights(ys, y_mask, n2, torch.full_like(n2, h), zero, h)
    rx = _separable_weights(xs, x_mask, n2, torch.full_like(n2, w), zero, w)
    masks = gt_masks.to(torch.float32)
    crops = []
    for lo in range(0, s, max(1, chunk)):
        m = masks[matched_idx[lo:lo + chunk]]                    # (K, H, W)
        t = torch.bmm(ry[lo:lo + chunk], m)                       # (K, M, W)
        crops.append(torch.bmm(t, rx[lo:lo + chunk].transpose(1, 2)))
    return (torch.cat(crops) >= 0.5).to(torch.float32)


def detection_losses(outputs: Dict, rois: SampledROIs, gt: Dict, cfg: Config,
                     over_ranks: bool = False) -> Dict[str, torch.Tensor]:
    """All ROI-head and depth losses from `PlaneRCNN.train_forward`'s
    outputs; `gt` holds the padded per-image arrays (module docstring).
    The normalisers count this rank's rows, or with `over_ranks` the
    global batch's."""
    mcfg = cfg.model
    losses: Dict[str, torch.Tensor] = {}
    b, s = rois.boxes.shape[:2]
    flat = lambda x: x.reshape((b * s,) + tuple(x.shape[2:]))
    sampled = flat(rois.is_sampled)
    fg = flat(rois.is_fg)
    cls = flat(rois.classes)
    midx = rois.matched_idx

    def gather_gt(field):
        g = gt[field]
        idx = midx.reshape(b, s, *([1] * (g.dim() - 2))).expand(b, s, *g.shape[2:])
        return torch.gather(g, 1, idx)

    def masked_sum(x, mask):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, torch.zeros_like(x)).sum()

    count = global_count if over_ranks else (lambda x: x)
    num_sampled = count(sampled.sum()).clamp(min=1).to(torch.float32)
    num_fg = count(fg.sum()).clamp(min=1).to(torch.float32)
    nc = mcfg.roi_heads.num_classes
    safe_cls = cls.clamp(0, nc - 1)
    rows = torch.arange(b * s, device=cls.device)

    if ("roi_heads.box_head" not in mcfg.freeze
            and "roi_heads.box_predictor" not in mcfg.freeze):
        scores = flat(outputs["box_scores"]).to(torch.float32)
        ce = -F.log_softmax(scores, dim=-1)[rows, cls]
        losses["loss_cls"] = masked_sum(ce, sampled) / num_sampled
        deltas = flat(outputs["box_deltas"]).to(torch.float32).reshape(b * s, -1, 4)
        tgt = encode_deltas(rois.boxes, gather_gt("boxes").to(torch.float32),
                            mcfg.box_head.bbox_reg_weights)
        sel = deltas[:, 0] if deltas.shape[1] == 1 else deltas[rows, safe_cls]
        reg = smooth_l1_loss(sel, flat(tgt), mcfg.box_head.smooth_l1_beta)
        losses["loss_box_reg"] = masked_sum(reg, fg) / num_sampled

    if "mask_logits" in outputs:
        mlogits = flat(outputs["mask_logits"]).to(torch.float32)   # (BS, 1|C, M, M)
        msize = mlogits.shape[-1]
        with torch.no_grad():
            mtgt = torch.stack([crop_gt_masks(gt["masks"][i], midx[i], rois.boxes[i], msize)
                                for i in range(b)])
        ml = mlogits[:, 0] if mlogits.shape[1] == 1 else mlogits[rows, safe_cls]
        per_roi = _bce_with_logits(ml, flat(mtgt)).mean(dim=(1, 2))
        losses["loss_mask"] = masked_sum(per_roi, fg) / num_fg

    if "plane_pred" in outputs:
        pp = flat(outputs["plane_pred"]).to(torch.float32)
        gt_planes = flat(gather_gt("planes")).to(torch.float32)
        if mcfg.plane_head.normal_only:
            gt_planes = gt_planes / gt_planes.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        l1 = smooth_l1_loss(pp, gt_planes, 0.0)
        losses["loss_plane"] = mcfg.plane_head.loss_weight * masked_sum(l1, fg) / num_fg

    if "rot_pred" in outputs:
        acfg = mcfg.axis_head
        rot_gt = flat(gather_gt("rot_axis")).to(torch.float32)
        tran_gt = flat(gather_gt("tran_axis")).to(torch.float32)
        rot_pred = flat(outputs["rot_pred"]).to(torch.float32)
        tran_pred = flat(outputs["tran_pred"]).to(torch.float32)
        rvalid = fg & (rot_gt[:, 3] >= 0.5)
        rl = smooth_l1_loss(rot_pred, rot_gt[:, :3], acfg.smooth_l1_beta)
        n_r = (count(rvalid.sum()) * 3).clamp(min=1).to(torch.float32)
        losses["loss_rot_axis"] = acfg.loss_weight * masked_sum(rl, rvalid) / n_r
        tvalid = fg & (tran_gt[:, 3] >= 0.5)
        tl = smooth_l1_loss(double_angle(tran_pred), double_angle(tran_gt[:, :2]),
                            acfg.smooth_l1_beta)
        n_t = (count(tvalid.sum()) * 2).clamp(min=1).to(torch.float32)
        losses["loss_tran_axis"] = acfg.loss_weight * masked_sum(tl, tvalid) / n_t

    if "refine" in outputs:
        r = outputs["refine"]
        # the reference sums the per-image losses (JAX targets.py:371-381)
        losses["refine_loss"] = mcfg.refine_head.loss_weight * sum(
            refine_loss_single(r["logits"][i], gt["masks"][i].to(torch.float32),
                               gt["valid"][i], r["soft_masks"][i], r["valid"][i])
            for i in range(b))

    if "depth_pred" in outputs:
        losses["depth_loss"] = mcfg.depth_head.loss_weight * depth_l1_loss_masked(
            outputs["depth_pred"].to(torch.float32), gt["depth"].to(torch.float32),
            over_ranks)
    return losses
