"""Plain PyTorch stage-3 training step of PlaneRCNN (the recipe's
`step3_plane.yaml`): over a detector frozen after stage 1 (R50-FPN, RPN,
box head and predictor, axis head), the mask head's BCE on 28x28 crops of
the GT masks, the plane head's L1 on unit normals and the depth decoder's
L1 on valid pixels with its BatchNorms on the batch's statistics; the
gradient of their sum with respect to every trained tensor (the mask,
plane and depth heads), the depth decoder's updated stored statistics, and
the SGD update (momentum, weight decay but not on BatchNorm affine
parameters, linear warm-up), written from detectron2's published
semantics for judging the port's step.

It imports nothing of the program: it takes the benchmark's state dict
(detectron2 key names, `portbench/weights.py`) and builds on the plain
inference reference `planercnn.py` (its trunk, heads, depth decoder and
ROIAlign) and on `train_s1.py` (its SGD, warm-up and straight-through
rounding), in float32 with TF32 off (`planercnn.exact_float32`).

Inputs of one step: the weights, momentum buffers and stored statistics
before it, its images and padded GT (boxes, valid flags, masks, planes,
depth), and the program's own choices (`choices`: the sampled ROIs with
their foreground flags and matched GT, and the program's plane and depth
predictions, whose differences from the GT give the two L1s' signs).  Only foreground ROIs take a loss,
so the reference runs the mask and plane heads on those alone, as
detectron2's `select_foreground_proposals` does; the losses are
normalised over the batch's foreground count, the depth loss over its
valid pixels (depth above 1e-4 m).

Departures from the published description, each for judging:
  * the ROI sample is the program's (the reference would draw its own; two
    valid samples give different losses); `judge_train_s3.py` checks that
    it is a valid one against the program's train-mode proposals;
  * the gradients of the plane and depth L1s take their signs from the
    program's predictions, sign(program's - GT), as its subgradient
    choices; the losses are the reference's own |prediction - GT|.  A term
    whose two sides lie within rounding of each other has either sign,
    and each flip moves a gradient by a whole term: the bfloat16 program's
    plane-head gradient lay 0.06-0.43 of its norm from the reference's
    with the reference's own signs, and 0.04-0.20 with the program's
    (H100 readings, `judge_train_s3.py`);
  * neither the RPN nor the box stage is computed: both are frozen and
    take no loss, and the choices they feed are the program's, so they
    change no number judged here (the stage-1 cell judges both);
  * the GT crops sample 2 x 2 points per bin of the 28 x 28 grid (aligned
    ROIAlign at scale 1 of the full-image mask, thresholded at 0.5), the
    repository's reading of `BitMasks.crop_and_resize`;
  * the trunk runs in blocks of `block` images without gradient (it is
    frozen), the depth decoder on the whole batch (its BatchNorms take the
    batch's statistics), the ROI heads in blocks of images (each block's
    share of the losses backpropagated on its own, the gradients summed),
    so that it fits on the card beside the program;
  * `Prec` rounding (`train_s1.STEPrec`) acts on the forward's operands
    alone: the control in float8 passes gradients straight through its
    roundings.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
import torch.nn.functional as F

from . import planercnn as ref
from . import train_s1

LOSSES = ("loss_mask", "loss_plane", "depth_loss")
HEADS = {"mask": "roi_heads.mask_head.", "plane": "roi_heads.plane_head.",
         "depth": "depth_head."}
BN_MOMENTUM = 0.01         # the stored statistics move this far towards the batch's
MASK_SIZE = 28
CROP_GRID = 2
DEPTH_VALID = 1e-4         # metres: below it a GT pixel is a hole


def head_of(key: str) -> str:
    """The trained head ("mask", "plane", "depth") a detectron2 key belongs
    to, or "" for a frozen one."""
    for name, prefix in HEADS.items():
        if key.startswith(prefix):
            return name
    return ""


def is_trained(key: str) -> bool:
    """Does stage 3 train this key?  Every parameter of the mask, plane and
    depth heads (the depth decoder's stored statistics are buffers)."""
    if key.endswith(("running_mean", "running_var", "num_batches_tracked")):
        return False
    return bool(head_of(key))


def trained_keys(keys: Iterable[str]) -> List[str]:
    return [k for k in keys if is_trained(k)]


def bn_prefixes() -> List[str]:
    """The depth decoder's BatchNorms: each lane's `conv{i}.1` and each
    merge's `deconv{i}.2`."""
    return ([f"depth_head.conv{i}.1" for i in range(1, 6)]
            + [f"depth_head.deconv{i}.2" for i in range(1, 6)])


def feeds_batch_norm(key: str) -> bool:
    """Is this the bias of a convolution whose output a train-mode
    BatchNorm normalises (each lane's `conv{i}.0`, each merge's
    `deconv{i}.1`)?  Its gradient is zero in exact arithmetic, since the
    BatchNorm removes any shift, so both sides give rounding noise there."""
    return key.endswith(".bias") and any(
        key == p.rsplit(".", 1)[0] + f".{int(p.rsplit('.', 1)[1]) - 1}.bias"
        for p in bn_prefixes())


def decays(key: str) -> bool:
    """Weight decay applies to every trained tensor but the BatchNorms'
    scale and shift (detectron2's WEIGHT_DECAY_NORM 0)."""
    return not any(key.startswith(p + ".") for p in bn_prefixes())


def unpack_masks(packed: torch.Tensor, width: int) -> torch.Tensor:
    """(..., W / 8) uint8, most significant bit first -> (..., W) float32."""
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width].to(torch.float32)


def crop_values(mask: torch.Tensor, boxes: torch.Tensor, size: int = MASK_SIZE,
                grid: int = CROP_GRID) -> torch.Tensor:
    """Crops of one (H, W) {0, 1} mask in (R, 4) XYXY boxes before the
    threshold: aligned ROIAlign at scale 1 (the box shifted by half a
    pixel, `grid` x `grid` bilinear samples per bin) -> (R, size, size)."""
    h, w = mask.shape
    x0, y0, x1, y1 = boxes.to(torch.float32).unbind(-1)
    wy = ref._axis_weights(y0 - 0.5, y1 - y0, size, grid, h)      # (R, size, H)
    wx = ref._axis_weights(x0 - 0.5, x1 - x0, size, grid, w)      # (R, size, W)
    return torch.bmm(torch.matmul(wy, mask), wx.transpose(1, 2))


def crop_masks(mask: torch.Tensor, boxes: torch.Tensor, size: int = MASK_SIZE,
               grid: int = CROP_GRID) -> torch.Tensor:
    """`crop_values` thresholded at 0.5: (R, size, size) float32 {0, 1}."""
    return (crop_values(mask, boxes, size, grid) >= 0.5).to(torch.float32)


def mask_targets(masks: torch.Tensor, midx: torch.Tensor, boxes: torch.Tensor,
                 raw: bool = False) -> torch.Tensor:
    """(R, 28, 28) crops of each ROI's matched GT mask (masks (G, H, W),
    midx (R,), boxes (R, 4)), one GT at a time; with `raw`, before the
    threshold."""
    crop = crop_values if raw else crop_masks
    out = torch.zeros(boxes.shape[0], MASK_SIZE, MASK_SIZE, device=boxes.device)
    for g in torch.unique(midx).tolist():
        sel = torch.nonzero(midx == g)[:, 0]
        out[sel] = crop(masks[g], boxes[sel])
    return out


def l1_signs(d: torch.Tensor, program_pred, gt: torch.Tensor) -> torch.Tensor:
    """The signs an L1's gradient takes: sign(program_pred - gt) where the
    program's prediction is given, else the reference's own sign(d)."""
    if program_pred is None:
        return d.detach().sign()
    return (program_pred.to(torch.float32) - gt).sign()


def step(sd: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], choices: dict,
         cfg: dict, prec: ref.Prec = train_s1.F32, block: int = 4) -> dict:
    """The losses, gradients and new stored statistics of one stage-3 step.

    sd: every weight and stored statistic before the step (float32,
    detectron2 keys); batch: images (B, H, W, 3) uint8, gt_masks_packed (B,
    G, H, W / 8), gt_planes (B, G, 3), gt_depth_mm (B, H, W); choices:
    {"rois": {boxes (B, S, 4), matched_idx, is_sampled, is_fg} (B, S)};
    cfg: the configuration's `config` section.  With choices["pred"] =
    {"plane": (B, S, 3), "depth": (B, H, W)}, the program's predictions,
    the L1s' gradients take their signs from them (module docstring);
    without it, from the reference's own.

    Returns {"losses": {name: float32 scalar}, "grads": {key: tensor},
    "stats": {running_mean / running_var key: the value after the step},
    "pred": {"plane": (B, S, 3), zero but on the foreground rows, "depth":
    (B, H, W)}: the reference's predictions}."""
    m, inp = cfg["model"], cfg["input"]
    keys = trained_keys(sd)
    params = {k: sd[k].detach().to(torch.float32).clone().requires_grad_(True) for k in keys}
    full = dict(sd)
    full.update(params)
    net = ref.Net(full, lowp=prec)
    images = batch["images"]
    b_all, h, w = images.shape[:3]
    dev = images.device
    with torch.no_grad():
        feats: Dict[str, list] = {}
        for lo in range(0, b_all, block):
            x = ref.preprocess(images[lo:lo + block], inp["pixel_mean"], inp["pixel_std"],
                               inp["size_divisibility"])
            for k, v in net.backbone(x).items():
                feats.setdefault(k, []).append(v)
        feats = {k: torch.cat(v) for k, v in feats.items()}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    prog = choices.get("pred", {})

    def backprop(loss, wanted):
        ks = [k for k in keys if head_of(k) in wanted]
        for k, g in zip(ks, torch.autograd.grad(loss, [params[k] for k in ks],
                                                allow_unused=True)):
            if g is not None:
                grads[k] += g

    # depth: the whole batch, its BatchNorms on the batch's statistics
    dcfg = m["depth_head"]
    batch_stats: Dict[str, torch.Tensor] = {}
    pred = net.depth(feats, (dcfg["output_height"], dcfg["output_width"]), calib=batch_stats)
    gt_depth = batch["gt_depth_mm"].to(torch.float32) / 1000.0
    valid = (gt_depth > DEPTH_VALID).to(torch.float32)
    scale = dcfg["loss_weight"] / valid.sum().clamp(min=1.0)
    d = pred - gt_depth
    sign = l1_signs(d, prog.get("depth"), gt_depth)
    backprop(scale * (sign * d * valid).sum(), ("depth",))
    depth_loss = scale * (d.detach().abs() * valid).sum()
    stats = {k: (1.0 - BN_MOMENTUM) * sd[k].to(torch.float32) + BN_MOMENTUM * v.detach()
             for k, v in batch_stats.items()}
    pred_out = {"depth": pred.detach()}
    del pred, d, batch_stats

    # the mask and plane heads on the foreground ROIs
    rois = choices["rois"]
    fg_all = rois["is_fg"].to(torch.bool) & rois["is_sampled"].to(torch.bool)
    num_fg = float(max(int(fg_all.sum()), 1))
    mh, ph = m["mask_head"], m["plane_head"]
    masks_all = unpack_masks(batch["gt_masks_packed"], w)
    loss_mask = torch.zeros((), device=dev)
    loss_plane = torch.zeros((), device=dev)
    pred_out["plane"] = torch.zeros(*fg_all.shape, 3, device=dev)
    for lo in range(0, b_all, block):
        part_mask, part_plane, plane_value = [], [], []
        for i in range(lo, min(lo + block, b_all)):
            fg = fg_all[i]
            if not bool(fg.any()):
                continue
            boxes = rois["boxes"][i][fg].to(torch.float32)
            midx = rois["matched_idx"][i][fg].to(torch.int64)
            fi = {k: v[i:i + 1] for k, v in feats.items()}
            mp = ref.roi_align(fi, boxes, mh["pooler_resolution"], mh["pooler_sampling_ratio"],
                               False)
            logits = net.mask_logits(mp)
            tgt = mask_targets(masks_all[i], midx, boxes)
            part_mask.append(F.binary_cross_entropy_with_logits(
                logits, tgt, reduction="none").mean(dim=(1, 2)).sum() / num_fg)
            pp = ref.roi_align(fi, boxes, ph["pooler_resolution"], ph["pooler_sampling_ratio"],
                               False)
            pred_n = ref.unit(net.plane_raw(pp))
            gt = batch["gt_planes"][i].to(torch.float32)[midx]
            gt_n = gt / gt.norm(dim=-1, keepdim=True).clamp(min=1e-12)
            d = pred_n - gt_n
            sign = l1_signs(d, prog["plane"][i][fg] if "plane" in prog else None, gt_n)
            part_plane.append(ph["loss_weight"] * (sign * d).sum() / num_fg)
            plane_value.append(ph["loss_weight"] * d.detach().abs().sum() / num_fg)
            pred_out["plane"][i][fg] = pred_n.detach()
        if part_mask:
            lm = sum(part_mask)
            backprop(lm + sum(part_plane), ("mask", "plane"))
            loss_mask = loss_mask + lm.detach()
            loss_plane = loss_plane + sum(plane_value)
    return {"losses": {"loss_mask": loss_mask, "loss_plane": loss_plane,
                       "depth_loss": depth_loss},
            "grads": grads, "stats": stats, "pred": pred_out}


def sgd(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
        bufs: Dict[str, torch.Tensor], lr: float, momentum: float, weight_decay: float):
    """`train_s1.sgd` with no weight decay on the BatchNorms' affine
    parameters: (new parameters, new momentum buffers)."""
    out_p, out_b = {}, {}
    for group, wd in (([k for k in params if decays(k)], weight_decay),
                      ([k for k in params if not decays(k)], 0.0)):
        p, b = train_s1.sgd({k: params[k] for k in group}, {k: grads[k] for k in group},
                            {k: bufs.get(k) for k in group}, lr, momentum, wd)
        out_p.update(p)
        out_b.update(b)
    return out_p, out_b
