"""Plain PyTorch stage-1 training step of PlaneRCNN (the recipe's
`step1_bbox.yaml`): R50-FPN with frozen BatchNorm and the stem and res2
frozen (`freeze_at` 2), the RPN's objectness and anchor-regression losses,
the Fast R-CNN classification and box-regression losses, the gradient of
their sum with respect to every trained tensor (res3-res5, FPN, RPN head,
box head and predictor), and the SGD update (momentum, weight decay,
linear warm-up), written from detectron2's published semantics for judging
the port's step.

It imports nothing of the program: it takes the benchmark's state dict
(detectron2 key names, `portbench/weights.py`) and builds on the plain
inference reference `planercnn.py` (its layers, ROIAlign, anchors), in
float32 with TF32 off (`planercnn.exact_float32`).

Inputs of one step: the weights and momentum buffers before it, its
images and padded GT, and the program's own discrete choices (`choices`):
which anchors it sampled, with their labels and matched GT; which
proposals it kept; which ROIs it sampled, with their classes and matched
GT.  The losses use the program's normalisers: 256 anchors x images for
the RPN's two losses, the batch's sampled ROIs for the box stage's two.
`judge_train.py` first checks that each choice is a valid one.

Departures from the published description, each for judging:
  * the random choices are the program's (the reference would draw its
    own; two valid samples give different losses);
  * the box pool's gradient with respect to the features is autograd's
    through `planercnn.roi_align` (its einsum), so it owes nothing to the
    program's adjoint kernel;
  * the batch is computed in blocks of `block` images (each block's share
    of the losses backpropagated on its own, the gradients summed), so that
    it fits on the card beside the program;
  * `Prec` rounding (`STEPrec`) acts on the forward's operands alone: the
    control in float8 passes gradients straight through its roundings.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import planercnn as ref

LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")
TRAINED_PREFIXES = ("backbone.fpn_", "proposal_generator.", "roi_heads.box_head.",
                    "roi_heads.box_predictor.")
TRAINED_STAGES = ("res3", "res4", "res5")
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class STEPrec(ref.Prec):
    """`planercnn.Prec` whose roundings pass the gradient straight through
    (autograd has no derivative of a cast to float8)."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x + (super().q(x) - x).detach() if self.kind != "float32" else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y + (super().out(y) - y).detach() if self.kind != "float32" else y


F32 = STEPrec("float32")


def is_trained(key: str) -> bool:
    """Does stage 1 train this detectron2 key?  res3-res5 convolutions (the
    frozen BatchNorms have no parameters), the FPN, the RPN head and the box
    head and predictor."""
    if ".norm." in key or key.endswith("num_batches_tracked"):
        return False
    if key.startswith("backbone.bottom_up."):
        return key.split(".")[2] in TRAINED_STAGES
    return key.startswith(TRAINED_PREFIXES)


def trained_keys(keys: Iterable[str]) -> List[str]:
    return [k for k in keys if is_trained(k)]


def fed_by_pool(key: str) -> bool:
    """Is this tensor's gradient fed through the box pool's gradient with
    respect to the features (the FPN and the trunk under it)?"""
    return key.startswith("backbone.")


def encode(src: torch.Tensor, tgt: torch.Tensor, weights) -> torch.Tensor:
    """detectron2 `Box2BoxTransform.get_deltas`: (..., 4) XYXY src -> tgt."""
    sw, sh = src[..., 2] - src[..., 0], src[..., 3] - src[..., 1]
    sx, sy = src[..., 0] + 0.5 * sw, src[..., 1] + 0.5 * sh
    tw, th = tgt[..., 2] - tgt[..., 0], tgt[..., 3] - tgt[..., 1]
    tx, ty = tgt[..., 0] + 0.5 * tw, tgt[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    return torch.stack([wx * (tx - sx) / sw, wy * (ty - sy) / sh,
                        ww * torch.log(tw / sw), wh * torch.log(th / sh)], -1)


def lr_at(solver: dict, it: int) -> float:
    """detectron2 WarmupMultiStepLR (linear warm-up) at iteration `it`, the
    number of updates made before this one."""
    f = 1.0
    if it < solver["warmup_iters"]:
        alpha = it / solver["warmup_iters"]
        f = solver["warmup_factor"] * (1 - alpha) + alpha
    for milestone in solver["steps"]:
        if it >= milestone:
            f *= solver["gamma"]
    return solver["base_lr"] * f


def sgd(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
        bufs: Dict[str, Optional[torch.Tensor]], lr: float, momentum: float,
        weight_decay: float) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One SGD step (`torch.optim.SGD` semantics: weight decay added to the
    gradient, momentum without dampening, no Nesterov) on copies: returns
    the new parameters and momentum buffers."""
    new_p, new_b = {}, {}
    for k, p in params.items():
        g = grads[k].add(p, alpha=weight_decay)
        buf = bufs.get(k)
        if buf is None:
            buf = g.clone()
        else:
            buf = buf.clone().mul_(momentum).add_(g, alpha=1.0)
        new_p[k] = p.clone().add_(buf, alpha=-lr)
        new_b[k] = buf
    return new_p, new_b


def step(sd: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], choices: dict,
         cfg: dict, prec: ref.Prec = F32, block: int = 4, split: bool = False) -> dict:
    """The losses and gradients of one stage-1 step.

    sd: the weights before the step (float32, detectron2 keys); batch:
    images (B, H, W, 3) uint8, gt_boxes (B, G, 4), gt_classes (B, G),
    gt_valid (B, G); choices: {"anchors": {matched_idx, pos, neg} (B, A),
    "rois": {boxes (B, S, 4), classes, matched_idx, is_sampled, is_fg}
    (B, S)}; cfg: the configuration's `config` section.

    Returns {"losses": {name: float32 scalar}, "grads": {key: tensor},
    "scales": {loss: its rounding scale}}: the scale is the first-order
    change a relative rounding of 1 in each output's operands would make to
    the loss (sum of |dloss/doutput| x sum of |weight x input| over the
    output's terms); with `split`, also "pool_grads": the part of each
    gradient that the box stage's losses send (through the box pool)."""
    m, inp = cfg["model"], cfg["input"]
    keys = trained_keys(sd)
    params = {k: sd[k].detach().to(torch.float32).clone().requires_grad_(True) for k in keys}
    full = dict(sd)
    full.update(params)
    net = ref.Net(full, lowp=prec)
    images = batch["images"]
    b_all = images.shape[0]
    rpn_norm = float(m["rpn"]["batch_size_per_image"] * b_all)
    rois = choices["rois"]
    sampled_all = rois["is_sampled"].to(torch.bool)
    num_sampled = float(max(int(sampled_all.sum()), 1))
    nc = m["roi_heads"]["num_classes"]
    box = m["box_head"]
    losses = {k: torch.zeros((), dtype=torch.float32, device=images.device) for k in LOSSES}
    loss_scales = {k: 0.0 for k in LOSSES}
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    pool_grads = {k: torch.zeros_like(p) for k, p in params.items()} if split else None
    plist = [params[k] for k in keys]
    for lo in range(0, b_all, block):
        sl = slice(lo, min(lo + block, b_all))
        x = ref.preprocess(images[sl], inp["pixel_mean"], inp["pixel_std"],
                           inp["size_divisibility"])
        feats = net.backbone(x)
        rsc: list = []
        logits, deltas = net.rpn_head(feats, rsc)
        lg, dl = torch.cat(logits, 1), torch.cat(deltas, 1)
        anchors = torch.cat(ref.anchors_of(feats))
        a = choices["anchors"]
        pos, neg, midx = a["pos"][sl].to(torch.bool), a["neg"][sl].to(torch.bool), \
            a["matched_idx"][sl]
        gt = batch["gt_boxes"][sl].to(torch.float32)
        matched = torch.gather(gt, 1, midx[..., None].expand(-1, -1, 4))[pos]
        tgt = encode(anchors[None].expand(pos.shape[0], -1, -1)[pos], matched, (1.0,) * 4)
        picked = pos | neg
        rpn_cls = F.binary_cross_entropy_with_logits(
            lg[picked], pos[picked].to(torch.float32), reduction="sum") / rpn_norm
        rpn_loc = (dl[pos] - tgt).abs().sum() / rpn_norm      # smooth L1 at beta 0
        box_cls, box_reg = [], []
        for j in range(sl.stop - sl.start):
            i = lo + j
            sel = sampled_all[i]
            boxes = rois["boxes"][i][sel].to(torch.float32)
            fi = {k: v[j:j + 1] for k, v in feats.items()}
            pooled = ref.roi_align(fi, boxes, box["pooler_resolution"],
                                   box["pooler_sampling_ratio"], True)
            bsc: list = []
            cl_logits, bdeltas = net.box_logits(pooled, bsc)
            cls = rois["classes"][i][sel].to(torch.int64)
            fg = rois["is_fg"][i][sel].to(torch.bool)
            rows = torch.arange(cls.shape[0], device=cls.device)
            d = bdeltas.reshape(-1, nc, 4)[rows, cls.clamp(0, nc - 1)][fg]
            gt_i = batch["gt_boxes"][i].to(torch.float32)[rois["matched_idx"][i][sel]]
            t = encode(boxes[fg], gt_i[fg], BOX_WEIGHTS)
            box_cls.append(F.cross_entropy(cl_logits, cls, reduction="sum") / num_sampled)
            box_reg.append((d - t).abs().sum() / num_sampled)
            with torch.no_grad():
                cs, ds = bsc[0]
                p = torch.softmax(cl_logits, -1)
                y = F.one_hot(cls, nc + 1).to(p.dtype)
                loss_scales["loss_cls"] += float(((p - y).abs() * cs).sum()) / num_sampled
                dsel = ds.reshape(-1, nc, 4)[rows, cls.clamp(0, nc - 1)]
                loss_scales["loss_box_reg"] += float(dsel[fg].sum()) / num_sampled
        with torch.no_grad():
            ls = torch.cat([s[0] for s in rsc], 1)
            dsc = torch.cat([s[1] for s in rsc], 1)
            sig = torch.sigmoid(lg)
            loss_scales["loss_rpn_cls"] += float(
                ((sig - pos.to(sig.dtype)).abs() * ls)[picked].sum()) / rpn_norm
            loss_scales["loss_rpn_loc"] += float(dsc[pos].sum()) / rpn_norm
        box_total = sum(box_cls) + sum(box_reg)
        part = {"loss_rpn_cls": rpn_cls, "loss_rpn_loc": rpn_loc,
                "loss_cls": sum(box_cls), "loss_box_reg": sum(box_reg)}
        for k, v in part.items():
            losses[k] = losses[k] + v.detach()
        if split:
            gb = torch.autograd.grad(box_total, plist, allow_unused=True, retain_graph=True)
            for k, g in zip(keys, gb):
                if g is not None:
                    pool_grads[k] += g
        g_all = torch.autograd.grad(rpn_cls + rpn_loc + box_total, plist, allow_unused=True)
        for k, g in zip(keys, g_all):
            if g is not None:
                grads[k] += g
        del feats, logits, deltas, lg, dl, rsc, box_cls, box_reg, part, box_total
    out = {"losses": losses, "grads": grads, "scales": loss_scales}
    if split:
        out["pool_grads"] = pool_grads
    return out
