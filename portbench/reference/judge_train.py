"""The comparison that decides `correct` for a stage-1 training step.

A judged step's answer is what the program's step produced: its discrete
choices (the train-mode proposals, the sampled anchors with their labels
and matched GT, the sampled ROIs with their classes and matched GT), its
four losses, every trained tensor's gradient, and the parameters and
momentum buffers after its update.  The judge first checks that each
choice is one a valid step can make, then recomputes the step with the
plain reference (`train_s1.py`, float32, TF32 off) on those choices.

The numbers, each the worst over the judged steps:

  anchor_labels  anchors whose sampled label breaks the RPN matcher (IoU
                 0.3 / 0.7, every GT's best anchors positive) or whose
                 matched GT is not a best one, plus how far the positive
                 and negative counts lie from min(available, 128) and
                 min(available, 256 - positives) (exact: limit 0); IoUs
                 within IOU_SLACK of a threshold or of a best may go
                 either way
  roi_labels     sampled ROIs that are not a valid proposal or GT box of
                 the image, appear twice, or whose foreground flag, class
                 or matched GT break the IoU-0.5 labelling, plus how far
                 the foreground and background counts lie from min(
                 available, 128) and min(available, 512 - foreground)
                 (exact)
  rpn_box        each kept proposal's coordinates against the reference's
                 decoded box of the nearest anchor, over its rounding scale
                 (`judge.box_scale`)
  rpn_nms_overlap, rpn_nms_miss  the RPN's NMS at the train-mode top-k,
                 as `judge.py` reads them for inference (its functions), each
                 kept proposal's level that of its anchor (`assign_anchors`)
  loss_*         |loss - the reference's on the same choices| over the
                 loss's rounding scale (`train_s1.step`): about the
                 operands' relative rounding, 1e-3 for bfloat16
  grad_heads     the largest ||gradient - reference|| / ||reference|| over
                 the RPN head's and the box head's tensors
  grad_trunk     the same over the FPN and res3-res5, the tensors that the
                 box pool's adjoint (K2) feeds
  grad_pool_path |<gradient - reference, p>| / ||p||^2 over the FPN and
                 res3-res5 together, p the part of the reference's
                 gradient that the box losses send through the pool: 1 when
                 the pool sends nothing back, whatever share of the whole
                 gradient p is
  update         the largest |parameter or momentum after - the reference's
                 SGD on the program's own state before and gradients| in
                 units of float32 spacing (ulp) of the reference's value
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import planercnn as ref
from . import train_s1
from .judge import TINY, _nearest, box_scale, iou, nms_miss, nms_overlap

NUMBERS = ("anchor_labels", "roi_labels", "rpn_box", "rpn_nms_overlap", "rpn_nms_miss",
           "loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg",
           "grad_heads", "grad_trunk", "grad_pool_path", "update")
IOU_SLACK = 1e-5        # the program computes IoU in float32


def _count_gap(n: int, lo: int, hi: int) -> float:
    """How far a count lies outside [lo, hi]."""
    return float(max(lo - n, n - hi, 0))


def anchor_violations(anchors: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor,
                      choice: Dict[str, torch.Tensor], rpn: dict) -> float:
    """One image's anchor sample (pos, neg, matched_idx over (A,) anchors)
    against detectron2's Matcher([0.3, 0.7], allow_low_quality_matches)
    and `subsample_labels`."""
    lo_t, hi_t = rpn["iou_thresholds"]
    pos, neg = choice["pos"].to(torch.bool), choice["neg"].to(torch.bool)
    midx = choice["matched_idx"].to(torch.int64)
    m = iou(anchors, gt)
    m = torch.where(gt_valid[None], m, torch.full_like(m, -1.0))
    best = m.amax(dim=1)
    per_gt = m.amax(dim=0)
    e = IOU_SLACK
    near = (m >= per_gt[None] - e) & gt_valid[None] & (per_gt[None] > e)
    near_best = near.any(1)
    # a GT's best anchor is surely positive where no other comes within the slack
    sure_pos = (best >= hi_t + e) | (near & (near.sum(0) == 1)[None]).any(1)
    may_pos = (best >= hi_t - e) | near_best
    may_neg = (best < lo_t + e) & ~sure_pos
    must_neg = (best < lo_t - e) & ~may_pos
    bad = int((pos & ~may_pos).sum()) + int((neg & ~may_neg).sum()) + int((pos & neg).sum())
    if bool(pos.any()):
        got = m[pos].gather(1, midx[pos][:, None])[:, 0]
        bad += int((got < best[pos] - e).sum())
    num = rpn["batch_size_per_image"]
    cap = int(num * rpn["positive_fraction"])
    n_pos, n_neg = int(pos.sum()), int(neg.sum())
    bad += _count_gap(n_pos, min(int(sure_pos.sum()), cap), min(int(may_pos.sum()), cap))
    bad += _count_gap(n_neg, min(int(must_neg.sum()), num - n_pos),
                      min(int(may_neg.sum()), num - n_pos))
    return float(bad)


def roi_violations(props: Dict[str, torch.Tensor], gt: torch.Tensor, gt_cls: torch.Tensor,
                   gt_valid: torch.Tensor, rois: Dict[str, torch.Tensor], heads: dict) -> float:
    """One image's sampled ROIs against detectron2's
    `label_and_sample_proposals`: GT appended to the proposals, IoU 0.5,
    `batch_size_per_image` at `positive_fraction`."""
    cand = torch.cat([props["boxes"][props["valid"]], gt[gt_valid]]).to(torch.float32)
    m = iou(cand, gt)
    m = torch.where(gt_valid[None], m, torch.full_like(m, -1.0))
    best = m.amax(dim=1) if gt_valid.any() else torch.full((cand.shape[0],), -1.0,
                                                           dtype=m.dtype, device=m.device)
    t, e = heads["iou_threshold"], IOU_SLACK
    may_fg, must_fg = best >= t - e, best >= t + e
    sel = rois["is_sampled"].to(torch.bool)
    boxes = rois["boxes"][sel].to(torch.float32)
    fg = rois["is_fg"].to(torch.bool)
    bad = int((fg & ~sel).sum())
    fg = fg[sel]
    cls = rois["classes"][sel].to(torch.int64)
    midx = rois["matched_idx"][sel].to(torch.int64)
    if boxes.shape[0]:
        d = torch.cat([(boxes[s:s + 256, None] - cand[None]).abs().amax(-1)
                       for s in range(0, boxes.shape[0], 256)])
        dist, k = d.min(dim=1)
        bad += int((dist > 0).sum())
        # each candidate at most as often as it occurs among the candidates
        occurs = ((cand[:, None] - cand[None]).abs().amax(-1) == 0).sum(1)
        used = torch.bincount(k[dist == 0], minlength=cand.shape[0])
        bad += int((used > occurs).sum())
        bad += int((fg & ~may_fg[k]).sum()) + int((~fg & must_fg[k]).sum())
        nc = heads["num_classes"]
        want = torch.where(fg, gt_cls.to(torch.int64)[midx.clamp(0, gt.shape[0] - 1)],
                           torch.full_like(cls, nc))
        bad += int((cls != want).sum())
        got = m[k].gather(1, midx.clamp(0, gt.shape[0] - 1)[:, None])[:, 0]
        bad += int((fg & (got < best[k] - e)).sum())
    num = heads["batch_size_per_image"]
    cap = int(num * heads["positive_fraction"])
    n_fg, n_bg = int(fg.sum()), int((~fg).sum())
    bad += _count_gap(n_fg, min(int(must_fg.sum()), cap), min(int(may_fg.sum()), cap))
    bad += _count_gap(n_bg, min(int((~may_fg).sum()), num - n_fg),
                      min(int((~must_fg).sum()), num - n_fg))
    return float(bad)


@torch.no_grad()
def proposal_readings(net: ref.Net, image: torch.Tensor, props: Dict[str, torch.Tensor],
                      cfg: dict) -> Tuple[Dict[str, float], torch.Tensor]:
    """rpn_box, rpn_nms_overlap and rpn_nms_miss of one image's train-mode
    proposals (boxes (K, 4), scores (K,) logits, valid (K,)), and the (A, 4)
    anchors of every level."""
    m, inp = cfg["model"], cfg["input"]
    h, w = image.shape[:2]
    x = ref.preprocess(image[None], inp["pixel_mean"], inp["pixel_std"],
                       inp["size_divisibility"])
    feats = net.backbone(x)
    scales: list = []
    logits, deltas = net.rpn_head(feats, scales)
    pre_k = m["rpn"]["pre_nms_topk_train"]
    cols = {k: [] for k in ("box", "logit", "cut", "anchor", "lscale", "dscale", "level", "top")}
    for i, anchors in enumerate(ref.anchors_of(feats)):
        lg = logits[i][0]
        cols["box"].append(ref.clip(ref.decode(deltas[i][0], anchors, (1.0,) * 4), h, w))
        cols["logit"].append(lg)
        top = torch.topk(lg, min(pre_k, lg.numel()))
        cols["cut"].append(top.values[-1].expand(lg.numel()))
        cols["level"].append(torch.full_like(lg, i, dtype=torch.int64))
        cols["top"].append(torch.zeros_like(lg, dtype=torch.bool).index_fill_(0, top.indices, True))
        cols["anchor"].append(anchors)
        cols["lscale"].append(scales[i][0][0].clamp(min=TINY))
        cols["dscale"].append(scales[i][1][0])
    a = {k: torch.cat(v) for k, v in cols.items()}
    pv = props["valid"].to(torch.bool)
    pboxes = props["boxes"][pv].to(torch.float32)
    plogits = props["scores"][pv].to(torch.float32)
    bscale = box_scale(a["box"], a["anchor"], a["dscale"], (1.0,) * 4)
    idx = assign_anchors(pboxes, plogits, a["box"], a["logit"], bscale, a["lscale"])
    near = _nearest(pboxes, a["box"])
    rbox, rscale = a["box"][near], bscale[near]
    out = {"rpn_box": float(((pboxes - rbox).abs() / rscale).max()) if pboxes.numel() else 0.0}
    thresh = m["rpn"]["nms_thresh"]
    out["rpn_nms_overlap"] = nms_overlap(pboxes, a["level"][idx], thresh)
    cb = a["box"]
    cand = a["top"] & (cb[:, 2] > cb[:, 0]) & (cb[:, 3] > cb[:, 1])
    matched = torch.zeros_like(cand).index_fill_(0, idx, True)
    full = pboxes.shape[0] >= m["rpn"]["post_nms_topk_train"]
    out["rpn_nms_miss"] = nms_miss(
        {"boxes": cb[cand], "scores": a["logit"][cand], "scale": a["lscale"][cand],
         "floor": a["cut"][cand], "group": a["level"][cand], "matched": matched[cand]},
        {"boxes": pboxes, "scores": plogits, "group": a["level"][idx]},
        float(plogits.min()) if full and plogits.numel() else -math.inf, thresh)
    return out, a["anchor"]


def assign_anchors(pboxes: torch.Tensor, plogits: torch.Tensor, boxes: torch.Tensor,
                   logits: torch.Tensor, bscale: torch.Tensor, lscale: torch.Tensor,
                   tol: float = 1.0, k: int = 4, chunk: int = 128) -> torch.Tensor:
    """Each kept proposal's anchor, no anchor twice.  Candidates: the
    anchors whose decoded box (`boxes`) lies within `tol` px of the nearest
    one; cost: the box's gap over its rounding scale (`bscale`, (A, 4)) plus
    the logit's over its own (`lscale`), the units in which the program's
    answer lies about 0.01 from its own anchor; the `k` cheapest are taken
    greedily by cost.  Two anchors of different levels can clip to boxes
    within a pixel of each other (a p5 anchor at (128, 128) and the p6
    anchor at (0, 0) are both [0, 0, 256, 256]), the per-level NMS keeps
    both, and their logits can lie within bfloat16's rounding: a matcher by
    the nearest box and then the nearest logit can give two proposals one
    level, and the NMS checks then read a pair the program never compared
    and an anchor it kept as missed."""
    cand, costs = [], []
    for s in range(0, pboxes.shape[0], chunk):
        diff = (pboxes[s:s + chunk, None, :] - boxes[None]).abs()
        d = diff.amax(-1)
        near = d <= d.min(dim=1).values[:, None] + tol
        cost = (diff / bscale[None]).amax(-1) \
            + (plogits[s:s + chunk, None] - logits[None]).abs() / lscale[None]
        c, i = torch.where(near, cost, torch.full_like(cost, math.inf)).topk(
            min(k, boxes.shape[0]), dim=1, largest=False)
        cand.append(i)
        costs.append(c)
    if not cand:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    cand, costs = torch.cat(cand).cpu(), torch.cat(costs).cpu()
    out = cand[:, 0].clone()
    taken, done = set(), set()
    for flat in torch.argsort(costs.flatten(), stable=True).tolist():
        p, j = divmod(flat, cand.shape[1])
        a = int(cand[p, j])
        if p in done or a in taken or not math.isfinite(float(costs[p, j])):
            continue
        out[p] = a
        taken.add(a)
        done.add(p)
    return out.to(boxes.device)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    spacing = (torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs())
    return float(((got - want).abs() / spacing.clamp(min=torch.finfo(torch.float32).tiny)).max())


def judge_step(sd: Dict[str, torch.Tensor], bufs: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor], answer: dict, cfg: dict, it: int,
               block: int = 4) -> Dict[str, float]:
    """The readings of one step.  sd: every weight before the step
    (detectron2 keys; the trained ones as the program held them); bufs:
    the momentum buffers before it (trained keys); batch: images uint8
    (B, H, W, 3), gt_boxes, gt_classes, gt_valid; answer: {"choices":
    {"anchors", "proposals", "rois"} of (B, ...) tensors, "losses": {name:
    float}, "grads", "after", "bufs_after": {key: tensor}}; it: the
    updates made before this step (for the learning rate)."""
    m = cfg["model"]
    ch = answer["choices"]
    b = batch["images"].shape[0]
    out: Dict[str, float] = {}
    with ref.exact_float32():
        net = ref.Net(sd)
        anchor_bad, roi_bad, props = 0.0, 0.0, []
        for i in range(b):
            gt, gv = batch["gt_boxes"][i].to(torch.float32), batch["gt_valid"][i].to(torch.bool)
            p = {k: v[i] for k, v in ch["proposals"].items()}
            readings, anchors = proposal_readings(net, batch["images"][i], p, cfg)
            props.append(readings)
            anchor_bad += anchor_violations(
                anchors, gt, gv, {k: v[i] for k, v in ch["anchors"].items()}, m["rpn"])
            roi_bad += roi_violations(p, gt, batch["gt_classes"][i], gv,
                                      {k: v[i] for k, v in ch["rois"].items()}, m["roi_heads"])
        out["anchor_labels"], out["roi_labels"] = anchor_bad, roi_bad
        for k in ("rpn_box", "rpn_nms_overlap", "rpn_nms_miss"):
            out[k] = max(r[k] for r in props)
        r = train_s1.step(sd, batch, ch, cfg, block=block, split=True)
    for k in train_s1.LOSSES:
        out[k] = abs(answer["losses"][k] - float(r["losses"][k])) / max(r["scales"][k], TINY)
    heads, trunk = 0.0, 0.0
    dot, pnorm = 0.0, 0.0
    for k, g in r["grads"].items():
        got = answer["grads"][k].to(torch.float32)
        gap = float((got - g).norm() / g.norm().clamp(min=TINY))
        if train_s1.fed_by_pool(k):
            trunk = max(trunk, gap)
            p = r["pool_grads"][k]
            dot += float(((got - g) * p).sum())
            pnorm += float(p.square().sum())
        else:
            heads = max(heads, gap)
    out["grad_heads"], out["grad_trunk"] = heads, trunk
    out["grad_pool_path"] = abs(dot) / max(pnorm, TINY)
    s = cfg["solver"]
    params = {k: sd[k].to(torch.float32) for k in r["grads"]}
    new_p, new_b = train_s1.sgd(params, {k: answer["grads"][k] for k in params}, bufs,
                                train_s1.lr_at(s, it), s["momentum"], s["weight_decay"])
    out["update"] = max(max(_ulps(answer["after"][k], new_p[k]) for k in new_p),
                        max(_ulps(answer["bufs_after"][k], new_b[k]) for k in new_b))
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the judged steps."""
    if not readings:
        return {}
    return {k: max(r[k] for r in readings) for k in NUMBERS}
