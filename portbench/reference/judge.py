"""The comparison that decides `correct` for PlaneRCNN inference.

Each frame's answer (from the program's timed path, or from the control)
is judged against `planercnn.py` in float32, stage by stage, from the
answer's own discrete choices: which anchors the RPN kept, which candidates
the box stage kept, where the cascade pooled, which depth it sent.
Recomputing the whole pipeline and comparing sets would fail on every
near-tie that bfloat16 rounding flips; judging each choice by the
reference's own numbers does not, and still fails an answer that is wrong.

Every gap is measured in units of its rounding scale: for an output that a
layer computes as a sum of weight x input terms, the sum of |weight x input|
of those terms (the reference's), carried through the box decoding and the
unit normalisations.  Rounding an operand by a relative u moves an output
by at most about u times that scale, so a gap in these units reads about
the operands' relative rounding: of order 1e-3 to 1e-2 for bfloat16
arithmetic and ten times that for float8, whatever the weights make of
each output's size.  The depth alone is measured against the reference's
own bfloat16 deviation.  The numbers, each the worst over the judged
frames but the depth:

  rpn_box        each kept proposal's coordinates against the nearest box
                 the reference decodes from an anchor, per coordinate over
                 the scale of that anchor's deltas
  rpn_logit      |objectness logit - the reference's at its anchor| (the
                 nearest, or among anchors that clip to within 1 px of the
                 same box, the one whose logit is closest)
  rpn_rank       how far that anchor's reference logit lies below the
                 reference's pre-NMS top-k cut of its level
  prop_count     |kept proposals - the reference's own count| (exact)
  rpn_nms_overlap  the largest IoU above the RPN's NMS threshold between
                 two kept proposals of one level (their own boxes)
  rpn_nms_miss   the reference's pre-NMS candidates that the answer neither
                 kept nor can have suppressed: for each such candidate, how
                 far its reference logit lies above both the lowest kept
                 logit and its level's pre-NMS cut, or, where a kept
                 proposal of its level with a logit no lower overlaps it by
                 more than the threshold less NMS_SLACK, nothing; the
                 largest, in units of its logit's rounding scale
  det_box        each detection's coordinates against the nearest candidate
                 box of its class that the reference decodes from the
                 answer's proposals
  det_score      |log score - log of that candidate's reference score|
                 over its rounding scale, the largest over the judged
                 detections
  det_count      |detections - the reference's own count| on those
                 proposals (exact)
  det_nms_overlap  the largest IoU above the class NMS threshold between
                 two detections of one class
  det_nms_miss   as rpn_nms_miss for the box stage: the reference's
                 candidates (a proposal and a class over the score
                 threshold) that no detection matches, how far their log
                 score lies above the lowest detection's (or the threshold)
                 where no detection of the class scoring no lower overlaps
                 them by more than the threshold less NMS_SLACK, in units of
                 the log score's rounding scale
  mask           widest |logit| of the reference's pasted soft mask at a
                 pixel whose mask bit the answer sets the other way
  plane          the plane's direction against the reference normal at the
                 answer's box, and its offset against the reference's
                 offset from the answer's mask and depth
  axis           rot (sin, cos), rot offset and tran against the reference
  depth          root mean square of depth - reference depth (sent as the
                 program sends it: whole millimetres of the uint16 range)
                 over that of the reference's own depth computed with
                 bfloat16 operands and results, pooled over the judged
                 frames: the decoder's BatchNorms amplify upstream rounding
                 by an amount that changes from seed to seed, which no one
                 layer's scale shows
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import planercnn as ref

NUMBERS = ("rpn_box", "rpn_logit", "rpn_rank", "prop_count", "rpn_nms_overlap", "rpn_nms_miss",
           "det_box", "det_score", "det_count", "det_nms_overlap", "det_nms_miss",
           "mask", "plane", "axis", "depth")
TINY = 1e-12
# room for ties in the NMS checks: the program decided each suppression on
# its own boxes, which differ from the reference's by their rounding
NMS_SLACK = 0.05


def _nearest(query: torch.Tensor, boxes: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """For each (Q, 4) query box, the index of the nearest (L-inf) of (N, 4)
    boxes."""
    idx = [(query[s:s + chunk, None, :] - boxes[None]).abs().amax(-1).argmin(dim=1)
           for s in range(0, query.shape[0], chunk)]
    return torch.cat(idx) if idx else torch.zeros(0, dtype=torch.int64, device=boxes.device)


def _match_anchors(pboxes, plogits, boxes, logits, tol: float = 1.0, chunk: int = 128):
    """Each kept proposal's anchor: among the anchors whose decoded box lies
    within `tol` px of the nearest one (anchors that clip to the same box at
    the image border), the one whose logit is closest."""
    idx = []
    for s in range(0, pboxes.shape[0], chunk):
        d = (pboxes[s:s + chunk, None, :] - boxes[None]).abs().amax(-1)
        near = d <= d.min(dim=1).values[:, None] + tol
        gap = (plogits[s:s + chunk, None] - logits[None]).abs()
        idx.append(torch.where(near, gap, torch.full_like(gap, math.inf)).argmin(dim=1))
    if not idx:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    return torch.cat(idx)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU of (N, 4) and (M, 4) boxes, in float64 (0 where the union
    is empty)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    area = lambda x: (x[:, 2] - x[:, 0]).clamp(min=0) * (x[:, 3] - x[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None] - inter
    return torch.where(union > 0, inter / union.clamp(min=TINY), torch.zeros_like(inter))


def nms_overlap(boxes: torch.Tensor, groups: torch.Tensor, thresh: float) -> float:
    """How far the largest IoU between two kept boxes of one group lies above
    the NMS threshold (0 where none does): a valid greedy NMS output keeps
    no such pair."""
    worst = 0.0
    for g in torch.unique(groups).tolist():
        b = boxes[groups == g]
        if b.shape[0] > 1:
            m = iou(b, b).triu(1)
            worst = max(worst, float(m.max()) - thresh)
    return max(worst, 0.0)


def nms_miss(cand: Dict[str, torch.Tensor], kept: Dict[str, torch.Tensor], cut: float,
             thresh: float, chunk: int = 512) -> float:
    """The largest reading over the candidates (`cand`: boxes (N, 4),
    scores (N,), scale (N,), floor (N,), group (N,), matched (N,) bool) that
    no kept box (`kept`: boxes, scores, group) matches: how far the
    candidate's score lies above max(cut, its floor), over its scale, unless
    a kept box of its group overlaps it by more than `thresh - NMS_SLACK`
    with a score no lower (then by how far the best such box's score lies
    below the candidate's).  A greedy NMS drops a candidate only under a
    kept box of higher score that overlaps it above the threshold."""
    un = ~cand["matched"]
    if not bool(un.any()):
        return 0.0
    boxes, scores, scale = cand["boxes"][un], cand["scores"][un], cand["scale"][un]
    floor, group = cand["floor"][un].clamp(min=cut), cand["group"][un]
    excess = (scores - floor) / scale
    worst = 0.0
    for s in range(0, boxes.shape[0], chunk):
        sl = slice(s, s + chunk)
        deficit = (scores[sl, None] - kept["scores"][None]).clamp(min=0) / scale[sl, None]
        cover = ((iou(boxes[sl], kept["boxes"]) > thresh - NMS_SLACK)
                 & (group[sl, None] == kept["group"][None]))
        best = torch.where(cover, deficit, torch.full_like(deficit, math.inf)).amin(dim=1) \
            if kept["boxes"].shape[0] else torch.full_like(excess[sl], math.inf)
        r = torch.minimum(excess[sl], best).clamp(min=0)
        worst = max(worst, _max(r))
    return worst


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def box_scale(ref_boxes, anchors, delta_scale, weights) -> torch.Tensor:
    """(N, 4) rounding scale of each decoded coordinate: the deltas' scales
    carried through Box2BoxTransform (x0 = cx - w/2, cx = dx w_a / wx + c,
    w = exp(dw / ww) w_a)."""
    wa = (anchors[:, 2] - anchors[:, 0])[:, None]
    ha = (anchors[:, 3] - anchors[:, 1])[:, None]
    w = (ref_boxes[:, 2] - ref_boxes[:, 0])[:, None]
    h = (ref_boxes[:, 3] - ref_boxes[:, 1])[:, None]
    sx = delta_scale[:, 0:1] * wa / weights[0] + 0.5 * w * delta_scale[:, 2:3] / weights[2]
    sy = delta_scale[:, 1:2] * ha / weights[1] + 0.5 * h * delta_scale[:, 3:4] / weights[3]
    return torch.cat([sx, sy, sx, sy], 1).clamp(min=TINY)


def _unit_scale(raw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rounding scale of unit(raw): |scale| / |raw|."""
    return (scale.norm(dim=-1) / raw.norm(dim=-1).clamp(min=TINY)).clamp(min=TINY)


def _mask_mean_xyz(masks: torch.Tensor, depth: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """|mean xyz| over each (N, H, W) mask (1 m where a mask is empty)."""
    m = masks.to(torch.float32)
    count = m.sum(dim=(1, 2))
    mean = torch.einsum("chw,nhw->nc", rays * depth[None], m) / count.clamp(min=1.0)[:, None]
    return torch.where(count > 0, mean.norm(dim=1), torch.ones_like(count))


@torch.no_grad()
def judge_frame(net: ref.Net, frame: torch.Tensor, answer: Dict[str, torch.Tensor],
                cfg: dict) -> Dict[str, float]:
    """frame: uint8 (H, W, 3) on the reference's device; answer: boxes (n, 4),
    scores (n,), classes (n,), masks bool (n, H, W), planes (n, 3), rot_axis
    (n, 3), tran_axis (n, 2), depth (H, W) metres, proposals {boxes (K, 4),
    logits (K,), valid (K,)}; every tensor on that device."""
    m = cfg["model"]
    h, w = frame.shape[:2]
    x = ref.preprocess(frame[None], cfg["input"]["pixel_mean"], cfg["input"]["pixel_std"],
                       cfg["input"]["size_divisibility"])
    feats = net.backbone(x)
    out: Dict[str, float] = {}

    # RPN: every anchor's decoded box, logit, scales and its level's top-k cut
    scales: list = []
    logits, deltas = net.rpn_head(feats, scales)
    pre_k = m["rpn"]["pre_nms_topk_test"]
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
    pv = answer["proposals"]["valid"]
    pboxes, plogits = answer["proposals"]["boxes"][pv], answer["proposals"]["logits"][pv]
    idx = _match_anchors(pboxes, plogits, a["box"], a["logit"])
    near = _nearest(pboxes, a["box"])
    rbox = a["box"][near]
    rscale = box_scale(rbox, a["anchor"][near], a["dscale"][near], (1.0,) * 4)
    out["rpn_box"] = _max((pboxes - rbox).abs() / rscale)
    out["rpn_logit"] = _max((plogits - a["logit"][idx]).abs() / a["lscale"][idx])
    out["rpn_rank"] = _max((a["cut"][idx] - a["logit"][idx]).clamp(min=0) / a["lscale"][idx])
    own = ref.select_proposals(feats, logits, deltas, h, w, m["rpn"])
    out["prop_count"] = float(abs(pboxes.shape[0] - own["boxes"].shape[0]))
    # the RPN's NMS, per level, on the answer's own boxes and logits
    thresh = m["rpn"]["nms_thresh"]
    out["rpn_nms_overlap"] = nms_overlap(pboxes, a["level"][idx], thresh)
    cb = a["box"]
    cand = a["top"] & (cb[:, 2] > cb[:, 0]) & (cb[:, 3] > cb[:, 1])
    matched = torch.zeros_like(cand).index_fill_(0, idx, True)
    full = pboxes.shape[0] >= m["rpn"]["post_nms_topk_test"]
    out["rpn_nms_miss"] = nms_miss(
        {"boxes": cb[cand], "scores": a["logit"][cand], "scale": a["lscale"][cand],
         "floor": a["cut"][cand], "group": a["level"][cand], "matched": matched[cand]},
        {"boxes": pboxes, "scores": plogits, "group": a["level"][idx]},
        float(plogits.min()) if full and plogits.numel() else -math.inf, thresh)

    # box stage on the answer's proposals
    bscales: list = []
    blogits, bdeltas = net.box_logits(ref.roi_align(feats, pboxes, 7, 0, True), bscales)
    probs = torch.softmax(blogits, -1)
    cls_scale, del_scale = bscales[0]
    nc = probs.shape[1] - 1
    cands = ref.candidates(probs, bdeltas, pboxes, h, w)                 # (K, C, 4)
    dets = ref.select_detections(probs, bdeltas, pboxes, h, w, m["roi_heads"])
    n_own = dets["scores"].shape[0]
    boxes, classes = answer["boxes"], answer["classes"].to(torch.int64)
    n = boxes.shape[0]
    box_err = torch.full((n,), math.inf, device=boxes.device)
    k = torch.zeros(n, dtype=torch.int64, device=boxes.device)
    for cl in range(nc):
        sel = torch.nonzero(classes == cl).flatten()
        if sel.numel():
            kk = _nearest(boxes[sel], cands[:, cl])
            k[sel] = kk
            bs = box_scale(cands[kk, cl], pboxes[kk], del_scale[kk, 4 * cl:4 * cl + 4],
                           (10.0, 10.0, 5.0, 5.0))
            box_err[sel] = ((boxes[sel] - cands[kk, cl]).abs() / bs).amax(dim=1)
    ok = (classes >= 0) & (classes < nc)
    cl_ok = classes.clamp(0, nc - 1)
    ref_scores = probs[k, cl_ok]
    # d log p_c = d l_c - sum_j p_j d l_j
    log_scale = (cls_scale[k, cl_ok] + (probs[k] * cls_scale[k]).sum(dim=1)).clamp(min=TINY)
    log_gap = (answer["scores"].clamp(min=TINY).log() - ref_scores.clamp(min=TINY).log()).abs()
    out["det_box"] = _max(box_err)
    out["det_score"] = _max(torch.where(ok, log_gap / log_scale,
                                        torch.full_like(log_gap, math.inf)))
    out["det_count"] = float(abs(n - n_own))
    # class NMS on the answer's detections; candidates are the reference's
    # (proposal, class) pairs over the score threshold, in log score
    thresh = m["roi_heads"]["nms_thresh_test"]
    out["det_nms_overlap"] = nms_overlap(boxes, classes, thresh)
    fg = probs[:, :nc]
    over = fg > m["roi_heads"]["score_thresh_test"]
    matched = torch.zeros_like(over)
    matched[k[ok], cl_ok[ok]] = True
    all_scale = (cls_scale[:, :nc] + (probs * cls_scale).sum(dim=1, keepdim=True)).clamp(min=TINY)
    kk, cc = torch.nonzero(over, as_tuple=True)
    full = n >= m["roi_heads"]["detections_per_image"]
    low = float(answer["scores"].clamp(min=TINY).log().min()) if full and n else -math.inf
    out["det_nms_miss"] = nms_miss(
        {"boxes": cands[kk, cc], "scores": fg[kk, cc].log(), "scale": all_scale[kk, cc],
         "floor": torch.full_like(fg[kk, cc], math.log(m["roi_heads"]["score_thresh_test"])),
         "group": cc, "matched": matched[kk, cc]},
        {"boxes": boxes, "scores": answer["scores"].clamp(min=TINY).log(), "group": classes},
        low, thresh)

    # depth as sent, against the deviation bfloat16 arithmetic gives the
    # reference; both summed here and pooled over the frames by `worst`
    depth = net.depth(feats, (h, w))[0]
    low = ref.Net(net.sd, ref.Prec("bfloat16"))
    noise = (low.depth(low.backbone(x), (h, w))[0] - depth).square().mean()
    sent = torch.trunc((depth * 1000.0).clamp(0.0, 65535.0)) / 1000.0
    out["depth_sq"] = float((answer["depth"] - sent).square().mean())
    out["depth_noise_sq"] = max(float(noise), 1e-6)
    out["depth"] = math.sqrt(out["depth_sq"] / out["depth_noise_sq"])
    if n == 0:
        out.update(mask=0.0, plane=0.0, axis=0.0)
        return out

    # cascade at the answer's boxes
    cas = ref.cascade(net, feats, boxes, classes, h, w)
    thr = m["mask_head"]["mask_threshold"]
    masks = answer["masks"]
    soft = cas["soft"]
    wrong = masks != (soft >= thr)
    scaled = torch.logit(soft.clamp(1e-6, 1 - 1e-6)).abs() / cas["mask_scale"].clamp(min=TINY)
    out["mask"] = float(torch.where(wrong, scaled, torch.zeros_like(scaled)).amax())

    # plane: direction against the reference normal, offset against the
    # reference's offset from the answer's own mask and depth
    rays = ref.eval_rays(h, w, depth.device)
    n_scale = _unit_scale(cas["plane_raw"], cas["plane_scale"])
    planes = answer["planes"]
    p_norm = planes.norm(dim=1).clamp(min=TINY)
    dirs = planes / p_norm[:, None]
    ref_n = cas["planes"]
    turn = torch.minimum((dirs - ref_n).norm(dim=1), (dirs + ref_n).norm(dim=1))
    own = ref.override_offsets(ref_n, masks, answer["depth"], rays).norm(dim=1)
    off_scale = (_mask_mean_xyz(masks, answer["depth"], rays) * n_scale).clamp(min=TINY)
    out["plane"] = max(_max(turn / n_scale), _max((p_norm - own).abs() / off_scale))

    rs, os_, ts = cas["axis_scales"]
    rot, tran = answer["rot_axis"], answer["tran_axis"]
    out["axis"] = max(
        _max((rot[:, :2] - cas["rot"][:, :2]).norm(dim=1) / _unit_scale(cas["rot_raw"], rs)),
        _max((rot[:, 2] - cas["rot"][:, 2]).abs() / os_[:, 0].clamp(min=TINY)),
        _max((tran - cas["tran"]).norm(dim=1) / _unit_scale(cas["tran_raw"], ts)))
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over frames, but the depth's,
    which pools its squares over the frames."""
    if not readings:
        return {}
    out = {k: max(r[k] for r in readings) for k in NUMBERS}
    out["depth"] = math.sqrt(sum(r["depth_sq"] for r in readings)
                             / sum(r["depth_noise_sq"] for r in readings))
    return out
