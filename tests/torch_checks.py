"""Checks and inputs shared by the port's card tests (`test_torch_card_*.py`,
`test_torch_roi_align_cuda.py`, run with `-m cuda --noconftest`) and by the
CPU tests of the same helpers.

Imports neither JAX nor the JAX package: the card's machine has neither.
Nothing here touches the card or the disk when the module is imported.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDES = (4, 8, 16, 32)
# pool -> (output size, sampling ratio, aligned): the box, mask and plane heads'
POOLS = {"box": (7, 0, True), "mask": (14, 2, False), "plane": (14, 0, False)}


# --------------------------------------------------------------------------- #
# K1's record and the kernels against their plain versions
# --------------------------------------------------------------------------- #

def check_record(rac, feats, boxes, valid, p, sr, aligned, adaptive_cap=None):
    """K1's record (its fused prologue, on the card) equals torch `_prepare`
    and `_roi_record` on the same device integer for integer, and every
    level is detectron2's.  Returns the record."""
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned,
                adaptive_cap=adaptive_cap)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(opts, min_level=2))
    shapes = [f.shape for f in feats]
    want = rac._record_of(rac._prepare(shapes, boxes, valid=valid, **opts))
    twin = rac._roi_record(shapes, boxes, valid=valid, **opts)
    bad = (record != want).any(1) | (twin != want).any(1)
    assert not bool(bad.any()), (int(bad.sum()), record[bad][:4].tolist(),
                                 want[bad][:4].tolist(), twin[bad][:4].tolist())
    base = rac.assign_boxes_to_levels(boxes.reshape(-1, 4).float()) - 2
    assert int((record[:, 0].long() != base).sum()) == 0
    return record


def main_path_err(rac, calls) -> float:
    """K1 against its plain version on a path's own pool inputs
    (`PlaneRCNN._pool`'s arguments, as `record_pools` keeps them): within
    1e-5 x max|plain| for float32 maps, 1e-2 x for bfloat16.  A training
    pool goes through `multilevel_roi_align_train` (K1 inside the autograd
    Function), an inference pool through the K1 wrapper.  Returns the
    largest error."""
    err = 0.0
    for roi_feats, boxes, kw in calls:
        args = dict(strides=STRIDES, output_size=kw["resolution"],
                    sampling_ratio=kw["sampling_ratio"], aligned=kw["aligned"],
                    valid=kw["valid"])
        with torch.no_grad():
            if kw.get("training"):
                got = rac.multilevel_roi_align_train(roi_feats, boxes, impl="cuda", **args)
            else:
                got = rac.multilevel_roi_align_cuda(roi_feats, boxes, **args)
            want = rac.multilevel_roi_align_separable(roi_feats, boxes, **args)
        e, scale = float((got - want).abs().max()), float(want.abs().max())
        tol = 1e-5 if roi_feats[0].dtype == torch.float32 else 1e-2
        assert e <= tol * scale, (kw["resolution"], tuple(boxes.shape), e, tol * scale)
        err = max(err, e)
    return err


class record_pools:
    """Keeps the inputs of the first `n` calls of `PlaneRCNN._pool`, on
    every model, until `restore()`: the pool inputs of a path that builds
    its own model (`train_net`, `Trainer.test`)."""

    def __init__(self, n: int):
        from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
        self.cls, self.orig, self.calls = PlaneRCNN, PlaneRCNN._pool, []

        def rec(model, roi_feats, boxes, **kw):
            if len(self.calls) < n:
                self.calls.append(([f.detach() for f in roi_feats], boxes.detach(), kw))
            return self.orig(model, roi_feats, boxes, **kw)

        PlaneRCNN._pool = rec

    def restore(self):
        self.cls._pool = self.orig


def pallas_moved(boxes, valid, p, sr, aligned):
    """(T,) bool: the valid ROIs that the JAX Pallas kernel pools from a
    level coarser than detectron2's: a copy of its rule (`pallas_level_idx`,
    articulation3d_tpu/ops/roi_align_pallas.py:120-171) on the port's own
    sample placement, held to that rule by `test_torch_roi_prologue.py`.
    With the JAX package's cap of 4 samples, an ROI moves when the cells
    its samples need at its level (rows from floor(first) - 1, clamped at
    0, to floor(last) + 1; columns the same from an origin floored to a
    multiple of 8) exceed 64 rows or 80 columns, unless its level is the
    top one (p5)."""
    from articulation3d_tpu_torch.ops.roi_align import _sample_coords, assign_boxes_to_levels
    flat = boxes.reshape(-1, 4).float()
    lv = assign_boxes_to_levels(flat) - 2
    scale = torch.tensor([1.0 / s for s in STRIDES], dtype=torch.float32,
                         device=flat.device)[lv]
    ys, xs, ym, xm = _sample_coords(flat, scale, p, sr, aligned, adaptive_cap=4)
    lo = lambda c, m: torch.where(m > 0, c, torch.full_like(c, 1e9)).amin((1, 2))
    hi = lambda c, m: torch.where(m > 0, c, torch.full_like(c, -1e9)).amax((1, 2))
    need_y = torch.floor(hi(ys, ym)) + 2 - (torch.floor(lo(ys, ym)) - 1).clamp(min=0)
    x0 = torch.floor((torch.floor(lo(xs, xm)) - 1).clamp(min=0) / 8) * 8
    need_x = torch.floor(hi(xs, xm)) + 2 - x0
    moved = ((need_y > 64) | (need_x > 80)) & (lv < len(STRIDES) - 1)
    if valid is not None:
        moved &= valid.reshape(-1).bool()
    return moved


# --------------------------------------------------------------------------- #
# agreement of two runs
# --------------------------------------------------------------------------- #

def route_agreement(a, b, masks_a=None, masks_b=None, heads=("planes",)) -> dict:
    """Kernel route `a` against plain route `b` (Detections of one batch),
    detections matched greedily by IoU >= 0.7 in `b`'s order: the matched
    share, the largest box error and the largest error of each of `heads`
    over the matched pairs; with full masks, the IoU of the two routes'
    foreground over the matched detections (pixels both routes mark over
    pixels either marks, summed over the pairs) and the share of equal
    pixels (near 1 whatever the masks: each pixel is in at most one of an
    image's masks)."""
    from articulation3d_tpu_torch.evaluation.goldens import match_detections
    host = lambda t, i, v: t[i].cpu().numpy()[v]
    n_ref = n_match = 0
    box_err, head_err = 0.0, {k: 0.0 for k in heads}
    inter = union = eq = tot = 0
    for i in range(a.boxes.shape[0]):
        va, vb = a.valid[i].cpu().numpy(), b.valid[i].cpu().numpy()
        ra, rb = host(a.boxes, i, va), host(b.boxes, i, vb)
        ri, oi = match_detections(rb, ra)
        n_ref, n_match = n_ref + len(rb), n_match + len(ri)
        if not len(ri):
            continue
        box_err = max(box_err, float(np.abs(rb[ri] - ra[oi]).max()))
        for k in heads:
            ga, gb = host(getattr(a, k), i, va)[oi], host(getattr(b, k), i, vb)[ri]
            head_err[k] = max(head_err[k], float(np.abs(ga - gb).max()))
        if masks_a is not None:
            ma = masks_a[i][np.nonzero(va)[0][oi]]
            mb = masks_b[i][np.nonzero(vb)[0][ri]]
            inter += int((ma & mb).sum())
            union += int((ma | mb).sum())
            eq += int((ma == mb).sum())
            tot += ma.size
    return dict(matched=n_match / max(n_ref, 1), n_ref=n_ref, box_err=box_err,
                head_err=head_err, fg_iou=inter / max(union, 1), fg_union=union,
                equal_pixels=eq / max(tot, 1))


def param_samples(model) -> dict:
    """A strided sample (stride numel // 4096, at least 1; float64 on the
    host) of every trainable parameter."""
    out = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            flat = p.detach().reshape(-1)
            out[n] = flat[::max(1, flat.numel() // 4096)].double().cpu().numpy()
    return out


def params_agree(a: dict, b: dict, before: dict, rel: float = 1e-3) -> float:
    """The largest |a - b| of the samples over `rel` x the largest change the
    steps made to that tensor plus 1e-6 x its magnitude (agreement: <= 1)."""
    worst = 0.0
    assert set(a) == set(b) == set(before)
    for n in b:
        tol = rel * np.abs(b[n] - before[n]).max() + 1e-6 * np.abs(b[n]).max()
        worst = max(worst, float(np.abs(a[n] - b[n]).max()) / max(tol, 1e-30))
    return worst


def dicts_agree(a, b) -> float:
    """The largest difference between two evaluator dicts with the same
    keys in the same order (NaN equal to NaN)."""
    assert list(a) == list(b), (list(a), list(b))
    worst = 0.0
    for k in a:
        if isinstance(a[k], dict):
            worst = max(worst, dicts_agree(a[k], b[k]))
            continue
        x, y = float(a[k]), float(b[k])
        if np.isnan(x) or np.isnan(y):
            assert np.isnan(x) and np.isnan(y), (k, x, y)
            continue
        worst = max(worst, abs(x - y))
    return worst


# --------------------------------------------------------------------------- #
# the bfloat16 gradient sync
# --------------------------------------------------------------------------- #

def recording_bf16_hook(store: list):
    """`parallel.dist.bf16_grad_sync_hook` that also keeps each bucket as
    this rank had it and as the sync left it."""
    from articulation3d_tpu_torch.parallel import dist as pdist
    hook = pdist.bf16_grad_sync_hook

    def recording(group, bucket):
        local = bucket.buffer().clone()

        def keep(fut):
            store.append((local, fut.value().clone()))
            return fut.value()

        return hook(group, bucket).then(keep)

    return recording


def check_bf16_buckets(store: list, world: int) -> dict:
    """Each recorded bucket's sync against JAX's order, from the ranks' own
    buckets (two ranks): bit-equal to ((g0/2).bf16 + (g1/2).bf16) in
    bfloat16; how many values differ from the float32 sync."""
    import torch.distributed as dist
    assert world == 2, world
    exact, n, off_f32 = True, 0, 0
    for local, synced in store:
        both = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(both, local)
        want = ((both[0] / 2).bfloat16() + (both[1] / 2).bfloat16()).bfloat16().float()
        exact &= torch.equal(synced, want)
        n += synced.numel()
        off_f32 += int((synced != both[0] / 2 + both[1] / 2).sum())
    return {"buckets": len(store), "values": n, "exact": exact, "off_f32": off_f32}


# --------------------------------------------------------------------------- #
# the serving model at full width
# --------------------------------------------------------------------------- #

def parity_config(**model_kw):
    """configs/config.yaml at score threshold 0, with `model_kw`: the
    parity caps (1000 post-NMS proposals, 100 detections per image)."""
    from articulation3d_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    heads = dataclasses.replace(cfg.model.roi_heads, score_thresh_test=0.0)
    return cfg.replace(weights="", model=dataclasses.replace(cfg.model, roi_heads=heads,
                                                             **model_kw))


def serving_weights(cfg):
    """`random_state_dict(0)` with the config's refine / DRPN keys, the RPN
    deltas damped by 0.01 and, with the refine head, its instance logits
    lifted by 2.  A trained RPN proposes boxes near its anchors; at the
    random weights' scale the deltas hit the log(1000/16) clamp and most
    proposals become full-height slivers.  `portbench/weights.py` draws
    other values on the device and has no refine or DRPN keys, so the
    card tests that compare with these weights' earlier runs keep them."""
    from articulation3d_tpu_torch.weights import random_state_dict, schema_options
    sd = random_state_dict(0, **schema_options(cfg.model))
    for k in ("weight", "bias"):
        sd[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= 0.01
    if cfg.model.refine_on:
        # at random weights the global background logit wins every pixel;
        # lift the instance logits so the refined masks are not all empty
        sd["refine_head.refinement_block.pred.1.bias"] += np.float32(2.0)
    return sd


def calibrate_depth_bn(model, frames) -> None:
    """Set the depth head's BatchNorm statistics to those of `frames` (one
    train-mode pass of the model itself at momentum 1).  The random
    statistics of `random_state_dict` leave the eval-mode decoder's output
    near 4e8 m; the refine head reads the depth (its plane offsets and an
    input channel), so it gets metres, as from a trained model.
    `portbench/weights.py::calibrate` sets them from the plain reference's
    pass and also moves the class biases, so it is not this."""
    from articulation3d_tpu_torch.models.depth_head import BatchNorm2d
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    bns = [m for m in model.depth_head.modules() if isinstance(m, BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    with torch.no_grad():
        feats = model.features(preprocess_images(torch.from_numpy(np.stack(frames)).cuda()))
        for m in bns:
            m.momentum = 1.0
        try:
            with model._autocast(feats["p2"].device):
                model.depth_head(feats, train=True)
        finally:
            for m, v in zip(bns, momenta):
                m.momentum = v


# --------------------------------------------------------------------------- #
# the recipe: a synthetic dataset on disk, the evaluators' known answers
# --------------------------------------------------------------------------- #

# split -> (positive videos, records per positive video, negative videos,
# records per negative video)
RECIPE_SPLITS = {"train": (5, 8, 1, 8), "val": (2, 6, 1, 4), "test": (2, 6, 1, 4)}
PLANE_KEY = "plane_ap@iou0.5normal30.0offset0.3"


def write_recipe_dataset(root: str, h: int = 480, w: int = 640, clip_frames: int = 32,
                         seed: int = 0) -> dict:
    """A synthetic dataset in the schema `tools/generate_arti.py` emits
    (XYXY boxes, `bbox_mode` 0, contiguous `category_id` 0/1, integer
    `image_id`, negative records with no annotations), under `root`:
    `articulation/cached_set_{train,val,test}.json` and the same train and
    val records as `scannet/cached_set_{train,val}.json`, frames in `arti/`,
    u16 millimetre depth in `arti_depth/`.

    Each video is a seeded noise scene (as `tools/make_soak_dataset.py`
    draws it) `clip_frames` pixels wider than a frame, with 1-3 bright
    rectangles, each with a dark axis line; frame t is the scene shifted t
    pixels, named `{youtube11}_001_5_{t}.png`.  Annotations carry a polygon,
    a unit normal, a plane and a rot or tran axis that misses the box
    centre.  The val split's positive videos are also written whole as
    `clips/{video_id}.mp4`.  Returns {split: records}."""
    import cv2

    from articulation3d_tpu_torch.video.io import write_video

    for d in ("arti", "arti_depth", "articulation", "scannet", "clips"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rs = np.random.RandomState(seed)
    ramp = (1500 + np.arange(h)[:, None] * 4 + np.arange(w)[None, :] % 128).astype(np.uint16)
    cw = (w - clip_frames) // 3                       # one object per column
    out = {}
    for split, (n_pos, per_pos, n_neg, per_neg) in RECIPE_SPLITS.items():
        records = []
        for v in range(n_pos + n_neg):
            yt = (split.upper() + "XXXXX")[:5] + f"{v:06d}"
            positive = v < n_pos
            base = rs.randint(0, 90, (h, w + clip_frames, 3)).astype(np.uint8)
            stripes = (np.arange(h)[:, None] // 16 % 2) * 25
            base = np.clip(base + stripes[..., None], 0, 255).astype(np.uint8)
            objects = []
            for j in range(rs.randint(1, 4) if positive else 0):
                bw, bh = rs.uniform(0.35, 0.85) * cw, rs.uniform(0.15, 0.4) * h
                x1 = clip_frames + j * cw + rs.uniform(0, cw - bw)
                y1 = rs.uniform(0.05 * h, 0.95 * h - bh)
                x2, y2 = x1 + bw, y1 + bh
                cat = (v + j) % 2
                axis = ([x1 + 0.15 * bw, y1, x1 + 0.15 * bw, y2] if cat == 0
                        else [x1, y1 + 0.7 * bh, x2, y1 + 0.7 * bh])
                color = tuple(int(c) for c in rs.randint(180, 255, 3))
                cv2.rectangle(base, (int(x1), int(y1)), (int(x2), int(y2)), color, -1)
                cv2.line(base, (int(axis[0]), int(axis[1])), (int(axis[2]), int(axis[3])),
                         (30, 30, 30), 3)
                normal = rs.randn(3) * [0.3, 0.3, 0.0] + [0.0, 0.0, 1.0]
                normal = (normal / np.linalg.norm(normal)).tolist()
                objects.append((x1, y1, x2, y2, cat, axis, normal,
                                (np.asarray(normal) * rs.uniform(1.0, 4.0)).tolist()))
            frames = [np.ascontiguousarray(base[:, t:t + w]) for t in range(clip_frames)]
            offsets = (np.linspace(0, clip_frames - 1, per_pos).round().astype(int)
                       if positive else np.arange(per_neg))
            for t in offsets:
                stem = f"{yt}_001_5_{t}"
                path = os.path.join(root, "arti", stem + ".png")
                depth = os.path.join(root, "arti_depth", stem + ".png")
                cv2.imwrite(path, frames[t])
                cv2.imwrite(depth, ramp + np.uint16(10 * (len(records) % 50)))
                annos = []
                for x1, y1, x2, y2, cat, axis, normal, plane in objects:
                    bx = [x1 - t, y1, x2 - t, y2]
                    ax = [axis[0] - t, axis[1], axis[2] - t, axis[3]]
                    annos.append({"bbox": bx, "bbox_mode": 0, "category_id": cat,
                                  "segmentation": [[bx[0], bx[1], bx[2], bx[1], bx[2], bx[3],
                                                    bx[0], bx[3]]],
                                  "rot_axis": ax if cat == 0 else None,
                                  "tran_axis": ax if cat == 1 else None,
                                  "normal": normal, "plane": plane})
                records.append({"file_name": path, "image_id": len(records), "height": h,
                                "width": w, "depth_path": depth, "annotations": annos})
            if split == "val" and positive:
                write_video(os.path.join(root, "clips", f"{yt}_1_5.mp4"), frames, fps=30.0)
        for sub, names in (("articulation", ["arti_rot", "arti_tran"]),
                           ("scannet", ["plane", "plane2"])):
            if sub == "scannet" and split == "test":
                continue
            with open(os.path.join(root, sub, f"cached_set_{split}.json"), "w") as f:
                json.dump({"info": {"description": f"synthetic {split} set"},
                           "categories": [{"id": i, "name": n} for i, n in enumerate(names)],
                           "data": records}, f)
        out[split] = records
    return out


def known_answer_predictions(records, rotate_axes: bool = False) -> list:
    """The GT of `records` as predictions: score 1, exact XYWH boxes, RLE
    masks of the polygons, the GT axes encoded about the box centres (their
    line normals turned by 90 degrees with `rotate_axes`), and planes whose
    normals the evaluator's ScanNet -> SunCG swap maps onto the GT normals.
    Negative records predict nothing."""
    from articulation3d_tpu_torch.data.axis_codec import axis_to_angle_offset
    from articulation3d_tpu_torch.data.mapper import polygons_to_bitmask
    from articulation3d_tpu_torch.utils.rle import rle_encode
    preds = []
    for rec in records:
        inst, rot, tran, planes = [], [], [], []
        for a in rec["annotations"]:
            x1, y1, x2, y2 = a["bbox"]
            mask = polygons_to_bitmask(a["segmentation"], rec["height"], rec["width"])
            inst.append({"image_id": rec["image_id"], "category_id": a["category_id"],
                         "bbox": [x1, y1, x2 - x1, y2 - y1], "score": 1.0,
                         "segmentation": rle_encode(mask)})
            axis = a["rot_axis"] if a["rot_axis"] is not None else a["tran_axis"]
            enc = axis_to_angle_offset(np.asarray([axis], np.float64),
                                       np.asarray([[(x1 + x2) / 2, (y1 + y2) / 2]]))[0]
            enc = enc.astype(np.float64)
            if rotate_axes:
                enc[0], enc[1] = enc[1], -enc[0]
            rot.append(enc[:3])
            tran.append(enc[:2])
            n = a["normal"]
            planes.append([n[0], n[2], n[1]])
        preds.append({"image_id": rec["image_id"], "file_name": rec["file_name"],
                      "instances": inst, "pred_rot_axis": np.asarray(rot).reshape(-1, 3),
                      "pred_tran_axis": np.asarray(tran).reshape(-1, 2),
                      "pred_plane": np.asarray(planes).reshape(-1, 3)})
    return preds


def check_eval_values(results, dataset_name: str) -> list:
    """Every value finite, or NaN where the COCO protocol gives NaN: an
    area range or a category without GT in the dataset.  Returns the NaN
    keys."""
    import math

    from articulation3d_tpu_torch.data.catalog import get_dataset_dicts, get_metadata
    from articulation3d_tpu_torch.evaluation import convert_to_coco_dict
    from articulation3d_tpu_torch.evaluation.coco_eval import AREA_RANGES
    anns = convert_to_coco_dict(get_dataset_dicts(dataset_name),
                                get_metadata(dataset_name))["annotations"]
    names = {c: n for c, n in zip(get_metadata(dataset_name).thing_dataset_id_to_contiguous_id,
                                  get_metadata(dataset_name).thing_classes)}
    by_range = {"APs": "small", "APm": "medium", "APl": "large"}
    nan = []
    for k, v in results.items():
        v = float(v)
        if math.isfinite(v):
            continue
        assert math.isnan(v), (k, v)
        metric = k.split("/", 1)[-1]
        if metric in by_range:
            lo, hi = AREA_RANGES[by_range[metric]]
            assert not any(lo <= a["area"] < hi for a in anns), (k, "has GT in its range")
        elif metric.startswith("AP-"):
            assert not any(names[a["category_id"]] == metric[3:] for a in anns), (k, "has GT")
        else:
            raise AssertionError(f"{k} is NaN")
        nan.append(k)
    return nan


def recipe_argv(stage: str, out: str, weights: str, ckpt_period: int, *flags) -> list:
    """`train_net`'s command line for one stage of the recipe: the shipped
    config with the recipe's overrides, the flags before the overrides."""
    return ["--config-file", os.path.join(ROOT, "configs", f"{stage}.yaml"), *flags,
            "weights", weights, "output_dir", out, "solver.warmup_iters", "0",
            "solver.base_lr", "0.002", "test.eval_period", "0",
            "solver.checkpoint_period", str(ckpt_period), "model.roi_pooler_impl", "cuda",
            "model.roi_heads.score_thresh_test", "0.0"]
