#!/usr/bin/env python3
"""Readings that set the limits of `correct` for the training cells, on the
card:

    python3 portbench/control_train.py --workload train_s1_ims16 --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault pool_grad_dropped --fault-seeds 1 2 3] \
        [--seconds 4] [--out FILE]

For each of `--seeds`, one run of the cell's timed path (the driver, with a
short window) and the judged numbers of its steps: the lower readings.  For
each of `--control-seeds`, the same run with the control in the program's
place on each judged step: the plain reference in float8 (e4m3, below the
configuration's bfloat16) selects its own train-mode proposals and samples
its own ROIs from them (`own_choices`; the anchor sample is the step's),
computes the losses and gradients on those choices and the step's weights,
and the reference's SGD the update from them: the upper readings.  For each `--fault` and each of `--fault-seeds`, one run
with that fault planted in the program (FAULTS): the upper readings of the
numbers the control does not separate.  One JSON line per reading on
standard output (and in `--out`); the benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# planted faults.  "adjoint": the pool's gradient with respect to the
# features dropped (K2 skipped); ("config", section, key, value): the
# program runs with that value in its model configuration, the judge with
# the one stated (an NMS threshold of 1.0 suppresses nothing); ("scale",
# loss function, keys, factor): the program's losses of that function
# multiplied where it returns them ("images": by the batch's images, a
# normaliser that counts one image's anchors or ROIs, not the batch's).
FAULTS = {
    "pool_grad_dropped": ("adjoint",),
    "roi_fraction_0.5": ("config", "roi_heads", "positive_fraction", 0.5),
    "rpn_nms_skipped": ("config", "rpn", "nms_thresh", 1.0),
    "rpn_nms_0.5": ("config", "rpn", "nms_thresh", 0.5),
    "rpn_norm_per_image": ("scale", "rpn_losses", ("loss_rpn_cls", "loss_rpn_loc"), "images"),
    "cls_norm_per_image": ("scale", "detection_losses", ("loss_cls",), "images"),
    "box_reg_twice": ("scale", "detection_losses", ("loss_box_reg",), 2.0),
}


def _images(args) -> int:
    """The batch's images, from the second argument of `rpn_losses`
    (gt_boxes) or of `detection_losses` (the SampledROIs)."""
    second = args[1]
    return (second if hasattr(second, "shape") else second.boxes).shape[0]


@contextlib.contextmanager
def planted(fault: str):
    """Under this context manager the training driver builds and steps the
    program with `fault` (a key of FAULTS) planted."""
    import torch
    from portbench.drivers import train_step as driver
    from articulation3d_tpu_torch.ops import roi_align_cuda
    from articulation3d_tpu_torch.train import train_step as ts
    kind, *what = FAULTS[fault]
    if kind == "adjoint":
        owner, name = roi_align_cuda, "multilevel_roi_align_adjoint_cuda"

        def broken(g, feat_shapes, *args, **kw):
            return [torch.zeros(tuple(s), dtype=torch.float32, device=g.device)
                    for s in feat_shapes]
    elif kind == "config":
        owner, name = driver, "program_config"
        section, key, value = what
        real_config = driver.program_config

        def broken(config, output_dir):
            config = copy.deepcopy(config)
            config["config"]["model"][section][key] = value
            return real_config(config, output_dir)
    else:
        fn, keys, factor = what
        owner, name = ts, fn
        real_fn = getattr(ts, fn)

        def broken(*args, **kw):
            out = real_fn(*args, **kw)
            f = _images(args) if factor == "images" else factor
            return {k: v * f if k in keys else v for k, v in out.items()}
    real = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, real)


def own_choices(net, batch: dict, choices: dict, cfg: dict, seed: int) -> dict:
    """The control's own choices for a step, in the program's padded layout:
    its train-mode proposals (`planercnn.select_proposals` on `net`'s RPN,
    at the train top-k) and its ROI sample from them (GT appended, labelled
    at the IoU threshold, at most `positive_fraction` of the batch
    foreground, drawn from `seed`).  The anchor sample is the step's own
    (`choices`): it owes nothing to the proposals."""
    import torch
    from portbench.reference import planercnn as ref
    from portbench.reference.judge import iou
    m, inp = cfg["model"], cfg["input"]
    rpn, heads = m["rpn"], m["roi_heads"]
    at_train = dict(rpn, pre_nms_topk_test=rpn["pre_nms_topk_train"],
                    post_nms_topk_test=rpn["post_nms_topk_train"])
    images = batch["images"]
    b, h, w = images.shape[:3]
    dev, k, s = images.device, rpn["post_nms_topk_train"], heads["batch_size_per_image"]
    nc, cap = heads["num_classes"], int(s * heads["positive_fraction"])
    props = {"boxes": torch.zeros(b, k, 4, device=dev), "scores": torch.zeros(b, k, device=dev),
             "valid": torch.zeros(b, k, dtype=torch.bool, device=dev)}
    rois = {"boxes": torch.zeros(b, s, 4, device=dev),
            "classes": torch.full((b, s), nc, dtype=torch.int64, device=dev),
            "matched_idx": torch.zeros(b, s, dtype=torch.int64, device=dev),
            "is_sampled": torch.zeros(b, s, dtype=torch.bool, device=dev),
            "is_fg": torch.zeros(b, s, dtype=torch.bool, device=dev)}
    gen = torch.Generator().manual_seed(int(seed))
    shuffled = lambda idx: idx[torch.randperm(idx.numel(), generator=gen).to(idx.device)]
    with torch.no_grad():
        for i in range(b):
            feats = net.backbone(ref.preprocess(images[i:i + 1], inp["pixel_mean"],
                                                inp["pixel_std"], inp["size_divisibility"]))
            logits, deltas = net.rpn_head(feats)
            p = ref.select_proposals(feats, logits, deltas, h, w, at_train)
            n = p["boxes"].shape[0]
            props["boxes"][i, :n], props["scores"][i, :n] = p["boxes"], p["logits"]
            props["valid"][i, :n] = True
            gv = batch["gt_valid"][i].to(torch.bool)
            rows = torch.nonzero(gv)[:, 0]
            gt = batch["gt_boxes"][i].to(torch.float32)
            cand = torch.cat([p["boxes"], gt[gv]])
            best, j = iou(cand, gt[gv]).max(dim=1)
            fg = best >= heads["iou_threshold"]
            fg_rows = shuffled(torch.nonzero(fg)[:, 0])[:cap]
            take = torch.cat([fg_rows, shuffled(torch.nonzero(~fg)[:, 0])[:s - fg_rows.numel()]])
            t, matched = take.numel(), rows[j[take]]
            rois["boxes"][i, :t], rois["matched_idx"][i, :t] = cand[take], matched
            rois["classes"][i, :t] = torch.where(
                fg[take], batch["gt_classes"][i].to(torch.int64)[matched], nc)
            rois["is_sampled"][i, :t], rois["is_fg"][i, :t] = True, fg[take]
    return {"anchors": choices["anchors"], "proposals": props, "rois": rois}


@contextlib.contextmanager
def float8_in_the_programs_place():
    """Judge, for each judged step, the float8 control's own choices
    (`own_choices`) and its losses, gradients and update on them and on the
    step's own weights and momentum, in place of the program's."""
    from portbench.reference import judge_train, train_s1
    from portbench.reference import planercnn as ref
    real = judge_train.judge_step

    def judged(sd, bufs, batch, answer, cfg, it, block=4):
        with ref.exact_float32():
            ch = own_choices(ref.Net(sd, ref.Prec("float8")), batch, answer["choices"], cfg, it)
            r = train_s1.step(sd, batch, ch, cfg, prec=train_s1.STEPrec("float8"), block=block)
        s = cfg["solver"]
        params = {k: sd[k] for k in r["grads"]}
        new_p, new_b = train_s1.sgd(params, r["grads"], bufs, train_s1.lr_at(s, it),
                                    s["momentum"], s["weight_decay"])
        ctrl = dict(answer, choices=ch, losses={k: float(v) for k, v in r["losses"].items()},
                    grads=r["grads"], after=new_p, bufs_after=new_b)
        return real(sd, bufs, batch, ctrl, cfg, it, block)

    judge_train.judge_step = judged
    try:
        yield
    finally:
        judge_train.judge_step = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", nargs="*", default=[], choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import spec
    if not torch.cuda.is_available():
        print("control_train: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.benchmark()
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    runs = [("program", None, s) for s in args.seeds]
    runs += [("control", None, s) for s in args.control_seeds]
    runs += [("fault", f, s) for f in args.fault for s in args.fault_seeds]
    for who, fault, seed in runs:
        ctx = spec.context(bench, args.workload, seed, args.seconds, False, dev,
                           time.perf_counter())
        driver = spec.load_module("drivers", ctx.workload["driver"])
        cm = (planted(fault) if who == "fault" else float8_in_the_programs_place()
              if who == "control" else contextlib.nullcontext())
        t = time.perf_counter()
        with cm:
            out = driver.run(ctx)
        row = {"who": who, "seed": seed, "readings": out["readings"],
               "counts": out.get("counts"), "seconds": time.perf_counter() - t}
        if who == "fault":
            row["fault"] = fault
        if who == "control":
            row["precision"] = "float8"
        emit(row)
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
