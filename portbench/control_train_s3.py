#!/usr/bin/env python3
"""Readings that set the limits of `correct` for the stage-3 training cells,
on the card:

    python3 portbench/control_train_s3.py --workload train_s3_ims8 --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault mask_targets_half_px --fault-seeds 1 2 3] \
        [--seconds 4] [--out FILE]

For each of `--seeds`, one run of the cell's timed path (the driver, with a
short window) and the judged numbers of its steps: the lower readings.  For
each of `--control-seeds`, the same run with the control in the program's
place on each judged step: the plain reference in float8 (e4m3, below the
configuration's bfloat16) computes the losses, gradients and stored
statistics on the step's own ROI sample and weights, and the reference's SGD
the update from them: the upper readings.  For each `--fault` and each of
`--fault-seeds`, one run with that fault planted in the program (FAULTS).
One JSON line per reading on standard output (and in `--out`); the
benchmark's own runs never run this.
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

# planted faults: ("crop", dx): the GT mask crops taken in boxes moved by dx
# pixels; ("mask_norm",): the mask loss normalised over the sampled ROIs
# instead of the foreground ones; ("config", section, key, value): the
# program runs with that value in its model configuration, the judge with
# the one stated; ("bn_stored",): the depth decoder's BatchNorms on their
# stored statistics, which then stay; ("holes",): the depth loss counting
# the pixels without depth; ("plane_grad_zero",): the plane loss's value
# kept but no gradient through it, so that the plane head does not train.
FAULTS = {
    "mask_targets_half_px": ("crop", 0.5),
    "mask_norm_sampled": ("mask_norm",),
    "plane_not_normalised": ("config", "plane_head", "normal_only", False),
    "depth_bn_stored": ("bn_stored",),
    "depth_holes_counted": ("holes",),
    "plane_grad_zero": ("plane_grad_zero",),
}


@contextlib.contextmanager
def planted(fault: str):
    """Under this context manager the stage-3 driver builds and steps the
    program with `fault` (a key of FAULTS) planted."""
    import torch
    from portbench.drivers import train_step as driver
    from articulation3d_tpu_torch.models import depth_head
    from articulation3d_tpu_torch.train import targets
    from articulation3d_tpu_torch.train import train_step as ts
    kind, *what = FAULTS[fault]
    if kind == "crop":
        owner, name = targets, "crop_gt_masks"
        real_crop = targets.crop_gt_masks

        def broken(gt_masks, matched_idx, boxes, mask_size, chunk=64):
            return real_crop(gt_masks, matched_idx, boxes + what[0], mask_size, chunk)
    elif kind == "mask_norm":
        owner, name = ts, "detection_losses"
        real_losses = ts.detection_losses

        def broken(outputs, rois, *args, **kw):
            out = real_losses(outputs, rois, *args, **kw)
            fg = rois.is_fg.sum().clamp(min=1).to(torch.float32)
            sampled = rois.is_sampled.sum().clamp(min=1).to(torch.float32)
            return dict(out, loss_mask=out["loss_mask"] * fg / sampled)
    elif kind == "plane_grad_zero":
        owner, name = ts, "detection_losses"
        real_losses = ts.detection_losses

        def broken(outputs, rois, *args, **kw):
            out = real_losses(outputs, rois, *args, **kw)
            lp = out["loss_plane"]
            return dict(out, loss_plane=lp.detach() + 0.0 * lp)
    elif kind == "config":
        owner, name = driver, "program_config"
        section, key, value = what
        real_config = driver.program_config

        def broken(config, output_dir):
            config = copy.deepcopy(config)
            config["config"]["model"][section][key] = value
            return real_config(config, output_dir)
    elif kind == "bn_stored":
        owner, name = depth_head.BatchNorm2d, "forward"
        real_forward = depth_head.BatchNorm2d.forward

        def broken(self, x, train=False, over_ranks=False):
            return real_forward(self, x, False, over_ranks)
    else:
        owner, name = targets, "depth_l1_loss_masked"

        def broken(pred, gt, over_ranks=False):
            return (pred - gt).abs().mean()
    real = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def float8_in_the_programs_place():
    """Judge, for each judged step, the float8 control's losses, gradients,
    stored statistics and update on the step's own ROI sample, weights and
    momentum, in place of the program's."""
    from portbench.reference import judge_train_s3, train_s1, train_s3
    from portbench.reference import planercnn as ref
    real = judge_train_s3.judge_step

    def judged(sd, bufs, batch, answer, cfg, it, block=4):
        # the control's L1 signs are its own, as the program's are
        choices = {k: v for k, v in answer["choices"].items() if k != "pred"}
        with ref.exact_float32():
            r = train_s3.step(sd, batch, choices, cfg,
                              prec=train_s1.STEPrec("float8"), block=block)
        s = cfg["solver"]
        params = {k: sd[k] for k in r["grads"]}
        new_p, new_b = train_s3.sgd(params, r["grads"], bufs, train_s1.lr_at(s, it),
                                    s["momentum"], s["weight_decay"])
        ctrl = dict(answer, choices=dict(choices, pred=r["pred"]),
                    losses={k: float(v) for k, v in r["losses"].items()},
                    grads=r["grads"], after=new_p, bufs_after=new_b, stats_after=r["stats"])
        return real(sd, bufs, batch, ctrl, cfg, it, block)

    judge_train_s3.judge_step = judged
    try:
        yield
    finally:
        judge_train_s3.judge_step = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="train_s3_ims8")
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
        print("control_train_s3: no CUDA device", file=sys.stderr)
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
