"""Driver of the stage-3 training cells: the program's own training loop,
`Trainer.train`, one step at a time on a pool of plane batches made on the
card, over a detector frozen after stage 1.

Set-up, warm-up and the window are the stage-1 driver's (`train_step.py`,
whose helpers this imports): the batch pool (`traffic/train_planes.py`)
and the weights from the seed on the device (the trunk's frozen
BatchNorm variances set from the first `calibration` images; the depth
decoder's stored statistics as drawn), the `Trainer` of the configuration
with a loader that cycles the pool, `warmup_calls` steps, then closed-loop
steps until `--seconds` have passed.  The judged steps are `judge_calls`
steps drawn from the seed among the window's first `sample_calls`: for
each, the trained parameters, momentum buffers and the depth decoder's
stored statistics are copied on the device before and after it, its
gradients before the update, and its ROI sample, GT mask crops and plane
and depth predictions are read through `tracing.keeping()`.  With `--trace 1`, `trace_calls` more steps run under
the program's recorder (its spans and counters; each step's ROI sample
kept, its foreground rows summed on the device after the window), then
`trace_calls` under `torch.profiler`.  After the windows the judged steps
are held against the plain reference (`reference/judge_train_s3.py`).

The program must keep a step's mask targets ("train.mask_targets") and
its plane and depth predictions ("train.planes", "train.depth"); a
program without them fails after its first warm-up step, before any
timing.
"""

from __future__ import annotations

import contextlib
import gc
import math
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import judge_train_s3
from .. import program_trace, tracing as pbtracing
from . import train_step as s1
from .video_infer import sampled_calls

# what the program keeps of a step for the judge
KEPT = ("train.rois", "train.mask_targets", "train.planes", "train.depth")
# the program's spans whose kernels the per-layer metrics read
SPANS = ("train.mask_head", "train.plane_head", "train.mask_targets", "train.depth_head",
         "train.backward")


def _stats(st: dict) -> Dict[str, torch.Tensor]:
    """Copies of the depth decoder's stored statistics."""
    return {k: b.detach().clone() for k, b in st["trainer"].model.named_buffers()
            if k.startswith("depth_head.") and ("running_mean" in k or "running_var" in k)}


def _steps(st: dict, seconds: float, max_steps, judged=frozenset(), grads=None,
           keep_all: bool = False) -> tuple:
    """Closed-loop steps until `seconds` have passed and every judged step
    has run (or `max_steps`): the per-step records, the window's length,
    the judged steps' answers and (with `keep_all`) every step's kept
    choices."""
    trainer, loader = st["trainer"], st["loader"]
    tracing = s1._program_tracing()
    records, answers, kept_all = [], {}, []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        take = i in judged
        before = dict(s1._state(st), stats=_stats(st)) if take else None
        it = trainer.iter
        if grads is not None:
            grads.armed = take
        t0 = time.perf_counter()
        keep = take or keep_all
        with (tracing.keeping() if keep else contextlib.nullcontext()) as kept:
            rec = trainer.train(it + 1)[0]
        t1 = time.perf_counter()
        n = int(st["pool"][loader.last]["images"].shape[0])
        records.append({"wall": t1 - t0, "frames": n, "sent": n, "batch": loader.last})
        if take:
            answers[i] = {"before": before, "after": dict(s1._state(st), stats=_stats(st)),
                          "grads": grads.grads, "kept": kept, "losses": rec, "it": it,
                          "batch": loader.last}
        if keep_all:
            kept_all.append(kept)
        i += 1
        if (t1 >= deadline and i > max(judged, default=-1)) or (
                max_steps is not None and i >= max_steps):
            break
    if grads is not None:
        grads.armed = False
    return records, time.perf_counter() - t_start, answers, kept_all


def run(ctx) -> dict:
    """One run of the cell; returns the record the metric readers read and
    the judged numbers."""
    tracing = s1._program_tracing()
    dev = ctx.device
    wl = ctx.workload
    out_dir = tempfile.mkdtemp(prefix="portbench_train_s3_")
    try:
        st = s1.build(ctx, out_dir)
        trainer = st["trainer"]
        grads = s1._Grads(st["named"])
        hook = trainer.optimizer.register_step_pre_hook(grads)
        with tracing.keeping() as kept:
            trainer.train(1)
        missing = [k for k in KEPT if k not in kept]
        if missing:
            raise RuntimeError(f"the program does not keep {missing} of a step "
                               "(tracing.keep): this cell cannot judge it")
        del kept
        trainer.train(wl["warmup_calls"])
        s1._sync(dev)
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        setup_s = time.perf_counter() - ctx.t0

        judged = set(sampled_calls(ctx.seed, wl["sample_calls"], wl["judge_calls"]))
        records, window_s, answers, _ = _steps(st, ctx.seconds, None, judged, grads)
        record = {"setup_s": setup_s, "window_s": window_s, "calls": records,
                  "frames_done": sum(r["frames"] for r in records),
                  "frames_sent": sum(r["sent"] for r in records),
                  "config": ctx.config["config"], "device": dev.type,
                  "memory_peak_bytes": peak}
        if ctx.trace:
            with tracing.recording() as rec:
                _, _, _, kept_rec = _steps(st, math.inf, wl["trace_calls"], keep_all=True)
            record["program"] = rec.summary()
            record["program"]["head_fg_rows"] = sum(
                int(k["train.rois"]["rois"].is_fg.sum()) for k in kept_rec)
            del kept_rec
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                              else [])
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(pbtracing.PREFIX + "window"):
                    traced, _, _, kept_all = _steps(st, math.inf, wl["trace_calls"],
                                                    keep_all=True)
                    s1._sync(dev)
            pools = [{"boxes": k["train.rois"]["rois"].boxes.cpu().numpy(),
                      "valid": k["train.rois"]["rois"].is_sampled.cpu().numpy()}
                     for k in kept_all]
            record["trace"] = reduce_trace(prof, pools, ctx.config["config"])
            record["trace"]["calls"] = traced
            del prof, kept_all
        hook.remove()
        if answers:
            rois = [a["kept"]["train.rois"]["rois"] for a in answers.values()]
            record["rois_per_step"] = float(np.mean([int(r.is_sampled.sum()) for r in rois]))
            record["fg_rois_per_step"] = float(np.mean([int(r.is_fg.sum()) for r in rois]))
        del trainer, st["trainer"], st["named"], grads
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        readings, tally = judge_answers(ctx, st, answers)
        tally["seconds judging"] = f"{time.perf_counter() - t:.1f}"
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    tally.update(s1.counts(record))
    tally["foreground ROIs per step (judged steps)"] = record.get("fg_rois_per_step")
    return {"record": record, "readings": readings, "attempted": record["frames_sent"],
            "failed": record["frames_sent"] - record["frames_done"], "counts": tally}


def choices_of(kept: dict) -> dict:
    """A step's kept choices as plain dicts of tensors, with the program's
    plane predictions as (B, S, 3)."""
    rois = kept["train.rois"]["rois"]._asdict()
    return {"proposals": dict(kept["train.rois"]["proposals"]), "rois": rois,
            "pred": {"plane": kept["train.planes"]["pred"].reshape(*rois["is_fg"].shape, 3),
                     "depth": kept["train.depth"]["pred"]}}


def answer_of(a: dict) -> dict:
    return {"choices": choices_of(a["kept"]),
            "mask_targets": a["kept"]["train.mask_targets"]["targets"],
            "losses": a["losses"], "grads": a["grads"],
            "after": a["after"]["params"], "bufs_after": a["after"]["bufs"],
            "stats_after": a["after"]["stats"]}


def judge_answers(ctx, st: dict, answers: dict):
    """The worst readings over the judged steps, and counts of their
    choices."""
    cfg = ctx.config["config"]
    readings, fg, sampled = [], [], []
    for i in sorted(answers):
        a = answers[i]
        sd = dict(st["sd"])
        sd.update(a["before"]["params"])
        sd.update(a["before"]["stats"])
        readings.append(judge_train_s3.judge_step(sd, a["before"]["bufs"],
                                                  st["pool"][a["batch"]], answer_of(a), cfg,
                                                  a["it"]))
        rois = choices_of(a["kept"])["rois"]
        fg += rois["is_fg"].sum(1).tolist()
        sampled += rois["is_sampled"].sum(1).tolist()
    span = lambda xs: f"mean {np.mean(xs):.2f} min {min(xs)} max {max(xs)}" if xs else "none"
    return judge_train_s3.worst(readings), {
        "fg ROIs per image (judged steps)": span(fg),
        "sampled ROIs per image (judged steps)": span(sampled), "steps judged": len(readings)}


def kernel_us_by_span(events, names) -> Dict[str, float]:
    """Device time of the kernels launched, from any thread, while each of
    the program's "a3d.<name>" ranges was open (autograd runs a CUDA
    backward in its own threads)."""
    cpu = torch.autograd.DeviceType.CPU
    out = {}
    for name in names:
        ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                        if e.device_type == cpu and e.name == "a3d." + name)
        inside = lambda t: any(a <= t <= b for a, b in ranges)
        out[name] = {"n": len(ranges),
                     "kernel_us": sum(k.duration for e in events if e.device_type == cpu
                                      and e.kernels and inside(e.time_range.start)
                                      for k in e.kernels)}
    return out


def reduce_trace(prof, pools: List[dict], config: dict) -> dict:
    """Busy time, device ops by name, the device time of the kernels inside
    the program's head, target, depth and backward spans, idle time by the
    innermost "a3d." range, and the inputs of each traced step's three K1
    calls (the box, mask and plane pools)."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    busy_us, by_name, n_ops, merged = pbtracing.device_time(events)
    window = [e for e in events if e.name == pbtracing.PREFIX + "window"
              and e.device_type == cpu]
    if window:
        w = (window[0].time_range.start, window[0].time_range.end)
    else:
        w = (merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    m = config["model"]
    k1 = []
    for p in pools:
        for head, aligned in (("box_head", True), ("mask_head", False), ("plane_head", False)):
            k1.append(dict(p, p=m[head]["pooler_resolution"],
                           ratio=m[head]["pooler_sampling_ratio"], aligned=aligned))
    return {"busy_s": busy_us * 1e-6, "window_s": (w[1] - w[0]) * 1e-6,
            "device_ops_us": by_name, "device_op_count": n_ops,
            "idle_gaps_us": program_trace.idle_by_span(events, merged, w, "a3d."),
            "spans": kernel_us_by_span(events, SPANS), "pools": k1}
