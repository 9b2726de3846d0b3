"""Driver of the stage-1 training cells: the program's own training loop,
`Trainer.train`, one step at a time on a pool of batches made on the card.

Set-up: the batch pool and the weights from the seed on the device (the
trunk's frozen BatchNorm variances set from the first `calibration`
images, `calibrate_trunk`), the `Trainer` of the configuration
(`load_config` of the configuration file's `config`, the output directory
a temporary one) with a loader that cycles the pool, the weights loaded
into its model (`warm_start`), then `warmup_calls` steps.  The window: steps until `--seconds` have passed,
each `Trainer.train(iter + 1)`, which returns after reading the step's
losses back (closed loop).  The judged steps are `judge_calls` steps drawn
from the seed among the window's first `sample_calls`: for each, the
trained parameters and momentum buffers are copied on the device before
it, its gradients before the update (an optimizer step pre-hook) and the
parameters and buffers after it, and its discrete choices are read through
`tracing.keeping()`.  With `--trace 1`, `trace_calls` more steps run under
the program's recorder (`tracing.recording()`, no profiler: its spans and
counters), then `trace_calls` under `torch.profiler`.  After the windows
the judged steps are held against the plain reference
(`reference/judge_train.py`).

The program must expose a step's choices (`tracing.keeping`); a program
without it fails at once, before any set-up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import judge_train
from ..reference import planercnn as ref
from .. import spec, tracing as pbtracing
from .. import weights as pbweights
from .video_infer import sampled_calls


def _program_tracing():
    from articulation3d_tpu_torch import tracing
    if not hasattr(tracing, "keeping"):
        raise RuntimeError("the program does not expose a training step's choices "
                           "(articulation3d_tpu_torch.tracing.keeping): this cell cannot judge it")
    return tracing


def program_config(config: dict, output_dir: str):
    from articulation3d_tpu_torch.config import load_config
    return dataclasses.replace(load_config(None, config["config"]), output_dir=output_dir)


def draw_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weight rules (`weights.draw_for`), with the box
    predictor drawn afresh as detectron2 initialises one (normal with the
    configuration's `box_predictor_std`, zero biases), from a second
    stream of the seed."""
    sd = pbweights.draw_for(config, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 29) % (1 << 63))
    for name, std in zip(("cls_score", "bbox_pred"), config["weights"]["box_predictor_std"]):
        key = f"roi_heads.box_predictor.{name}"
        w = sd[f"{key}.weight"]
        sd[f"{key}.weight"] = torch.randn(w.shape, generator=gen, device=device) * std
        sd[f"{key}.bias"] = torch.zeros_like(sd[f"{key}.bias"])
    return sd


class _Calibrating(ref.Net):
    """The plain reference's trunk that sets each frozen BatchNorm's
    variance, as it goes, to its input's mean square over the layer (every
    channel alike), and keeps the drawn means.  The mean of each channel is
    not subtracted: at random weights a channel's mean is several times its
    spread, and a BatchNorm that removed it would leave bfloat16 the
    difference of two large numbers at every layer."""

    def conv_norm(self, x, key, stride=1):
        y = self.conv(x, key, stride=stride, bias=False)
        var = self.sd[f"{key}.norm.running_var"]
        self.sd[f"{key}.norm.running_var"] = y.square().mean().expand_as(var).clone()
        return self.frozen_bn(y, f"{key}.norm")


@torch.no_grad()
def calibrate_trunk(sd: Dict[str, torch.Tensor], images: torch.Tensor, config: dict) -> None:
    """Set, in `sd`, the variance of every frozen BatchNorm of the trunk from
    its input on uint8 `images` (B, H, W, 3) under the plain float32
    reference, layer by layer (`_Calibrating`): each then brings its input
    to about unit root mean square, as a trained trunk's keep their
    activations of order one (the drawn statistics let them grow to the
    hundreds through the 53 layers, and the RPN's deltas diverge within
    steps)."""
    inp = config["config"]["input"]
    with ref.exact_float32():
        _Calibrating(sd).backbone(ref.preprocess(images, inp["pixel_mean"], inp["pixel_std"],
                                                 inp["size_divisibility"]))


def build(ctx, output_dir: str) -> dict:
    """The batch pool, weights and Trainer of the cell (set-up, before the
    warm-up)."""
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import warm_start

    dev = ctx.device
    gen_mod = spec.load_module("traffic", ctx.traffic["generator"])
    pool = gen_mod.make_pool(ctx.traffic, ctx.seed, dev)
    sd = draw_weights(ctx.config, ctx.seed, dev)
    calibrate_trunk(sd, pool[0]["images"][:ctx.traffic["calibration"]], ctx.config)
    cfg = program_config(ctx.config, output_dir)
    loader = gen_mod.Cycle(pool)
    trainer = Trainer(cfg, loader=loader, device=dev)
    warm_start(trainer.model, sd)
    own = trainer.model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own}
    named = {k: p for k, p in trainer.model.named_parameters() if p.requires_grad}
    return {"pool": pool, "sd": sd, "cfg": cfg, "trainer": trainer, "loader": loader,
            "named": named}


class _Grads:
    """An optimizer step pre-hook that copies the trained gradients (on the
    device) when armed."""

    def __init__(self, named: Dict[str, torch.nn.Parameter]):
        self.named, self.armed, self.grads = named, False, None

    def __call__(self, *_):
        if self.armed:
            self.grads = {k: p.grad.detach().clone() for k, p in self.named.items()}


def _state(st: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    opt = st["trainer"].optimizer
    return {"params": {k: p.detach().clone() for k, p in st["named"].items()},
            "bufs": {k: opt.state[p]["momentum_buffer"].clone()
                     for k, p in st["named"].items()}}


def _steps(st: dict, seconds: float, max_steps, judged=frozenset(), grads=None,
           keep_all: bool = False) -> tuple:
    """Closed-loop steps until `seconds` have passed and every judged step
    has run (or `max_steps`): the per-step records, the window's length,
    the judged steps' answers and (with `keep_all`) every step's kept
    choices."""
    trainer, loader = st["trainer"], st["loader"]
    tracing = _program_tracing()
    records, answers, kept_all = [], {}, []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        take = i in judged
        before = _state(st) if take else None
        it = trainer.iter
        if grads is not None:
            grads.armed = take
        t0 = time.perf_counter()
        with (tracing.keeping() if take or keep_all else contextlib.nullcontext()) as kept:
            rec = trainer.train(it + 1)[0]
        t1 = time.perf_counter()
        n = int(st["pool"][loader.last]["images"].shape[0])
        records.append({"wall": t1 - t0, "frames": n, "sent": n, "batch": loader.last})
        if take:
            answers[i] = {"before": before, "after": _state(st), "grads": grads.grads,
                          "kept": kept, "losses": rec, "it": it, "batch": loader.last}
        if keep_all:
            kept_all.append(kept)
        i += 1
        if (t1 >= deadline and i > max(judged, default=-1)) or (
                max_steps is not None and i >= max_steps):
            break
    if grads is not None:
        grads.armed = False
    return records, time.perf_counter() - t_start, answers, kept_all


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    """One run of the cell; returns the record the metric readers read and
    the judged numbers."""
    tracing = _program_tracing()
    dev = ctx.device
    wl = ctx.workload
    out_dir = tempfile.mkdtemp(prefix="portbench_train_")
    try:
        st = build(ctx, out_dir)
        trainer = st["trainer"]
        grads = _Grads(st["named"])
        hook = trainer.optimizer.register_step_pre_hook(grads)
        trainer.train(wl["warmup_calls"])
        _sync(dev)
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
                _steps(st, math.inf, wl["trace_calls"])
            summary = rec.summary()
            record["program"] = summary
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                              else [])
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(pbtracing.PREFIX + "window"):
                    traced, _, _, kept_all = _steps(st, math.inf, wl["trace_calls"],
                                                    keep_all=True)
                    _sync(dev)
            pools = [{"boxes": k["train.rois"]["rois"].boxes.cpu().numpy(),
                      "valid": k["train.rois"]["rois"].is_sampled.cpu().numpy()}
                     for k in kept_all]
            record["trace"] = reduce_trace(prof, pools, ctx.config["config"])
            record["trace"]["calls"] = traced
            del prof, kept_all
        hook.remove()
        if answers:
            record["rois_per_step"] = float(np.mean(
                [int(a["kept"]["train.rois"]["rois"].is_sampled.sum()) for a in answers.values()]))
        del trainer, st["trainer"], st["named"], grads
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        readings, tally = judge_answers(ctx, st, answers)
        tally["seconds judging"] = f"{time.perf_counter() - t:.1f}"
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    tally.update(counts(record))
    return {"record": record, "readings": readings, "attempted": record["frames_sent"],
            "failed": record["frames_sent"] - record["frames_done"], "counts": tally}


def choices_of(kept: dict) -> dict:
    """A step's kept choices as plain dicts of tensors."""
    return {"anchors": dict(kept["train.anchors"]),
            "proposals": dict(kept["train.rois"]["proposals"]),
            "rois": kept["train.rois"]["rois"]._asdict()}


def answer_of(a: dict) -> dict:
    return {"choices": choices_of(a["kept"]), "losses": a["losses"], "grads": a["grads"],
            "after": a["after"]["params"], "bufs_after": a["after"]["bufs"]}


def judge_answers(ctx, st: dict, answers: dict):
    """The worst readings over the judged steps, and counts of their
    choices."""
    cfg = ctx.config["config"]
    readings, tally = [], {"fg ROIs per image (judged steps)": [],
                           "positive anchors per image (judged steps)": [],
                           "valid proposals per image (judged steps)": []}
    for i in sorted(answers):
        a = answers[i]
        sd = dict(st["sd"])
        sd.update(a["before"]["params"])
        r = judge_train.judge_step(sd, a["before"]["bufs"], st["pool"][a["batch"]],
                                   answer_of(a), cfg, a["it"])
        readings.append(r)
        ch = choices_of(a["kept"])
        tally["fg ROIs per image (judged steps)"] += ch["rois"]["is_fg"].sum(1).tolist()
        tally["positive anchors per image (judged steps)"] += ch["anchors"]["pos"].sum(1).tolist()
        tally["valid proposals per image (judged steps)"] += \
            ch["proposals"]["valid"].sum(1).tolist()
    span = lambda xs: f"mean {np.mean(xs):.2f} min {min(xs)} max {max(xs)}" if xs else "none"
    return judge_train.worst(readings), {k: span(v) for k, v in tally.items()} | {
        "steps judged": len(readings)}


def counts(record: dict) -> dict:
    calls = record["calls"]
    half = len(calls) // 2
    rate = lambda cs: f"{sum(c['frames'] for c in cs) / max(sum(c['wall'] for c in cs), 1e-9):.2f}"
    mean = lambda xs: f"{1e3 * sum(xs) / len(xs):.2f}" if xs else "none"
    out = {"steps in the window": len(calls),
           "ms per step (wall)": mean([c["wall"] for c in calls]),
           "images/s in the window's first and second half of steps":
               f"{rate(calls[:half])}, {rate(calls[half:])}",
           "sampled ROIs per step (judged steps)": record.get("rois_per_step")}
    if "program" in record:
        prog = record["program"]
        out["host syncs per step by site (recorder)"] = {
            k: v / prog["calls"] for k, v in sorted(prog["counters"].items())
            if k.startswith("sync.")}
    if "trace" in record:
        out["ms per step traced, untraced (the profiler's stretch)"] = ", ".join(
            mean(v) for v in ([c["wall"] for c in record["trace"]["calls"]],
                              [c["wall"] for c in calls]))
    return out


def reduce_trace(prof, pools: List[dict], config: dict) -> dict:
    """Busy time, device ops by name, the device time of the kernels
    launched (from any thread) inside the program's "a3d.train.backward"
    ranges, idle time by the innermost "a3d." range, and the training box
    pool's inputs of each traced step."""
    from .. import program_trace
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    busy_us, by_name, n_ops, merged = pbtracing.device_time(events)
    window = [e for e in events if e.name == pbtracing.PREFIX + "window"
              and e.device_type == cpu]
    if window:
        w = (window[0].time_range.start, window[0].time_range.end)
    else:
        w = (merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    backward = sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == cpu and e.name == "a3d.train.backward")
    inside = lambda t: any(a <= t <= b for a, b in backward)
    bwd_us = sum(k.duration for e in events if e.device_type == cpu and e.kernels
                 and inside(e.time_range.start) for k in e.kernels)
    box = config["model"]["box_head"]
    k1 = [dict(p, p=box["pooler_resolution"], ratio=box["pooler_sampling_ratio"], aligned=True)
          for p in pools]
    return {"busy_s": busy_us * 1e-6, "window_s": (w[1] - w[0]) * 1e-6,
            "device_ops_us": by_name, "device_op_count": n_ops,
            "idle_gaps_us": program_trace.idle_by_span(events, merged, w, "a3d."),
            "backward_kernel_us": bwd_us, "backward_ranges": len(backward), "pools": k1}
