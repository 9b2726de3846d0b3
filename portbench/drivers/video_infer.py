"""Driver of the video-inference cells: one closed-loop client calling
`VideoPipeline.run` on successive batches of frames.

Set-up: the frame pool and the weights from the seed on the device, the
depth BatchNorm statistics from the first frames (plain reference), the
model and the pipeline, then `warmup_calls` calls.  The window: calls until
`--seconds` have passed.  With `--trace 1`, `trace_calls` more calls follow
under `torch.profiler`, with spans on the model's modules; the metrics of
host time (frames per second, host post-processing, MFU) still read the
untraced window, since the profiler stretches every call.  After the
window: the program is freed and the answers of `judge_calls` calls drawn
from the seed among the first `sample_calls` are judged against the plain
reference (`reference/judge.py`).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import judge as judge_mod
from ..reference import planercnn as ref
from .. import spec, tracing
from .. import weights as pbweights

SPAN_MODULES = ("backbone", "proposal_generator", "depth_head")
HEAD_MODULES = ("box_head", "mask_head", "plane_head", "axis_head")


def _program_config(config: dict):
    from articulation3d_tpu_torch.config import load_config
    return load_config(None, config["config"])


def sampled_calls(seed: int, sample_calls: int, judge_calls: int) -> List[int]:
    rs = np.random.RandomState(int(seed) % (1 << 32))
    return sorted(rs.choice(sample_calls, size=min(judge_calls, sample_calls),
                            replace=False).tolist())


def build(ctx) -> dict:
    """Frames, weights, model and pipeline of the cell (set-up, before the
    warm-up)."""
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    from articulation3d_tpu_torch.weights import load_d2_state_dict

    dev = ctx.device
    traffic = ctx.traffic
    frames_mod = spec.load_module("traffic", traffic["generator"])
    pool_dev = frames_mod.make_pool(traffic, ctx.seed, dev)
    sd = pbweights.draw_for(ctx.config, ctx.seed, dev)
    stats = pbweights.calibrate(sd, pool_dev[:traffic["calibration"]], ctx.config)
    stats = {k: v.cpu() for k, v in stats.items()}
    pool = pool_dev.cpu().numpy()
    del pool_dev
    cfg = _program_config(ctx.config)
    with torch.device(dev):
        model = PlaneRCNN(cfg)
    load_d2_state_dict(model, sd)
    del sd
    model.eval()
    pipeline = VideoPipeline(cfg, model, batch_size=traffic["batch"], device=dev)
    return {"pool": pool, "stats": stats, "cfg": cfg, "model": model, "pipeline": pipeline,
            "traffic": frames_mod}


def _calls(pipeline, calls, seconds: float, max_calls, span, capture: dict, keep) -> tuple:
    """Closed-loop calls until `seconds` have passed (or `max_calls` calls):
    per-call records, the window's length, valid ROIs per pool, and
    {call: (frame indices, FramePredictions, depths)} of the calls `keep`
    selects (their proposals go to capture["out"] by the hook)."""
    records, answers, pool_valid = [], {}, {}
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        i, idx, frames = next(calls)
        capture["slot"] = i if keep(i) else None
        t0 = time.perf_counter()
        with span("call"):
            preds = pipeline.run(frames)
        t1 = time.perf_counter()
        records.append({"wall": t1 - t0, "chunk": sum(pipeline.chunk_walls),
                        "frames": len(preds), "sent": len(frames),
                        "dets": [len(p.scores) for p in preds]})
        for k, v in pipeline.pool_valid.items():
            pool_valid[k] = pool_valid.get(k, 0) + v
        if keep(i):
            answers[i] = (idx, preds, list(pipeline.depths))
        if t1 >= deadline or (max_calls is not None and len(records) >= max_calls):
            break
    capture["slot"] = None
    return records, time.perf_counter() - t_start, pool_valid, answers


def run(ctx) -> dict:
    """One run of the cell; returns the record the metric readers read and
    the judged numbers.  The window runs untraced; with `--trace 1` a
    second, traced window of `trace_calls` calls follows it."""
    dev = ctx.device
    wl = ctx.workload
    batch = ctx.traffic["batch"]
    st = build(ctx)
    pipeline, model = st["pipeline"], st["model"]
    judged = set(sampled_calls(ctx.seed, wl["sample_calls"], wl["judge_calls"]))
    frames_mod = st["traffic"]

    capture = {"slot": None, "out": {}}

    def keep_proposals(_m, _args, out):
        if capture["slot"] is not None:
            capture["out"][capture["slot"]] = {k: v.detach().cpu() for k, v in out.items()}

    hook = model.proposal_generator.register_forward_hook(keep_proposals)
    calls = frames_mod.batches(st["pool"], batch)
    for _ in range(wl["warmup_calls"]):
        pipeline.run(next(calls)[2])
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t0

    plain = lambda n: contextlib.nullcontext()
    calls = frames_mod.batches(st["pool"], batch)
    records, window_s, pool_valid, answers = _calls(
        pipeline, calls, ctx.seconds, None, plain, capture, lambda i: i in judged)
    _sync(dev)
    props = dict(capture["out"])
    record = {"setup_s": setup_s, "window_s": window_s, "calls": records,
              "frames_done": sum(r["frames"] for r in records),
              "frames_sent": sum(r["sent"] for r in records),
              "pool_valid": pool_valid, "batch": batch, "config": ctx.config["config"],
              "device": dev.type}

    prof = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile
        mods = {n: getattr(model, n) for n in SPAN_MODULES if hasattr(model, n)}
        mods.update({n: getattr(model.roi_heads, n) for n in HEAD_MODULES
                     if hasattr(model.roi_heads, n)})
        handles = tracing.span_hooks(mods)
        capture["out"] = {}
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        span = lambda n: torch.profiler.record_function(tracing.PREFIX + n)
        with profile(activities=acts) as prof:
            with span("window"):
                traced, traced_s, _, traced_answers = _calls(
                    pipeline, calls, math.inf, wl["trace_calls"], span, capture, lambda i: True)
                _sync(dev)
        for h in handles:
            h.remove()
        det_boxes = [[p.boxes for p in traced_answers[i][1]] for i in sorted(traced_answers)]
        traced_props = [capture["out"].get(i) for i in sorted(traced_answers)]
        del traced_answers
    record["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else 0)
    hook.remove()
    del capture, pipeline, model, st["pipeline"], st["model"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    if prof is not None:
        record["trace"] = reduce_trace(prof, det_boxes, traced_props, ctx.config["config"])
        record["trace"]["calls"] = traced
        del prof
    t_trace = time.perf_counter() - t
    t = time.perf_counter()
    readings = judge_answers(ctx, st, answers, props)
    tally = counts(record, props, len(answers))
    tally["seconds reading the trace, judging"] = f"{t_trace:.1f}, {time.perf_counter() - t:.1f}"
    return {"record": record, "readings": readings,
            "attempted": record["frames_sent"],
            "failed": record["frames_sent"] - record["frames_done"], "counts": tally}


def counts(record: dict, props: dict, judged_calls: int) -> dict:
    """Sample counts, detections per frame, valid ROIs per pool and frame,
    and RPN survivors (valid proposals) per frame of the captured calls."""
    dets = [n for c in record["calls"] for n in c["dets"]]
    frames = max(record["frames_done"], 1)
    surv = [int(v) for p in props.values() for v in p["valid"].sum(dim=1).tolist()]
    span = lambda xs: f"mean {np.mean(xs):.2f} min {min(xs)} max {max(xs)}" if xs else "none"
    calls = record["calls"]
    mean = lambda xs: f"{1e3 * sum(xs) / len(xs):.1f}" if xs else "none"
    half = len(calls) // 2
    rate = lambda cs: f"{sum(c['frames'] for c in cs) / max(sum(c['wall'] for c in cs), 1e-9):.2f}"
    return {"calls in the window": len(calls),
            "ms per call: wall, step and readback, after": ", ".join(
                mean(v) for v in ([c["wall"] for c in calls], [c["chunk"] for c in calls],
                                  [c["wall"] - c["chunk"] for c in calls])),
            "frames/s in the window's first and second half of calls": (
                f"{rate(calls[:half])}, {rate(calls[half:])}"),
            "calls judged": judged_calls,
            **({"ms per call traced, untraced (the profiler's stretch)": ", ".join(
                mean(v) for v in ([c["wall"] for c in record["trace"]["calls"]],
                                  [c["wall"] for c in calls]))} if "trace" in record else {}),
            "detections per frame": span(dets),
            "valid ROIs per frame by pool": {k: round(v / frames, 2)
                                             for k, v in record["pool_valid"].items()},
            "RPN survivors per frame (captured calls)": span(surv)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reduce_trace(prof, det_boxes, props: list, config: dict) -> dict:
    """Busy time, device ops by name, spans, idle gaps and the K1 calls'
    inputs of the traced window (`det_boxes` and `props`: each traced
    call's detection boxes per frame and captured proposals)."""
    events = prof.events()
    busy_us, by_name, n_ops, merged = tracing.device_time(events)
    window = [e for e in events if e.name == tracing.PREFIX + "window"
              and e.device_type == torch.autograd.DeviceType.CPU]
    if window:
        w = (window[0].time_range.start, window[0].time_range.end)
    else:
        w = (merged[0][0], merged[-1][1]) if merged else (0.0, 0.0)
    gaps = tracing.idle_gaps(events, merged, w, "call")
    heads = config["model"]
    k1 = []
    for boxes, p in zip(det_boxes, props):
        if p is not None:
            k1.append({"pool": "box", "boxes": p["boxes"].numpy(), "valid": p["valid"].numpy(),
                       "p": heads["box_head"]["pooler_resolution"],
                       "ratio": heads["box_head"]["pooler_sampling_ratio"], "aligned": True})
        d = heads["roi_heads"]["detections_per_image"]
        b = np.zeros((len(boxes), d, 4), np.float32)
        v = np.zeros((len(boxes), d), bool)
        for j, bx in enumerate(boxes):
            b[j, :len(bx)] = bx
            v[j, :len(bx)] = True
        for name in ("mask_head", "plane_head"):
            k1.append({"pool": name, "boxes": b, "valid": v,
                       "p": heads[name]["pooler_resolution"],
                       "ratio": heads[name]["pooler_sampling_ratio"], "aligned": False})
    return {"busy_s": busy_us * 1e-6, "window_s": (w[1] - w[0]) * 1e-6,
            "device_ops_us": by_name, "device_op_count": n_ops,
            "spans": tracing.span_stats(events), "idle_gaps_us": gaps, "k1_calls": k1}


def judge_answers(ctx, st: dict, answers: dict, props: dict) -> Dict[str, float]:
    """The worst readings over the judged frames (empty if none was judged)."""
    dev = ctx.device
    sd = pbweights.draw_for(ctx.config, ctx.seed, dev)
    sd.update({k: v.to(dev) for k, v in st["stats"].items()})
    net = ref.Net(sd)
    cfg = ctx.config["config"]
    readings = []
    with ref.exact_float32():
        for i in sorted(answers):
            if i not in props:
                continue
            idx, preds, depths = answers[i]
            for j, (frame_i, pred) in enumerate(zip(idx, preds)):
                frame = torch.from_numpy(st["pool"][frame_i]).to(dev)
                answer = answer_tensors(pred, depths[j], props[i], j, dev)
                readings.append(judge_mod.judge_frame(net, frame, answer, cfg))
    return judge_mod.worst(readings)


def answer_tensors(pred, depth, props: dict, j: int, dev) -> Dict[str, torch.Tensor]:
    """One frame's FramePrediction, depth and proposals as device tensors."""
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    return {"boxes": t(pred.boxes).to(torch.float32), "scores": t(pred.scores).to(torch.float32),
            "classes": t(pred.classes), "masks": t(pred.masks).to(torch.bool),
            "planes": t(pred.planes).to(torch.float32),
            "rot_axis": t(pred.rot_axis).to(torch.float32),
            "tran_axis": t(pred.tran_axis).to(torch.float32),
            "depth": t(depth).to(torch.float32),
            "proposals": {"boxes": props["boxes"][j].to(dev).to(torch.float32),
                          "logits": props["scores"][j].to(dev).to(torch.float32),
                          "valid": props["valid"][j].to(dev)}}
