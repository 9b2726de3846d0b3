#!/usr/bin/env python3
"""The program's own spans and counters on a cell of the benchmark
(`articulation3d_tpu_torch/tracing.py`), in two windows after the cell's
warm-up (`run.py`'s allocator setting, then `drivers/video_infer.py::build`):

    python3 portbench/program_trace.py --workload infer_stream_b1 --seed 12345 --calls 64

1. recorder: 2 x `--calls` calls, every other one under
   `tracing.recording()`, no profiler: per recorded call, each span's
   count, wall and self time, and the counters; the layer numbers the
   program's spans give (`layer_numbers`); the walls of the recorded calls
   and of the others (the recorder's cost); then one more call with
   `torch.cuda.set_sync_debug_mode("warn")` on, whose synchronizing calls
   are set beside that call's "sync.*" counters;
2. profiler: `--calls` calls under `torch.profiler` and the recorder, so
   the program's "a3d.*" ranges sit in the device trace: device idle time
   and device operations (kernels and copies) by the innermost "a3d.*"
   range the host was in, per call, and the share of idle time outside
   every range (the loop between calls).

Standard error gets the numbers per call; the last line of standard output
is one JSON object.  The frames, weights, model and pipeline are built
exactly as in a benchmark run of the cell, and nothing is judged.  It
needs a CUDA device (exit 2 without one).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
import traceback
import warnings
from typing import Dict, List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = "program_trace.window"        # the profiler window's own range

# the layer numbers of the recorder window: name -> the spans whose wall
# per call it sums ("sync.*" counters for host_syncs)
LAYERS = {
    "sync_wait_ms": ("sync",),
    "rpn_host_ms": ("model.rpn",),
    "roi_heads_host_ms": ("model.roi_heads",),
    "step_post_ms": ("step.paste", "step.override", "step.pack"),
    "unpack_ms": ("pipeline.unpack",),
}


def per_call(summary: dict, calls: int) -> dict:
    """A recorder's `summary()` over `calls` calls, per call (ms)."""
    n = max(calls, 1)
    return {"calls": calls,
            "spans": {k: {"n": v["n"] / n, "wall_ms": v["wall_s"] * 1e3 / n,
                          "self_ms": v["self_s"] * 1e3 / n}
                      for k, v in sorted(summary["spans"].items())},
            "counters": {k: v / n for k, v in sorted(summary["counters"].items())}}


def layer_numbers(program: dict) -> Dict[str, float]:
    """host_syncs (the "sync.*" counters per call) and the LAYERS walls
    per call, from `per_call`'s output."""
    out = {"host_syncs": sum(v for k, v in program["counters"].items()
                             if k.startswith("sync."))}
    for name, spans in LAYERS.items():
        out[name] = sum(program["spans"].get(s, {}).get("wall_ms", 0.0) for s in spans)
    return out


def timed_calls(pipeline, calls, n: int) -> List[float]:
    """`n` closed-loop calls; their walls (s)."""
    walls = []
    for _ in range(n):
        frames = next(calls)[2]
        t0 = time.perf_counter()
        pipeline.run(frames)
        walls.append(time.perf_counter() - t0)
    return walls


def merge(summaries: List[dict]) -> dict:
    """The sum of recorders' `summary()`s."""
    out = {"calls": 0, "spans": {}, "counters": {}}
    for s in summaries:
        out["calls"] += s["calls"]
        for k, v in s["spans"].items():
            m = out["spans"].setdefault(k, {"n": 0, "wall_s": 0.0, "self_s": 0.0})
            for f in m:
                m[f] += v[f]
        for k, v in s["counters"].items():
            out["counters"][k] = out["counters"].get(k, 0) + v
    return out


def recorder_window(pipeline, calls, n: int) -> dict:
    """2 `n` calls, every other one under `tracing.recording()`, so that
    host drift falls on both halves alike: `per_call` of the recorded
    calls' summary, the layer numbers, and the walls (s) of the recorded
    calls (`walls_s`) and of the others (`off_walls_s`)."""
    from articulation3d_tpu_torch import tracing
    off, on, summaries = [], [], []
    for _ in range(n):
        off += timed_calls(pipeline, calls, 1)
        with tracing.recording() as rec:
            on += timed_calls(pipeline, calls, 1)
        summaries.append(rec.summary())
    total = merge(summaries)
    program = per_call(total, total["calls"])
    program["layers"] = layer_numbers(program)
    program["walls_s"], program["off_walls_s"] = on, off
    return program


def _site(depth: int = 3) -> str:
    """The innermost `depth` frames of the caller's stack in the program or
    the harness, as "file:line:function" from the innermost out."""
    frames = [f for f in traceback.extract_stack()
              if "articulation3d_tpu_torch" in f.filename or "portbench" in f.filename]
    return " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}:{f.name}"
                       for f in reversed(frames[-depth:]))


def off_cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host nanoseconds per `with tracing.span(...)` and per
    `tracing.count(...)` with no recorder on and no profiler running (call
    it so), less the bare loop."""
    from articulation3d_tpu_torch import tracing
    best = lambda f: min(f() for _ in range(5))

    def loop():
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return time.perf_counter_ns() - t

    def spans():
        t = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("x"):
                pass
        return time.perf_counter_ns() - t

    def counts():
        t = time.perf_counter_ns()
        for _ in range(n):
            tracing.count("x")
        return time.perf_counter_ns() - t

    base = best(loop)
    return {"span_ns": (best(spans) - base) / n, "count_ns": (best(counts) - base) / n}


def sync_audit(pipeline, frames) -> dict:
    """One call on `frames` under the recorder with CUDA's sync debug mode at "warn":
    the synchronizing calls it reports inside the call, the call's "sync.*"
    counters, where each reported call that no counter had counted was made
    (the counters count before the wait, so a warning that finds no new
    count is an uncounted one), and the warnings outside the call (setting
    the mode gives one the first time)."""
    import torch

    from articulation3d_tpu_torch import tracing
    tally = {"in_call": False, "warned": 0, "matched": 0}
    uncounted, outside = [], []

    def seen(message, *a, **k):
        if "synchroniz" not in str(message):
            return
        if not tally["in_call"]:
            outside.append(str(message)[:200])
            return
        tally["warned"] += 1
        counted = sum(v for key, v in rec.counters.items() if key.startswith("sync."))
        if counted > tally["matched"]:
            tally["matched"] += 1
        else:
            uncounted.append(_site())

    with warnings.catch_warnings():         # restores showwarning on exit
        warnings.simplefilter("always")
        warnings.showwarning = seen
        with tracing.recording() as rec:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tally["in_call"] = True
                pipeline.run(frames)
            finally:
                tally["in_call"] = False
                torch.cuda.set_sync_debug_mode(0)
    syncs = {k: v for k, v in rec.counters.items() if k.startswith("sync.")}
    return {"sync_debug_warnings": tally["warned"], "host_syncs": sum(syncs.values()),
            "by_site": syncs, "uncounted": uncounted, "outside_the_call": outside}


def _innermost(events, prefix: str) -> Tuple[List[float], List[str]]:
    """Starts and labels of the segments of the innermost `prefix` range on
    the host over time ("" where none), from a profile's CPU events."""
    import torch
    marks = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(prefix):
            name = e.name[len(prefix):]
            marks.append((e.time_range.start, 1, e.id, name))
            marks.append((e.time_range.end, 0, e.id, name))
    marks.sort(key=lambda m: (m[0], m[1]))
    starts, labels, stack = [], [], []
    for t, opening, eid, name in marks:
        if opening:
            stack.append((eid, name))
        else:
            stack = [s for s in stack if s[0] != eid]
        starts.append(t)
        labels.append(stack[-1][1] if stack else "")
    return starts, labels


def idle_by_span(events, busy: List[Tuple[float, float]], window: Tuple[float, float],
                 prefix: str) -> Dict[str, float]:
    """Device idle time (us) inside `window`, split over time by the
    innermost `prefix` range the host was in ("" for none)."""
    starts, labels = _innermost(events, prefix)
    out: Dict[str, float] = {}

    def add(lo: float, hi: float) -> None:
        k = bisect.bisect_right(starts, lo) - 1
        while lo < hi:
            nxt = starts[k + 1] if k + 1 < len(starts) else hi
            seg_hi = min(hi, nxt)
            if seg_hi > lo:
                label = labels[k] if k >= 0 else ""
                out[label] = out.get(label, 0.0) + (seg_hi - lo)
            lo = seg_hi
            k += 1

    t = window[0]
    for a, b in list(busy) + [(window[1], window[1])]:
        lo, hi = max(t, window[0]), min(a, window[1])
        if hi > lo:
            add(lo, hi)
        t = max(t, b)
    return out


def ops_by_span(events, prefix: str) -> Dict[str, int]:
    """Device operations (kernels and copies) by the innermost `prefix`
    range whose host code launched them ("" for none)."""
    import torch
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    out: Dict[str, int] = {}

    def walk(e, label: str) -> None:
        if e.name.startswith(prefix):
            label = e.name[len(prefix):]
        n = len(e.kernels)
        if n:
            out[label] = out.get(label, 0) + n
        for c in e.cpu_children:
            walk(c, label)

    for e in cpu:
        if e.cpu_parent is None:
            walk(e, "")
    return out


def profiler_window(pipeline, calls, n: int, device) -> dict:
    """`n` calls under `torch.profiler` and the recorder: device busy and
    idle time, idle time and device operations by innermost "a3d.*" range,
    per call, and the calls' walls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from articulation3d_tpu_torch import tracing
    from portbench import tracing as pbtracing
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tracing.recording() as rec, profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            walls = timed_calls(pipeline, calls, n)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events = prof.events()
    busy_us, _, n_ops, merged = pbtracing.device_time(events)
    win = [e for e in events if e.name == WINDOW
           and e.device_type == torch.autograd.DeviceType.CPU]
    w = (win[0].time_range.start, win[0].time_range.end)
    idle = idle_by_span(events, merged, w, tracing.PREFIX)
    ops = ops_by_span(events, tracing.PREFIX)
    idle_us = sum(idle.values())
    per = lambda d, scale: {k or "(none)": v * scale / n
                            for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    return {"calls": n, "window_ms": (w[1] - w[0]) * 1e-3 / n, "busy_ms": busy_us * 1e-3 / n,
            "idle_ms": idle_us * 1e-3 / n, "device_ops": n_ops / n,
            "idle_outside_spans_share": idle.get("", 0.0) / idle_us if idle_us else None,
            "idle_ms_by_span": per(idle, 1e-3), "device_ops_by_span": per(ops, 1.0),
            "walls_s": walls, "recorded_calls": rec.calls}


def run(ctx, calls_per_window: int) -> dict:
    """Both windows and the sync audit on a cell (`spec.Context`), after
    its warm-up."""
    import torch

    from portbench.drivers import video_infer

    st = video_infer.build(ctx)
    pipeline = st["pipeline"]
    calls = st["traffic"].batches(st["pool"], ctx.traffic["batch"])
    for _ in range(ctx.workload["warmup_calls"]):
        pipeline.run(next(calls)[2])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    out = {"off_cost_ns": off_cost_ns()}
    out["program"] = recorder_window(pipeline, calls, calls_per_window)
    if ctx.device.type == "cuda":
        out["sync_audit"] = sync_audit(pipeline, next(calls)[2])
    out["profiled"] = profiler_window(pipeline, calls, calls_per_window, ctx.device)
    out["cell"] = ctx.cell["name"]
    out["seed"] = ctx.seed
    return out


def report(out: dict) -> List[str]:
    """The lines printed on standard error."""
    mean = lambda xs: 1e3 * sum(xs) / len(xs) if xs else float("nan")
    prog, prof = out["program"], out["profiled"]
    lines = [f"# off cost: {out['off_cost_ns']['span_ns']:.1f} ns a span, "
             f"{out['off_cost_ns']['count_ns']:.1f} ns a count",
             f"# call wall, ms: nothing on {mean(prog['off_walls_s']):.3f}, recorder "
             f"{mean(prog['walls_s']):.3f} (alternate calls); recorder and profiler "
             f"{mean(prof['walls_s']):.3f}"]
    lines += [f"# layer {k}: {v:.4f}" for k, v in prog["layers"].items()]
    lines += [f"# span {k}: n {v['n']:.2f} wall {v['wall_ms']:.3f} ms self {v['self_ms']:.3f} ms"
              for k, v in prog["spans"].items()]
    lines += [f"# counter {k}: {v:.2f}" for k, v in prog["counters"].items()]
    if "sync_audit" in out:
        a = out["sync_audit"]
        lines.append(f"# one call: sync debug mode warnings {a['sync_debug_warnings']}, "
                     f"host_syncs {a['host_syncs']} {a['by_site']}; uncounted at "
                     f"{a['uncounted']}; outside the call {a['outside_the_call']}")
    lines.append(f"# profiler window per call: {prof['window_ms']:.3f} ms, busy "
                 f"{prof['busy_ms']:.3f}, idle {prof['idle_ms']:.3f}, device ops "
                 f"{prof['device_ops']:.1f}; idle outside every a3d range "
                 f"{prof['idle_outside_spans_share']}")
    lines += [f"# idle by span {k}: {v:.3f} ms" for k, v in prof["idle_ms_by_span"].items()]
    lines += [f"# device ops by span {k}: {v:.2f}" for k, v in prof["device_ops_by_span"].items()]
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=64)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import steady_allocator
    allocator = steady_allocator()          # as the benchmark's runs have it
    import torch

    from portbench import spec
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    bench = spec.benchmark()
    ctx = spec.context(bench, args.workload, args.seed, 0.0, True, torch.device("cuda", 0),
                       time.perf_counter())
    out = run(ctx, args.calls)
    out["steady_allocator"] = allocator
    for line in report(out):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
