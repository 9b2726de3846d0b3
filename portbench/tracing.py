"""Spans recorded from the benchmark's own files, and the reduction of a
`torch.profiler` trace to busy time, kernel time by name, time inside
spans and idle gaps.

Spans are `record_function` ranges named "pb.<layer>", opened and closed by
forward pre- and post-hooks on the program's modules (and around each call
by the driver), so no program code changes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

PREFIX = "pb."


def span_hooks(modules: Dict[str, torch.nn.Module]) -> list:
    """Open a "pb.<name>" range when each module's forward starts and close
    it when it returns.  Returns the hook handles (call `.remove()`)."""
    handles = []
    for name, mod in modules.items():
        open_ranges: list = []

        def pre(_m, _args, name=name, open_ranges=open_ranges):
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(_m, _args, _out, open_ranges=open_ranges):
            open_ranges.pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    return handles


def _device_events(events) -> list:
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_time(events) -> Tuple[float, Dict[str, float], int, List[Tuple[float, float]]]:
    """(busy us, {device op name: us}, op count, merged busy intervals) of a
    profile's device events.  A copy of `chip_smoke.py::_device_time`
    (1304-1318) that also returns the intervals and leaves out the
    device-side copies of `record_function` ranges."""
    spans, by_name = [], {}
    for e in _device_events(events):
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, -1.0
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
            end = b
    return busy, by_name, len(spans), merged


def _subtree_kernel_us(e) -> float:
    total = sum(k.duration for k in e.kernels)
    return total + sum(_subtree_kernel_us(c) for c in e.cpu_children)


def span_stats(events) -> Dict[str, Dict[str, float]]:
    """{layer: {"n": ranges, "cpu_us": their host wall, "kernel_us": device
    time of the kernels launched inside them}} of the "pb.*" ranges."""
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.name.startswith(PREFIX):
            continue
        s = out.setdefault(e.name[len(PREFIX):], {"n": 0, "cpu_us": 0.0, "kernel_us": 0.0})
        s["n"] += 1
        s["cpu_us"] += e.time_range.end - e.time_range.start
        s["kernel_us"] += _subtree_kernel_us(e)
    return out


def _innermost(events, skip: str) -> Tuple[List[float], List[str]]:
    """Segment starts and labels of the innermost "pb.*" range over time
    (ranges nest or follow each other; `skip` is ignored; "" where none)."""
    marks = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(PREFIX):
            name = e.name[len(PREFIX):]
            if name != skip:
                marks.append((e.time_range.start, 1, name))
                marks.append((e.time_range.end, 0, name))
    marks.sort(key=lambda m: (m[0], m[1]))
    starts, labels, stack = [], [], []
    for t, opening, name in marks:
        if opening:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        starts.append(t)
        labels.append(stack[-1] if stack else "")
    return starts, labels


def idle_gaps(events, busy: List[Tuple[float, float]], window: Tuple[float, float],
              outer: str, skip: str = "window") -> Dict[str, float]:
    """Idle device time inside `window` (us), summed by the innermost
    "pb.*" range the host was in when each gap began ("outside <outer>"
    where it was in none but `skip`)."""
    import bisect
    starts, labels = _innermost(events, skip)
    out: Dict[str, float] = {}
    t = window[0]
    for a, b in list(busy) + [(window[1], window[1])]:
        lo, hi = t, min(a, window[1])
        if hi > lo:
            k = bisect.bisect_right(starts, lo) - 1
            label = (labels[k] if k >= 0 else "") or f"outside {outer}"
            out[label] = out.get(label, 0.0) + (hi - lo)
        t = max(t, b)
    return out
