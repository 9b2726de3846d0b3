"""The timing loop of the stage profilers (`profile_inference`,
`profile_depth`, `profile_train`) and the label of the device they ran on.

A stage is `(name, fn)`, where `fn()` runs the stage once and returns its
outputs.  `time_fn` is JAX's `_time_fn` (`tools/profile_inference.py`):
two warm runs, then the mean wall of `steps` runs, each ending in a host
readback of the float32 sum of every output.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

Stage = Tuple[str, Callable[[], object]]
# (stage name, seconds per run or None, why it has no time)
Row = Tuple[str, Optional[float], str]
# around(name, fn, timed) -> seconds: runs `timed()` (the row's timing) and
# may do more around it; the default runs `timed()` alone
Around = Callable[[str, Callable[[], object], Callable[[], float]], float]


def _leaves(out) -> List[torch.Tensor]:
    if torch.is_tensor(out):
        return [out]
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    elif not isinstance(out, (list, tuple)):
        return []
    return [t for o in out for t in _leaves(o)]


def reduce_sum(out) -> torch.Tensor:
    """The float32 sum of every tensor in `out` (tensors, dicts, lists,
    tuples and dataclasses such as `Detections`), as a 0-d tensor."""
    total = None
    for t in _leaves(out):
        s = t.to(torch.float32).sum()
        total = s if total is None else total + s
    if total is None:
        raise ValueError("the stage returned no tensor")
    return total


def time_fn(fn: Callable[[], object], steps: int) -> float:
    """Two warm runs, then the mean wall in seconds of `steps` runs, each
    ending in a host readback of `reduce_sum` of its outputs (JAX
    `_time_fn`)."""
    reduce_sum(fn()).item()
    reduce_sum(fn()).item()
    t0 = time.perf_counter()
    for _ in range(steps):
        reduce_sum(fn()).item()
    return (time.perf_counter() - t0) / steps


def time_rows(stages: Sequence[Stage], steps: int, batch: int, width: int = 28,
              around: Optional[Around] = None) -> List[Row]:
    """Times each stage (through `around`, where given) and prints its
    line; a stage that runs out of device memory gets a FAILED row and the
    next stage runs."""
    rows: List[Row] = []
    for name, fn in stages:
        timed = lambda fn=fn: time_fn(fn, steps)
        try:
            dt = around(name, fn, timed) if around is not None else timed()
        except torch.cuda.OutOfMemoryError as e:
            print(f"{name:<{width}} FAILED: {type(e).__name__}", flush=True)
            rows.append((name, None, type(e).__name__))
            torch.cuda.empty_cache()
            continue
        print(f"{name:<{width}} {dt * 1000:10.3f} ms/step  {batch / dt:9.2f} f/s", flush=True)
        rows.append((name, dt, ""))
    return rows


def device_label(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them ("NVIDIA H100 80GB HBM3,
    700.00 W"), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except FileNotFoundError:
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def markdown_table(heading: str, rows: Sequence[Row], batch: int,
                   notes: Sequence[str] = (), unit: str = "frames/s") -> str:
    lines = [heading, "", f"| stage | ms/step | {unit} |", "|---|---|---|"]
    for name, dt, err in rows:
        if dt is None:
            lines.append(f"| {name} | FAILED: {err} | |")
        else:
            lines.append(f"| {name} | {dt * 1000:.3f} | {batch / dt:.2f} |")
    if notes:
        lines += [""] + list(notes)
    return "\n".join(lines) + "\n"
