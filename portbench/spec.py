"""The benchmark's files, found by name: `BENCHMARK.json` at the root of
the checkout, and under `portbench/` one file per configuration
(`configs/<name>.json`), traffic mix (`traffic/<name>.json`, read by the
generator `traffic/<generator>.py`), cell (`workloads/<name>.json`, which
names its driver `drivers/<driver>.py`), metric (`metrics/<name>.py`, a
reader `read(record)` that returns a number or None) and set of limits
(`limits/<configuration>.json`).  Adding any of these adds a file and
edits none."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def config_file(name: str) -> dict:
    return _json(HERE, "configs", f"{name}.json")


def traffic_file(name: str) -> dict:
    return _json(HERE, "traffic", f"{name}.json")


def workload_file(name: str) -> dict:
    return _json(HERE, "workloads", f"{name}.json")


def limits_file(config: str) -> dict:
    return _json(HERE, "limits", f"{config}.json")


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (names may hold dots), loaded
    once per process: the same object as `import portbench.<kind>.<name>`
    where the name is a valid module name."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not NAME.match(name) or not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"portbench.{kind}." + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics_for(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or with
    a trace its per-layer metrics."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if applies(m, cell_name)]


@dataclass
class Context:
    """What a driver gets: the cell's files and the run's arguments."""
    cell: dict
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float


def context(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
            device, t0: float, config: Optional[dict] = None) -> Context:
    c = cell(bench, cell_name)
    return Context(cell=c, config=config or config_file(c["config"]),
                   traffic=traffic_file(c["traffic"]), workload=workload_file(cell_name),
                   seed=seed, seconds=seconds, trace=trace, device=device, t0=t0)


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit"}} for each limited number (a number with
    no reading reads NaN and fails)."""
    return {k: {"value": float(readings.get(k, float("nan"))), "limit": float(v)}
            for k, v in limits.items()}


def passes(chk: Dict[str, dict]) -> bool:
    return bool(chk) and all(c["value"] <= c["limit"] for c in chk.values())


def result(bench: dict, ctx: Context, out: dict, device: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device,
    breakdown (traced runs), and the compared numbers last."""
    record = out["record"]
    metrics = {}
    for m in metrics_for(bench, ctx.cell["name"], ctx.trace):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    chk = checks(out["readings"], limits_file(ctx.cell["config"]))
    res = {"correct": passes(chk) and out["failed"] == 0, "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics, "device": dict(device)}
    tr = record.get("trace")
    if tr is not None:
        res["device"]["busy_s"] = tr["busy_s"]
        res["device"]["window_s"] = tr["window_s"]
        top = lambda d: [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        res["breakdown"] = {"device_ops": top(tr["device_ops_us"]),
                            "idle_gaps": top(tr["idle_gaps_us"])}
    res["checks"] = chk
    return res
