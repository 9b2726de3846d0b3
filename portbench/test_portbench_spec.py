"""The benchmark's files: found by name, and within the contract's limits."""

import json
import os
import re

import pytest

from portbench import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += list(c["reduced"])
        assert len(c["reduced"]) <= 16
    for n in names:
        assert NAME.match(n), n
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_command_paths_and_run_seconds():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p + "/") for p in BENCH["paths"]), w
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_for(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(BENCH, w["name"], True)
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    ctx_files = spec.config_file(w["config"]), spec.traffic_file(w["traffic"])
    conf, traffic = ctx_files
    assert conf["name"] == w["config"]
    spec.load_module("traffic", traffic["generator"])
    spec.load_module("drivers", spec.workload_file(cell)["driver"])
    limits = spec.limits_file(w["config"])
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = config["file"]
    assert any(path.startswith(p + "/") for p in BENCH["paths"])
    with open(os.path.join(ROOT, path)) as f:
        conf = json.load(f)
    assert conf["source"] == config["source"] and conf["reduced"] == config["reduced"]
    assert conf["config"]["weights"] == ""
    assert sum(c["file"] == path for c in BENCH["configs"]) == 1


def test_configuration_is_the_published_one():
    """The inference configuration is `configs/config.yaml` with the
    checkpoint emptied, nothing reduced."""
    from articulation3d_tpu_torch.config import load_config
    conf = spec.config_file("planercnn_r50fpn_infer")
    assert load_config(None, conf["config"]) == load_config(
        os.path.join(ROOT, "configs", "config.yaml")).replace(weights="")
