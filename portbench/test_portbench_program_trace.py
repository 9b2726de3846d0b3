"""`program_trace.py` (the program's spans and counters on a cell) and the
`launches.infer` reader, on the CPU: the two windows at the rehearsal's
tiny shapes, the off-cost micro-benchmark, the split of idle time by
innermost range on made-up events, and the readers on hand-made records."""

from types import SimpleNamespace

import pytest
import torch

from articulation3d_tpu_torch import tracing
from portbench import program_trace, spec
from portbench.test_portbench_rehearsal import CELLS, tiny_context

CPU = torch.autograd.DeviceType.CPU


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_both_windows_on_the_cpu(two_threads, monkeypatch):
    # every sync site a wait, as on the card (on the CPU none waits)
    monkeypatch.setattr(tracing, "_waits", lambda where: True)
    out = program_trace.run(tiny_context(CELLS[0], trace=True), 2)
    prog, prof = out["program"], out["profiled"]
    assert prog["calls"] == 2 and len(prog["walls_s"]) == 2 and len(prog["off_walls_s"]) == 2
    spans = prog["spans"]
    for name in ("pipeline.run", "pipeline.upload", "pipeline.step", "pipeline.readback",
                 "pipeline.unpack", "pipeline.frame_predictions", "step.model", "model.rpn",
                 "rpn.select", "model.roi_heads", "roi_heads.class_nms", "nms", "sync"):
        assert spans[name]["wall_ms"] > 0, name
    assert spans["pipeline.run"]["n"] == 1
    # the wall of "pipeline.run" is the sum of its children's and its self time
    kids = ("pipeline.upload", "pipeline.step", "pipeline.readback", "pipeline.unpack",
            "pipeline.frame_predictions")
    run = spans["pipeline.run"]
    assert run["wall_ms"] == pytest.approx(run["self_ms"] + sum(spans[k]["wall_ms"]
                                                                for k in kids))
    layers = prog["layers"]
    assert set(layers) == {"host_syncs"} | set(program_trace.LAYERS)
    assert layers["host_syncs"] == sum(v for k, v in prog["counters"].items()
                                       if k.startswith("sync."))
    assert layers["host_syncs"] > 0 and all(v > 0 for v in layers.values())
    assert layers["rpn_host_ms"] == spans["model.rpn"]["wall_ms"]
    assert "sync_audit" not in out                 # a CUDA mode only
    assert prof["recorded_calls"] == 2 and prof["busy_ms"] == 0 and prof["device_ops"] == 0
    # no device here: all of the window is idle, nearly all of it inside a span
    assert prof["idle_ms"] == pytest.approx(prof["window_ms"])
    assert prof["idle_ms"] == pytest.approx(sum(prof["idle_ms_by_span"].values()))
    assert prof["idle_outside_spans_share"] < 0.2
    assert "nms" in prof["idle_ms_by_span"] and "pipeline.unpack" in prof["idle_ms_by_span"]
    assert set(out["off_cost_ns"]) == {"span_ns", "count_ns"}
    lines = program_trace.report(out)
    assert any(line.startswith("# layer host_syncs") for line in lines)


def test_off_cost_micro_benchmark():
    cost = program_trace.off_cost_ns(2000)
    assert set(cost) == {"span_ns", "count_ns"}
    assert tracing._recorder is None


def _event(name, lo, hi, eid):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=lo, end=hi),
                           device_type=CPU, id=eid)


def test_idle_time_splits_by_the_innermost_range():
    events = [_event("a3d.a", 0, 10, 1), _event("a3d.b", 2, 5, 2), _event("pb.call", 0, 12, 3)]
    busy = [(1, 3), (6, 7)]
    got = program_trace.idle_by_span(events, busy, (0, 12), "a3d.")
    # idle [0, 1] a; [3, 5] b; [5, 6] a; [7, 10] a; [10, 12] outside
    assert got == {"a": 5.0, "b": 2.0, "": 2.0}


def test_layer_numbers_read_the_per_call_summary():
    summary = {"spans": {"sync": {"n": 8, "wall_s": 0.004, "self_s": 0.004},
                         "model.rpn": {"n": 2, "wall_s": 0.03, "self_s": 0.01},
                         "step.paste": {"n": 2, "wall_s": 0.002, "self_s": 0.002},
                         "step.pack": {"n": 2, "wall_s": 0.001, "self_s": 0.001}},
               "counters": {"sync.nms": 6, "sync.readback": 2, "readback.bytes": 100}}
    one = dict(summary, calls=1)
    total = program_trace.merge([one, one])
    assert total["calls"] == 2 and total["counters"]["sync.nms"] == 12
    assert total["spans"]["model.rpn"] == {"n": 4, "wall_s": 0.06, "self_s": 0.02}
    prog = program_trace.per_call(summary, 2)
    got = program_trace.layer_numbers(prog)
    assert got == pytest.approx({"host_syncs": 4.0, "sync_wait_ms": 2.0, "rpn_host_ms": 15.0,
                                 "roi_heads_host_ms": 0.0, "step_post_ms": 1.5,
                                 "unpack_ms": 0.0})
    assert prog["counters"]["readback.bytes"] == 50


def test_launches_reader_on_a_hand_made_record():
    read = spec.load_module("metrics", "launches.infer").read
    assert read({"calls": []}) is None
    assert read({"trace": {"calls": [{}] * 4, "device_op_count": 0}}) is None
    assert read({"trace": {"calls": [{}] * 4, "device_op_count": 1000}}) == 250.0
