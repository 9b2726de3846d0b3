"""A tiny-shape rehearsal of each cell's path on the CPU, judged against the
plain reference, with the timed path broken underneath for each fault an
inference cell can have, and the float8 control in the program's place.

This is a test-only path: it skips the harness's look for a card, prints
no device metric, and shrinks the frames (64x96), the proposals (60 before
NMS, 40 after) and the detections (6 a frame); widths stay published.
`run.py` itself needs a card and never falls back to the CPU.
"""

import copy
import time

import pytest
import torch

from portbench import control, spec
from portbench import weights as pbweights
from portbench.reference import judge
from portbench.traffic import frames as frames_mod

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_context(cell: str, trace: bool = False, seed: int = 2 ** 31 + 3,
                 batch: int = 0) -> spec.Context:
    c = spec.cell(BENCH, cell)
    conf = copy.deepcopy(spec.config_file(c["config"]))
    m = conf["config"]["model"]
    conf["config"]["input"].update(height=64, width=96)
    m["depth_head"].update(output_height=64, output_width=96)
    m["rpn"].update(pre_nms_topk_test=60, post_nms_topk_test=40)
    m["roi_heads"].update(detections_per_image=6)
    ctx = spec.context(BENCH, cell, seed, 0.1, trace, torch.device("cpu"),
                       time.perf_counter(), config=conf)
    ctx.traffic = dict(ctx.traffic, height=64, width=96, pool=4, calibration=2,
                       batch=batch or min(ctx.traffic["batch"], 2))
    ctx.workload = dict(ctx.workload, warmup_calls=1, sample_calls=1, judge_calls=1,
                        trace_calls=2)
    return ctx


def run_tiny(ctx):
    torch.set_num_threads(2)
    driver = spec.load_module("drivers", ctx.workload["driver"])
    out = driver.run(ctx)
    return out, spec.result(BENCH, ctx, out, {"platform": "cpu", "kind": "rehearsal",
                                               "count": 1, "memory_peak_bytes": 0})


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    out, res = run_tiny(tiny_context(cell))
    assert list(res) == RESULT_KEYS + ["checks"]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(judge.NUMBERS)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_for(BENCH, cell, False)}


def test_traced_rehearsal_has_the_trace_keys():
    out, res = run_tiny(tiny_context(CELLS[0], trace=True))
    assert list(res) == RESULT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # readers that find nothing to read (no device here) leave their metric out
    allowed = {m["name"] for m in spec.metrics_for(BENCH, CELLS[0], True)}
    assert set(res["metrics"]) <= allowed
    assert "k1_roofline.infer" not in res["metrics"]


def _broken_step(kind):
    """A factory like `make_inference_step` whose step is broken: "half"
    computes the first half of the batch and hands its answers to the other
    half; the others alter one answer where the step produces it."""
    from articulation3d_tpu_torch.video import pipeline as pl
    real = pl.make_inference_step

    def factory(*args, **kw):
        step = real(*args, **kw)

        def broken(frames):
            if kind == "half":
                half = max(frames.shape[0] // 2, 1)
                frames = torch.cat([frames[:half]] * (frames.shape[0] // half + 1))[:frames.shape[0]]
                return step(frames)
            out = step(frames)
            if kind == "box":
                out["boxes"][:, 0, 0] += 6.0
            elif kind in ("score", "depth"):
                control._alter(out, kind)
            elif kind == "plane":
                out["planes"][:, 0] *= 1.5
            elif kind == "axis":
                out["rot_axis"][:, 0, :2] = out["rot_axis"][:, 0, [1, 0]]
            elif kind == "mask":
                out["full_masks_packed"][:, 0] = 255 - out["full_masks_packed"][:, 0]
            elif kind == "dropped":
                out["valid"][:, -1] = False
            return out
        return broken
    return factory


@pytest.mark.parametrize("kind", ["half", "box", "score", "plane", "axis", "mask", "depth",
                                  "dropped"])
def test_a_broken_step_is_not_correct(kind, monkeypatch):
    from articulation3d_tpu_torch.video import pipeline as pl
    monkeypatch.setattr(pl, "make_inference_step", _broken_step(kind))
    ctx = tiny_context(CELLS[0], batch=2)
    _, res = run_tiny(ctx)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    """Each fault `control.py` plants (an NMS skipped, or run at another
    threshold, in the RPN or the box stage; a score or the depth altered
    where the step produces it) fails a limit."""
    ctx = tiny_context(CELLS[0], batch=2)
    with control.planted(fault):
        out, res = run_tiny(ctx)
    assert not res["correct"], res["checks"]


def test_float8_control_is_not_correct():
    """The reference in float8 in the program's place fails a limit."""
    ctx = tiny_context(CELLS[0], batch=2)
    pool = frames_mod.make_pool(ctx.traffic, ctx.seed, ctx.device)
    sd = pbweights.draw_for(ctx.config, ctx.seed, ctx.device)
    stats = pbweights.calibrate(sd, pool[:2], ctx.config)
    del sd
    readings = control.control_readings(ctx, control.judged_frames(ctx), pool.numpy(), stats)
    chk = spec.checks(readings, spec.limits_file(ctx.cell["config"]))
    assert not spec.passes(chk), chk


def test_float32_reference_in_the_programs_place_reads_zero():
    ctx = tiny_context(CELLS[0])
    from portbench.reference import planercnn as ref
    pool = frames_mod.make_pool(ctx.traffic, ctx.seed, ctx.device)
    sd = pbweights.draw_for(ctx.config, ctx.seed, ctx.device)
    pbweights.calibrate(sd, pool[:2], ctx.config)
    net = ref.Net(sd)
    cfg = ctx.config["config"]
    with torch.no_grad():
        got = judge.judge_frame(net, pool[0], ref.infer_frame(net, pool[0], cfg), cfg)
    # zero but for the offsets: the program's override uses its float
    # depth, the judge the whole millimetres it sends
    assert set(judge.NUMBERS) <= set(got), got
    assert max(got[k] for k in judge.NUMBERS) < 1e-4, got
    assert all(got[k] == 0.0 for k in judge.NUMBERS if k != "plane"), got
