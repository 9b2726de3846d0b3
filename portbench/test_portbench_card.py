"""Tests on the card (marked `cuda`; they skip without one): a short run of
a cell through `run.py`, the float8 control at the cell's own size, and
weights drawn on the device from the seed."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import control, spec
from portbench import weights as pbweights
from portbench.traffic import frames as frames_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_weights_on_the_card_follow_the_seed(card):
    conf = spec.config_file("planercnn_r50fpn_infer")
    a = pbweights.draw_for(conf, 2 ** 31 + 99, card)
    b = pbweights.draw_for(conf, 2 ** 31 + 99, card)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_short_run_is_correct(card):
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
                          "infer_stream_b1", "--seed", str(2 ** 31 + 77), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)


def test_float8_control_at_the_cells_size_is_not_correct(card):
    bench = spec.benchmark()
    ctx = spec.context(bench, "infer_stream_b1", 2 ** 31 + 78, 1.0, False, card, 0.0)
    pool = frames_mod.make_pool(ctx.traffic, ctx.seed, card)
    sd = pbweights.draw_for(ctx.config, ctx.seed, card)
    stats = pbweights.calibrate(sd, pool[:ctx.traffic["calibration"]], ctx.config)
    del sd
    readings = control.control_readings(ctx, control.judged_frames(ctx)[:8],
                                        pool.cpu().numpy(), stats)
    chk = spec.checks(readings, spec.limits_file(ctx.cell["config"]))
    assert not spec.passes(chk), chk
