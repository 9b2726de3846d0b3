"""The stage-1 training cell on the CPU: its configuration against
`configs/step1_bbox.yaml`, a tiny-shape rehearsal of its driver judged
against the plain reference, each fault `control_train.py` plants and the
float8 control in the program's place, the FLOP and K2 byte counts, and the
metric readers on hand-made records.

The rehearsal shrinks the frames (64x96), the batch (2 images), the
proposals (64 before NMS, 32 after), the anchors (32 an image) and the
ROIs (8 an image, so that the 0.25 and 0.5 foreground fractions sample
differently) and runs the box pool through `_TrainPool` (the plain
versions of K1 and K2 on the CPU); widths stay published.
"""

import copy
import os
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import control_train, spec
from portbench.counts import flops, roi_align_adj, train_flops
from portbench.peaks import HBM_BYTES_PER_S
from portbench.reference import judge_train
from portbench.reference import planercnn as ref
from portbench.reference import train_s1

BENCH = spec.benchmark()
CELL = "train_s1_ims16"
CONFIG = "planercnn_r50fpn_train_s1"


def tiny_context(seed: int = 2 ** 31 + 3, trace: bool = False) -> spec.Context:
    conf = copy.deepcopy(spec.config_file(CONFIG))
    m = conf["config"]["model"]
    conf["config"]["input"].update(height=64, width=96)
    m["rpn"].update(pre_nms_topk_train=64, post_nms_topk_train=32, batch_size_per_image=32)
    m["roi_heads"].update(batch_size_per_image=8)
    m["roi_pooler_impl"] = "cuda"
    ctx = spec.context(BENCH, CELL, seed, 0.1, trace, torch.device("cpu"),
                       time.perf_counter(), config=conf)
    ctx.traffic = dict(ctx.traffic, height=64, width=96, ims=2, pool_batches=2, min_boxes=2,
                       min_side=16, max_side=56)
    ctx.workload = dict(ctx.workload, warmup_calls=1, sample_calls=2, judge_calls=1,
                        trace_calls=2)
    return ctx


def run_tiny(ctx):
    torch.set_num_threads(2)
    out = spec.load_module("drivers", ctx.workload["driver"]).run(ctx)
    return out, spec.result(BENCH, ctx, out, {"platform": "cpu", "kind": "rehearsal",
                                               "count": 1, "memory_peak_bytes": 0})


def test_configuration_is_the_published_one():
    """`configs/step1_bbox.yaml` with the warm start emptied and the
    checkpoint, evaluation and visualisation periods at 0, nothing
    reduced; the driver sets the output directory."""
    import dataclasses
    from articulation3d_tpu_torch.config import load_config
    conf = spec.config_file(CONFIG)
    pub = load_config(os.path.join(spec.ROOT, "configs", "step1_bbox.yaml"))
    want = dataclasses.replace(
        pub, weights="", output_dir="",
        solver=dataclasses.replace(pub.solver, checkpoint_period=0),
        test=dataclasses.replace(pub.test, eval_period=0, vis_period=0))
    assert load_config(None, conf["config"]) == want
    assert conf["reduced"] == [] and want.solver.ims_per_batch == 16
    assert (want.input.height, want.input.width) == (480, 640)


def test_rehearsal_is_correct():
    out, res = run_tiny(tiny_context())
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(judge_train.NUMBERS)
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_for(BENCH, CELL, False)}


def test_traced_rehearsal_reports_the_program_metrics():
    out, res = run_tiny(tiny_context(trace=True))
    assert res["correct"], res["checks"]
    allowed = {m["name"] for m in spec.metrics_for(BENCH, CELL, True)}
    # no device here: the readers of the device trace and the card's memory
    # find nothing and leave their metric out
    assert set(res["metrics"]) == {"mfu.train", "targets_host_ms.train", "host_syncs.train",
                                   "rpn_host_ms.train"}
    assert set(res["metrics"]) <= allowed
    prog = out["record"]["program"]
    assert prog["calls"] == 2 and prog["counters"]["train.images"] == 4
    assert out["record"]["trace"]["backward_ranges"] == 2


@pytest.mark.parametrize("fault", sorted(control_train.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with control_train.planted(fault):
        _, res = run_tiny(tiny_context())
    assert not res["correct"], res["checks"]


def test_float8_control_is_not_correct():
    with control_train.float8_in_the_programs_place():
        _, res = run_tiny(tiny_context())
    assert not res["correct"], res["checks"]
    # its own proposals and ROI sample are valid choices, and its boxes its own
    assert all(res["checks"][k]["value"] == 0 for k in ("anchor_labels", "roi_labels"))
    assert res["checks"]["rpn_box"]["value"] > 0, res["checks"]


def test_a_program_without_the_choices_fails_at_once(monkeypatch):
    from articulation3d_tpu_torch import tracing
    monkeypatch.delattr(tracing, "keeping")
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="keeping"):
        spec.load_module("drivers", "train_step").run(tiny_context())
    assert time.perf_counter() - t < 5


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_training_flops_match_the_reference():
    """Forward and backward of the plain reference at 64x96 under torch's
    FLOP counter: the trunk, FPN and RPN head with res3 up, the FPN and the
    head trained; the box head on ROIs whose features take a gradient."""
    from portbench import weights as pbweights
    full = pbweights.draw(0, "cpu", rpn_delta_scale=0.01, objectness_bias=0.0)
    keys = train_s1.trained_keys(full)
    params = {k: full[k].clone().requires_grad_(True) for k in keys}
    net = ref.Net(dict(full, **params))
    x = torch.randn(1, 3, 64, 96)

    def image():
        logits, deltas = net.rpn_head(net.backbone(x))
        (sum(lg.sum() for lg in logits) + sum(d.sum() for d in deltas)).backward()

    assert _counted(image) == train_flops.total(64, 96, 1, 0)
    pooled = torch.randn(5, 256, 7, 7, requires_grad=True)

    def box():
        c, d = net.box_logits(pooled)
        (c.sum() + d.sum()).backward()

    assert _counted(box) == train_flops.total(64, 96, 0, 5)
    assert train_flops.step_flops(480, 640, 1, 0)["forward"] == sum(
        v for k, v in flops.image_flops(480, 640).items() if k != "depth")


def test_k2_bound_by_bytes_hand_worked():
    # one 8x8 px ROI at p2, 7x7 aligned: g's row read once (49 x 256 x 4 B)
    # and every cell of the four level gradients written once
    shapes = [(16, 16), (8, 8), (4, 4), (2, 2)]
    boxes = np.array([[[4.0, 4.0, 12.0, 12.0], [0.0, 0.0, 30.0, 30.0]]], np.float32)
    valid = np.array([[True, False]])
    t, by = roi_align_adj.bound_seconds(shapes, boxes, valid, 7, 0, True)
    nbytes = 49 * 256 * 4 + (256 + 64 + 16 + 4) * 256 * 4
    assert by == "bytes" and t == pytest.approx(nbytes / HBM_BYTES_PER_S)
    # the samples of each of the 7 rows touch 2 cells (0.64..2.36 over 7 bins)
    assert roi_align_adj._row_supports(np.array([0.5]), np.array([2.0]), 7, 0, 16)[0] == 14


def _metric(name):
    return spec.load_module("metrics", name).read


def test_readers_on_hand_made_records():
    conf = spec.config_file(CONFIG)["config"]
    base = {"config": conf, "window_s": 10.0, "setup_s": 30.0,
            "calls": [{"frames": 16, "wall": 0.1}] * 100, "frames_done": 1600,
            "frames_sent": 1600, "rois_per_step": 8192.0, "memory_peak_bytes": 6 * 2 ** 30}
    assert _metric("frames_per_s")(base) == 160.0
    per_step = train_flops.total(480, 640, 16, 8192)
    assert _metric("mfu.train")(base) == pytest.approx(100 * per_step * 10 / 989e12)
    assert _metric("peak_mem_gib.train")(base) == 6.0
    for name in ("k1_roofline.train", "k2_roofline.train", "backward_dev_ms.train",
                 "device_idle_pct.train", "targets_host_ms.train", "host_syncs.train",
                 "rpn_host_ms.train", "launches.train"):
        assert _metric(name)(base) is None, name
    prog = {"calls": 4, "spans": {"train.rpn_targets": {"n": 4, "wall_s": 0.02, "self_s": 0.02},
                                  "train.sample_rois": {"n": 4, "wall_s": 0.008,
                                                        "self_s": 0.008},
                                  "train.rpn": {"n": 4, "wall_s": 0.05, "self_s": 0.01}},
            "counters": {"sync.nms": 100, "sync.train_readback": 20, "train.images": 64}}
    rec = dict(base, program=prog)
    assert _metric("targets_host_ms.train")(rec) == pytest.approx(7.0)
    assert _metric("host_syncs.train")(rec) == 30.0
    assert _metric("rpn_host_ms.train")(rec) == pytest.approx(12.5)
    boxes = np.zeros((16, 512, 4), np.float32)
    boxes[..., 2:] = 64.0
    pools = [{"boxes": boxes, "valid": np.ones((16, 512), bool), "p": 7, "ratio": 0,
              "aligned": True}] * 2
    tr = {"calls": [{}] * 2, "busy_s": 0.15, "window_s": 0.2, "backward_kernel_us": 90e3,
          "device_op_count": 9000,
          "pools": pools, "device_ops_us": {"void roi_align_adj_kernel<7, true>(...)": 2000.0,
                                            "void roi_align_fwd_kernel<float, 7>(...)": 1000.0}}
    rec = dict(base, trace=tr)
    assert _metric("device_idle_pct.train")(rec) == pytest.approx(25.0)
    assert _metric("backward_dev_ms.train")(rec) == pytest.approx(45.0)
    assert _metric("launches.train")(rec) == 4500.0
    pyr = flops.pyramid(480, 640)
    shapes = [pyr[f"p{l}"] for l in (2, 3, 4, 5)]
    k2 = roi_align_adj.bound_seconds(shapes, boxes, pools[0]["valid"], 7, 0, True)[0]
    assert _metric("k2_roofline.train")(rec) == pytest.approx(100 * 2 * k2 / 2000e-6)
    assert 0 < _metric("k1_roofline.train")(rec) < 100


def test_proposals_on_one_box_from_two_levels_keep_their_anchors():
    """A p5 anchor at (128, 128) and the p6 anchor at (0, 0) both clip to
    [0, 0, 256, 256]; with their bfloat16 logits equal, each kept proposal
    still gets its own anchor, so the per-level NMS checks see no pair."""
    boxes = torch.tensor([[0., 0., 256., 256.], [0., 0., 256., 256.], [10., 10., 50., 50.]])
    logits = torch.tensor([3.13, 3.12, 1.0])
    pboxes = torch.tensor([[0., 0., 256.01, 256.], [0.005, 0., 256., 256.]])
    plogits = torch.tensor([3.125, 3.125])
    ones = torch.ones(3, 4) * 0.5
    idx = judge_train.assign_anchors(pboxes, plogits, boxes, logits, ones, torch.ones(3))
    assert sorted(idx.tolist()) == [0, 1]
    levels = torch.tensor([3, 4, 0])
    assert judge_train.nms_overlap(pboxes, levels[idx], 0.7) == 0.0
    # a box half a pixel off its anchor's costs a unit of rounding: the
    # proposal takes the anchor it lies on, not the one with the nearer logit
    boxes2 = torch.tensor([[0., 0., 128., 128.5], [0., 0., 128., 128.], [10., 10., 50., 50.]])
    idx = judge_train.assign_anchors(pboxes[:1] * 0.5, torch.tensor([2.0]), boxes2,
                                     torch.tensor([2.0, 2.6, 0.0]), ones, torch.full((3,), 20.0))
    assert idx.tolist() == [1]
