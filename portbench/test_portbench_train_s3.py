"""The stage-3 training cell on the CPU: its configuration against
`configs/step3_plane.yaml`, its traffic generator, a tiny-shape rehearsal
of its driver judged against the plain reference, each fault
`control_train_s3.py` plants and the float8 control in the program's
place, the FLOP count, and the metric readers on hand-made records.

The rehearsal shrinks the frames (64x96), the batch (2 images), the
proposals (64 before NMS, 32 after), the ROIs (16 an image), the GT (3-5
rectangles of 16-60 px) and the depth decoder's output, computes in
float32 (in bfloat16 at this size the depth decoder's coarse lanes
normalise 4 values a channel and its gradients lose a third of their
digits) and runs the pools through `_TrainPool` (the plain K1 on the
CPU); widths stay published.
"""

import copy
import os
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import control_train_s3, spec
from portbench.counts import flops, roi_align, train_s3_flops
from portbench.reference import judge_train_s3, train_s3
from portbench.reference import planercnn as ref
from portbench.traffic import train_planes

BENCH = spec.benchmark()
CELL = "train_s3_ims8"
CONFIG = "planercnn_r50fpn_train_s3"
TINY = dict(height=64, width=96, ims=2, pool_batches=2, max_instances=6, min_planes=3,
            max_planes=5, min_side=16, max_side=60, min_visible=8, depth_grid=[3, 4],
            calibration=2)


def tiny_context(seed: int = 2 ** 31 + 3, trace: bool = False) -> spec.Context:
    conf = copy.deepcopy(spec.config_file(CONFIG))
    m = conf["config"]["model"]
    conf["config"]["input"].update(height=64, width=96)
    m["rpn"].update(pre_nms_topk_train=64, post_nms_topk_train=32)
    m["roi_heads"].update(batch_size_per_image=16)
    m["depth_head"].update(output_height=64, output_width=96)
    m.update(roi_pooler_impl="cuda", dtype="float32")
    ctx = spec.context(BENCH, CELL, seed, 0.1, trace, torch.device("cpu"),
                       time.perf_counter(), config=conf)
    ctx.traffic = dict(ctx.traffic, **TINY)
    ctx.workload = dict(ctx.workload, warmup_calls=1, sample_calls=2, judge_calls=1,
                        trace_calls=2)
    return ctx


def run_tiny(ctx):
    torch.set_num_threads(2)
    out = spec.load_module("drivers", ctx.workload["driver"]).run(ctx)
    return out, spec.result(BENCH, ctx, out, {"platform": "cpu", "kind": "rehearsal",
                                               "count": 1, "memory_peak_bytes": 0})


def test_configuration_is_the_published_one():
    """`configs/step3_plane.yaml` with the warm start emptied and the
    checkpoint, evaluation and visualisation periods at 0, nothing
    reduced; the driver sets the output directory."""
    import dataclasses
    from articulation3d_tpu_torch.config import load_config
    conf = spec.config_file(CONFIG)
    pub = load_config(os.path.join(spec.ROOT, "configs", "step3_plane.yaml"))
    want = dataclasses.replace(
        pub, weights="", output_dir="",
        solver=dataclasses.replace(pub.solver, checkpoint_period=0),
        test=dataclasses.replace(pub.test, eval_period=0, vis_period=0))
    assert load_config(None, conf["config"]) == want
    m = want.model
    assert conf["reduced"] == [] and want.solver.ims_per_batch == 8
    assert (want.input.height, want.input.width) == (480, 640)
    assert (m.mask_on, m.plane_on, m.depth_on, m.axis_on, m.refine_on) == (True,) * 4 + (False,)
    assert set(m.freeze) == {"backbone", "proposal_generator", "roi_heads.box_head",
                             "roi_heads.box_predictor", "roi_heads.axis_head"}
    assert (m.roi_heads.batch_size_per_image, m.roi_heads.positive_fraction) == (512, 0.25)
    assert (m.rpn.pre_nms_topk_train, m.rpn.post_nms_topk_train) == (2000, 1000)
    assert "deployment" in conf["assumed"]


def test_planes_follow_the_seed_and_their_masks():
    a = train_planes.make_pool(dict(spec.traffic_file(CELL), **TINY), 2 ** 31 + 11, "cpu")
    b = train_planes.make_pool(dict(spec.traffic_file(CELL), **TINY), 2 ** 31 + 11, "cpu")
    c = train_planes.make_pool(dict(spec.traffic_file(CELL), **TINY), 2 ** 31 + 12, "cpu")
    assert len(a) == 2 and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert not torch.equal(a[0]["images"], c[0]["images"])
    x = a[0]
    assert x["gt_masks_packed"].shape == (2, 6, 64, 12) and x["gt_depth_mm"].dtype == torch.uint16
    masks = np.unpackbits(x["gt_masks_packed"].numpy(), axis=-1).astype(bool)
    taken = np.zeros((2, 64, 96), int)
    for i in range(2):
        for j in range(6):
            if not x["gt_valid"][i, j]:
                assert not masks[i, j].any() and not x["gt_planes"][i, j].any()
                continue
            ys, xs = np.nonzero(masks[i, j])
            assert len(ys) >= 64                              # 8 x 8 px at least
            assert x["gt_boxes"][i, j].tolist() == [xs.min(), ys.min(), xs.max() + 1,
                                                    ys.max() + 1]
            n = float(x["gt_planes"][i, j].norm())
            assert 0.5 <= n <= 5.0 and float(x["gt_planes"][i, j, 1]) >= 0
            taken[i] += masks[i, j]
    assert taken.max() == 1                                   # painted: no pixel twice
    assert (x["gt_classes"] == 0).all()
    d = x["gt_depth_mm"].to(torch.float32)
    assert 0.03 < float((d == 0).float().mean()) < 0.2 and 500 <= float(d[d > 0].min())
    assert float(d.max()) <= 8000


def test_rehearsal_is_correct():
    out, res = run_tiny(tiny_context())
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(judge_train_s3.NUMBERS)
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_for(BENCH, CELL, False)}


def test_traced_rehearsal_reports_the_program_metrics():
    out, res = run_tiny(tiny_context(trace=True))
    assert res["correct"], res["checks"]
    allowed = {m["name"] for m in spec.metrics_for(BENCH, CELL, True)}
    # no device here: the readers of the device trace and the card's memory
    # find nothing and leave their metric out
    assert set(res["metrics"]) == {"mfu.train_s3", "head_fg_share.train_s3",
                                   "host_syncs.train_s3", "rpn_host_ms.train_s3",
                                   "targets_host_ms.train_s3"}
    assert res["metrics"]["host_syncs.train_s3"]["value"] == 0    # the CPU never waits
    assert set(res["metrics"]) <= allowed
    prog = out["record"]["program"]
    assert prog["calls"] == 2 and prog["counters"]["train.head_rows"] == 2 * 2 * 16
    share = res["metrics"]["head_fg_share.train_s3"]["value"]
    assert 0 < share <= 25.0                                  # at most 0.25 of 16 a image
    spans = out["record"]["trace"]["spans"]
    assert all(spans[n]["n"] == 2 for n in ("train.mask_head", "train.plane_head",
                                              "train.mask_targets", "train.depth_head"))
    assert len(out["record"]["trace"]["pools"]) == 3 * 2


@pytest.mark.parametrize("fault", sorted(control_train_s3.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with control_train_s3.planted(fault):
        _, res = run_tiny(tiny_context())
    assert not res["correct"], res["checks"]


def test_l1_signs_are_the_programs_where_given():
    """The reference's L1 gradients take sign(program's - GT) where the
    program's prediction is given, else their own."""
    gt = torch.zeros(4)
    d = torch.tensor([1e-7, -2.0, 0.0, 3.0])
    assert train_s3.l1_signs(d, None, gt).tolist() == [1.0, -1.0, 0.0, 1.0]
    prog = torch.tensor([-1e-7, -2.0, 0.5, 0.0])
    assert train_s3.l1_signs(d, prog, gt).tolist() == [-1.0, -1.0, 1.0, 0.0]


def test_float8_control_is_not_correct():
    with control_train_s3.float8_in_the_programs_place():
        _, res = run_tiny(tiny_context())
    assert not res["correct"], res["checks"]
    assert res["checks"]["roi_labels"]["value"] == 0 and res["checks"]["update"]["value"] == 0


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flops_match_torchs_counter():
    """A tiny step of the plain reference under torch's FLOP counter: the
    frozen trunk, FPN and RPN head forward, the box head forward on the
    sampled ROIs, the mask and plane heads forward and backward on the
    foreground ones (their pooled input takes no gradient), the depth
    decoder forward and backward (its features take none)."""
    from portbench import weights as pbweights
    full = pbweights.draw(0, "cpu", rpn_delta_scale=0.01, objectness_bias=0.0)
    keys = train_s3.trained_keys(full)
    params = {k: full[k].clone().requires_grad_(True) for k in keys}
    net = ref.Net(dict(full, **params))
    x = torch.randn(1, 3, 64, 96)

    def frozen():
        with torch.no_grad():
            feats = net.backbone(x)
            net.rpn_head(feats)
            net.box_logits(torch.randn(5, 256, 7, 7))
        stats = {}
        net.depth(feats, (64, 96), calib=stats).sum().backward()

    assert _counted(frozen) == train_s3_flops.total(64, 96, 1, 5, 0)
    pooled = torch.randn(3, 256, 14, 14)

    def heads():
        (net.mask_logits(pooled).sum() + net.plane_raw(pooled).sum()).backward()

    assert _counted(heads) == train_s3_flops.total(64, 96, 0, 0, 3)
    # 25.6 TFLOP a step at the cell's shapes with every ROI's head computed
    step = train_s3_flops.step_flops(480, 640, 8, 4096, 4096)
    assert 25.0e12 < step["forward"] + step["backward"] < 26.5e12


def _metric(name):
    return spec.load_module("metrics", name).read


def test_readers_on_hand_made_records():
    conf = spec.config_file(CONFIG)["config"]
    base = {"config": conf, "window_s": 10.0, "setup_s": 30.0,
            "calls": [{"frames": 8, "wall": 0.1}] * 100, "frames_done": 800,
            "frames_sent": 800, "rois_per_step": 4096.0, "fg_rois_per_step": 500.0,
            "memory_peak_bytes": 12 * 2 ** 30}
    per_step = train_s3_flops.total(480, 640, 8, 4096, 500)
    assert _metric("mfu.train_s3")(base) == pytest.approx(100 * per_step * 10 / 989e12)
    assert _metric("peak_mem_gib.train_s3")(base) == 12.0
    for name in ("k1_roofline.train_s3", "heads_dev_ms.train_s3", "mask_targets_dev_ms.train_s3",
                 "depth_dev_ms.train_s3", "backward_dev_ms.train_s3", "head_fg_share.train_s3",
                 "device_idle_pct.train_s3", "launches.train_s3", "host_syncs.train_s3",
                 "rpn_host_ms.train_s3", "targets_host_ms.train_s3"):
        assert _metric(name)(base) is None, name
    prog = {"calls": 4, "spans": {}, "counters": {"train.head_rows": 4 * 4096},
            "head_fg_rows": 2048}
    assert _metric("head_fg_share.train_s3")(dict(base, program=prog)) == pytest.approx(12.5)
    # a program without the counter (the parent of the spans) leaves it out
    old = dict(prog, counters={})
    assert _metric("head_fg_share.train_s3")(dict(base, program=old)) is None
    prog = dict(prog, counters={"train.head_rows": 4 * 4096, "sync.anchors": 20,
                                "sync.train_mask_targets": 32, "nms.calls": 4},
                spans={"train.rpn": {"wall_s": 0.032}, "train.sample_rois": {"wall_s": 0.008},
                       "train.mask_targets": {"wall_s": 0.2}})
    assert _metric("host_syncs.train_s3")(dict(base, program=prog)) == 13.0
    assert _metric("rpn_host_ms.train_s3")(dict(base, program=prog)) == pytest.approx(8.0)
    assert _metric("targets_host_ms.train_s3")(dict(base, program=prog)) == pytest.approx(52.0)
    # the parent has no "train.mask_targets" span: the ROI sampling alone
    old = dict(prog, spans={k: v for k, v in prog["spans"].items() if k != "train.mask_targets"})
    assert _metric("targets_host_ms.train_s3")(dict(base, program=old)) == pytest.approx(2.0)
    boxes = np.zeros((8, 512, 4), np.float32)
    boxes[..., 2:] = 64.0
    valid = np.ones((8, 512), bool)
    pools = [{"boxes": boxes, "valid": valid, "p": p, "ratio": r, "aligned": a}
             for p, r, a in ((7, 0, True), (14, 2, False), (14, 0, False))] * 2
    spans = {"train.mask_head": {"n": 2, "kernel_us": 3000.0},
             "train.plane_head": {"n": 2, "kernel_us": 5000.0},
             "train.mask_targets": {"n": 2, "kernel_us": 1000.0},
             "train.depth_head": {"n": 2, "kernel_us": 600.0},
             "train.backward": {"n": 2, "kernel_us": 90e3}}
    tr = {"calls": [{}] * 2, "busy_s": 0.15, "window_s": 0.2, "device_op_count": 9000,
          "spans": spans, "pools": pools,
          "device_ops_us": {"void roi_align_fwd_kernel<float, 14>(...)": 1500.0,
                            "void roi_align_fwd_kernel<float, 7>(...)": 500.0}}
    rec = dict(base, trace=tr)
    assert _metric("device_idle_pct.train_s3")(rec) == pytest.approx(25.0)
    assert _metric("heads_dev_ms.train_s3")(rec) == pytest.approx(4.0)
    assert _metric("mask_targets_dev_ms.train_s3")(rec) == pytest.approx(0.5)
    assert _metric("depth_dev_ms.train_s3")(rec) == pytest.approx(0.3)
    assert _metric("backward_dev_ms.train_s3")(rec) == pytest.approx(45.0)
    assert _metric("launches.train_s3")(rec) == 4500.0
    pyr = flops.pyramid(480, 640)
    shapes = [pyr[f"p{l}"] for l in (2, 3, 4, 5)]
    bound = sum(roi_align.bound_seconds(shapes, boxes, valid, c["p"], c["ratio"], c["aligned"],
                                        in_bytes=4)[0] for c in pools)
    assert _metric("k1_roofline.train_s3")(rec) == pytest.approx(100 * bound / 2000e-6)
    # the parent's trace has no head, target or depth spans
    old = dict(tr, spans={"train.backward": spans["train.backward"]})
    for name in ("heads_dev_ms.train_s3", "mask_targets_dev_ms.train_s3",
                 "depth_dev_ms.train_s3"):
        assert _metric(name)(dict(base, trace=old)) is None, name


def test_mask_crops_take_the_box_in_pixel_edges():
    """A GT box's own crop is all ones, a box that holds the mask in its
    left half is half ones, and the crops do not depend on which GT rows
    share them."""
    mask = torch.zeros(40, 60)
    mask[10:30, 20:48] = 1.0
    boxes = torch.tensor([[20.0, 10.0, 48.0, 30.0], [20.0, 10.0, 76.0, 30.0]])
    crops = train_s3.crop_masks(mask, boxes)
    assert bool(crops[0].eq(1).all())
    assert float(crops[1][:, :14].mean()) == 1.0 and float(crops[1][:, 14:].mean()) == 0.0
    masks = torch.stack([torch.zeros(40, 60), mask])
    got = train_s3.mask_targets(masks, torch.tensor([1, 0]), boxes)
    assert torch.equal(got[0], crops[0]) and not got[1].any()
