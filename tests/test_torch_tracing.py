"""The port's recorder (`articulation3d_tpu_torch/tracing.py`) on the CPU:
nesting, parent links, call ids, self time, counters and the bounded
buffer; one recorder at a time; nothing recorded when off; host syncs
counted only where the host waits (on the card); the shared clock with
`torch.profiler` (every span an "a3d.<name>" range with the same parent
and duration); the spans and counters of a tiny `VideoPipeline.run` and
of tiny stage-1 `Trainer` steps.

On the card, `host_syncs` (the "sync.*" counters) must equal what
`torch.cuda.set_sync_debug_mode("warn")` reports for one pipeline call and
for one full-width stage-1 training step:

    python -m pytest tests/test_torch_tracing.py --noconftest -m cuda -q
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.ops.nms import nms_mask
from articulation3d_tpu_torch.train import trainer as trainer_mod
from articulation3d_tpu_torch.video.pipeline import VideoPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H, W = 64, 80

# the spans of one `VideoPipeline.run` at batch 1 with a parent each
PIPELINE_PARENTS = {
    "pipeline.run": None,
    "pipeline.upload": "pipeline.run",
    "pipeline.step": "pipeline.run",
    "pipeline.readback": "pipeline.run",
    "pipeline.unpack": "pipeline.run",
    "pipeline.frame_predictions": "pipeline.run",
    "step.preprocess": "pipeline.step",
    "step.model": "pipeline.step",
    "step.paste": "pipeline.step",
    "step.override": "pipeline.step",
    "step.pack": "pipeline.step",
    "model.backbone": "step.model",
    "model.rpn": "step.model",
    "model.roi_heads": "step.model",
    "model.depth": "step.model",
    "rpn.head": "model.rpn",
    "rpn.select": "model.rpn",
    "roi_heads.box_pool": "model.roi_heads",
    "roi_heads.box_head": "model.roi_heads",
    "roi_heads.class_nms": "model.roi_heads",
    "roi_heads.cascade_pool": "model.roi_heads",
    "roi_heads.mask": "model.roi_heads",
    "roi_heads.plane_axis": "model.roi_heads",
}


def _busy(seconds):
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


def _nested():
    with tracing.span("outer", call=True):
        _busy(0.002)
        with tracing.span("inner"):
            _busy(0.003)
            tracing.count("things", 2)
        with tracing.span("inner"):
            with tracing.span("leaf"):
                _busy(0.001)
        tracing.count("things")


def test_spans_nest_with_parents_calls_and_self_time():
    with tracing.recording() as rec:
        _nested()
        _nested()
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [s.name for s in spans] == ["outer", "inner", "inner", "leaf"] * 2
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "outer":
            assert s.parent is None and s.call == s.id
        else:
            assert by_id[s.parent].name == ("inner" if s.name == "leaf" else "outer")
            assert s.call is not None and by_id[s.call].name == "outer"
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert len({s.call for s in spans}) == 2
    summ = rec.summary()
    assert summ["calls"] == 2 and summ["counters"] == {"things": 6}
    assert rec.counter("things") == 6 and rec.counter("nothing") == 0
    st = summ["spans"]
    assert {k: v["n"] for k, v in st.items()} == {"outer": 2, "inner": 4, "leaf": 2}
    wall = lambda name: sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-9
    for name in st:
        assert st[name]["wall_s"] == pytest.approx(wall(name), abs=1e-12)
    assert st["leaf"]["self_s"] == pytest.approx(st["leaf"]["wall_s"], abs=1e-12)
    assert st["inner"]["self_s"] == pytest.approx(wall("inner") - wall("leaf"), abs=1e-12)
    assert st["outer"]["self_s"] == pytest.approx(wall("outer") - wall("inner"), abs=1e-12)
    assert st["outer"]["self_s"] >= 2 * 0.002


def test_recordings_nest_and_the_buffer_is_bounded(monkeypatch):
    # recordings do not nest: one recorder is on at a time
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    with tracing.recording() as rec:
        tracing.count("a")
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
        for _ in range(4):
            with tracing.span("s"):
                tracing.count("a")
        for _ in range(4):
            with tracing.span("t"):
                pass
    assert tracing._recorder is None
    assert rec.counter("a") == 5 and len(rec.spans) == 5
    assert [s.name for s in rec.spans] == ["s", "t", "t", "t", "t"]
    # the summary covers every span, not only those the buffer kept
    assert rec.summary()["spans"]["s"]["n"] == 4
    assert rec.summary()["spans"]["t"]["n"] == 4


def test_off_records_nothing():
    assert tracing._recorder is None
    assert tracing.span("x") is tracing.span("y")       # the one null span
    _nested()
    with tracing.recording() as rec:
        pass
    _nested()
    assert not rec.spans and rec.summary() == {"calls": 0, "spans": {}, "counters": {}}
    t = tracing.span("timed", timed=True)
    with t:
        _busy(0.001)
    assert t.end_ns - t.start_ns >= 1_000_000


def test_syncs_count_only_where_the_host_waits(monkeypatch):
    assert tracing._waits(torch.device("cuda", 0))
    for where in (torch.zeros(2), torch.device("cpu"), np.zeros(2), [0, 2, 1]):
        assert not tracing._waits(where)
    with tracing.recording() as rec:
        with tracing.sync("here", torch.zeros(2)):
            pass
        with tracing.sync("here", torch.device("cpu")):
            pass
    assert rec.counters == {} and not rec.spans
    # as on the card, where every site waits
    monkeypatch.setattr(tracing, "_waits", lambda where: True)
    with tracing.recording() as rec:
        with tracing.sync("here", torch.zeros(2)):
            pass
    assert rec.counters == {"sync.here": 1} and [s.name for s in rec.spans] == ["sync"]
    # with nothing recording, nothing is counted, and no span is opened
    assert tracing.sync("here", torch.zeros(2)) is tracing.span("x")


def test_spans_share_the_profilers_clock():
    # spans of 5 ms or more, so that a busy host's stalls stay inside 10 %;
    # the profiler's first range holds its own set-up (about 1 ms): warm it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with tracing.recording() as rec:
            with tracing.span("outer", call=True):
                _busy(0.005)
                with tracing.span("inner"):
                    _busy(0.005)
                with tracing.span("inner"):
                    with tracing.span("leaf"):
                        _busy(0.005)
            with tracing.span("torch_work"):
                torch.ones(256, 256) @ torch.ones(256, 256)
                _busy(0.005)
    events = sorted((e for e in prof.events() if e.name.startswith(tracing.PREFIX)),
                    key=lambda e: e.time_range.start)
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [e.name for e in events] == [tracing.PREFIX + s.name for s in spans]
    by_id = {s.id: s for s in spans}
    index = {id(e): i for i, e in enumerate(events)}
    for e, s in zip(events, spans):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(tracing.PREFIX):
            p = p.cpu_parent
        if s.parent is None:
            assert p is None
        else:
            assert p is not None and spans[index[id(p)]] is by_id[s.parent]
        ours = (s.end_ns - s.start_ns) * 1e-3
        theirs = e.time_range.end - e.time_range.start
        assert abs(ours - theirs) <= max(0.1 * theirs, 50.0), (s.name, ours, theirs)
    # without a recorder the ranges are still opened
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nested()
    assert sum(e.name == tracing.PREFIX + "inner" for e in prof.events()) == 2


def _chain(n_extra: int = 0):
    """Box 0 overlaps 1, 1 overlaps 2, 0 and 2 apart; scores descending:
    greedy NMS keeps 0 and 2, after three sweeps (0 kills 1 and 1 kills 2;
    then 2 comes back; then nothing changes)."""
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [5.0, 0.0, 15.0, 10.0],
                          [10.0, 0.0, 20.0, 10.0]] + [[100.0 + 20 * i, 0.0, 110.0 + 20 * i, 10.0]
                                                      for i in range(n_extra)])
    scores = torch.linspace(1.0, 0.5, boxes.shape[0])
    return boxes, scores, torch.ones(boxes.shape[0], dtype=torch.bool)


@pytest.mark.parametrize("n_extra", [0, 3])
def test_nms_counts_its_sweeps(n_extra, monkeypatch):
    boxes, scores, valid = _chain(n_extra)
    with tracing.recording() as rec:
        keep = nms_mask(boxes, scores, valid, 0.3)
    # on the CPU `torch.equal` does not wait: no sync
    assert rec.counters == {"nms.calls": 1} and [s.name for s in rec.spans] == ["nms"]
    monkeypatch.setattr(tracing, "_waits", lambda where: True)     # as on the card
    with tracing.recording() as rec:
        keep = nms_mask(boxes, scores, valid, 0.3)
    assert keep.tolist()[:3] == [True, False, True] and all(keep.tolist()[3:])
    assert rec.counters == {"nms.calls": 1, "sync.nms": 3}
    st = rec.summary()["spans"]
    assert st["nms"]["n"] == 1 and st["sync"]["n"] == 3
    assert [s.name for s in rec.spans].count("sync") == 3


def _tiny_pipeline(device):
    torch.manual_seed(0)
    model = pcfg.ModelConfig(
        rpn=pcfg.RPNConfig(pre_nms_topk_test=32, post_nms_topk_test=32),
        roi_heads=pcfg.ROIHeadsConfig(detections_per_image=8, score_thresh_test=0.0),
        depth_head=pcfg.DepthHeadConfig(output_height=H, output_width=W), dtype="float32")
    cfg = pcfg.Config(model=model, input=pcfg.InputConfig(height=H, width=W))
    pipe = VideoPipeline(cfg, build_model(cfg, device=device), batch_size=1,
                         conf_threshold=0.0, device=device)
    rs = np.random.RandomState(0)
    return pipe, [rs.randint(0, 255, (H, W, 3)).astype(np.uint8) for _ in range(2)]


@pytest.fixture(scope="module")
def pipeline():
    return _tiny_pipeline("cpu")


@pytest.fixture
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_pipeline_records_every_span_and_counter(pipeline, two_threads, monkeypatch):
    pipe, frames = pipeline
    monkeypatch.setattr(tracing, "_waits", lambda where: True)     # as on the card
    with tracing.recording() as rec:
        preds = pipe.run(frames[:1])
        preds += pipe.run(frames[1:])
    assert len(preds) == 2
    spans = list(rec.spans)
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert names == set(PIPELINE_PARENTS) | {"nms", "sync"}
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        if s.name in PIPELINE_PARENTS:
            assert parent == PIPELINE_PARENTS[s.name], s.name
        assert by_id[s.call].name == "pipeline.run"
    assert rec.calls == 2 and len({s.call for s in spans}) == 2
    nms_parents = {by_id[s.parent].name for s in spans if s.name == "nms"}
    assert nms_parents == {"rpn.select", "roi_heads.class_nms"}
    c = rec.counters
    # per call: one NMS over the five RPN levels, one class NMS
    assert c["nms.calls"] == 2 * 2
    assert c["sync.nms"] == sum(s.name == "sync" and by_id[s.parent].name == "nms"
                                for s in spans) >= c["nms.calls"]
    n_out = len(pipe.step(torch.from_numpy(np.stack(frames[:1]))))
    assert c["sync.readback"] == 2 * n_out
    assert c["sync.upload"] == 2 and c["sync.anchors"] == 2 * 5
    assert c["sync.preprocess"] == 2 * 2 and c["sync.pack"] == 2
    assert c["sync.coords"] == 2 * 2                 # the plane override's two swaps
    host_syncs = sum(v for k, v in c.items() if k.startswith("sync."))
    assert host_syncs == sum(s.name == "sync" for s in spans)
    assert c["readback.bytes"] >= 8 * H * W // 8      # the packed masks alone
    # the host unpacks the kept rows alone, of 8 slots a frame
    assert c["unpack.rows"] == sum(len(p) for p in preds)
    assert c["unpack.slots"] == 2 * pipe.config.model.roi_heads.detections_per_image
    assert "k1.launches" not in c                     # the CPU pools with the plain version
    # chunk_walls: from the upload's start to the readback's end, same readings
    last = [s for s in spans if s.call == max(s.call for s in spans)]
    up = next(s for s in last if s.name == "pipeline.upload")
    rb = next(s for s in last if s.name == "pipeline.readback")
    assert pipe.chunk_walls == [(rb.end_ns - up.start_ns) * 1e-9]


def test_a_cpu_pipeline_makes_no_host_sync(pipeline, two_threads):
    pipe, frames = pipeline
    with tracing.recording() as rec:
        pipe.run(frames[:1])
    assert not [k for k in rec.counters if k.startswith("sync.")]
    assert "sync" not in rec.summary()["spans"]
    assert rec.counter("nms.calls") == 2 and rec.counter("readback.bytes") > 0


def test_the_trunk_takes_no_graph_on_the_cpu_in_training_or_under_grad(pipeline, two_threads,
                                                                        monkeypatch):
    """The FPN replays a CUDA graph only for an eval-mode call on the card
    with grad off: on the CPU, in a training forward (even where a key is
    given) and under grad it runs its eager body, and counts nothing."""
    from articulation3d_tpu_torch.models import fpn as pfpn
    pipe, _ = pipeline
    trunk = pipe.model.backbone
    with torch.enable_grad():
        assert pfpn.graph_key(SimpleNamespace(is_cuda=True)) is None
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 3, H, W).astype(np.float32))
    with torch.no_grad():
        eager = trunk._forward(x)
    cases = [("cpu", False, False, pfpn.graph_key), ("cpu under grad", False, True, pfpn.graph_key),
             ("training", True, False, lambda x: ("a key",))]
    try:
        with tracing.recording() as rec:
            for name, training, grad, key in cases:
                monkeypatch.setattr(pfpn, "graph_key", key)
                trunk.train(training)
                with torch.set_grad_enabled(grad):
                    for _ in range(3):
                        out = trunk(x)
                        assert all(torch.equal(out[k], eager[k]) for k in eager), name
    finally:
        trunk.eval()
    assert not [k for k in rec.counters if k.startswith("trunk.")], rec.counters


@pytest.mark.cuda
def test_host_syncs_equal_the_sync_debug_modes_count_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from portbench.program_trace import sync_audit
    pipe, frames = _tiny_pipeline("cuda")
    pipe.run(frames[:1])                # builds the kernels, tunes cuDNN
    pipe.run(frames[:1])                # captures the trunk's graph, which syncs once
    torch.cuda.synchronize()
    got = sync_audit(pipe, frames[1:])
    assert got["uncounted"] == [], got
    assert got["host_syncs"] == got["sync_debug_warnings"] > 0, got
    assert got["by_site"]["sync.readback"] == len(pipe.step(
        torch.from_numpy(np.stack(frames[:1])).cuda()))
    assert "sync.nms" not in got["by_site"], got      # K4 makes no host wait


# the spans of one stage-1 `Trainer` step with a parent each
STEP_PARENTS = {
    "train.step": None,
    "train.backbone": "train.step",
    "train.rpn": "train.step",
    "rpn.head": "train.rpn",
    "rpn.select": "train.rpn",
    "train.sample_rois": "train.step",
    "train.box_pool": "train.step",
    "train.box_head": "train.step",
    "train.losses": "train.step",
    "train.rpn_targets": "train.losses",
    "train.backward": "train.step",
    "train.clip": "train.step",
    "train.optimizer": "train.step",
    "train.readback": "train.step",
}


def _stage1_trainer(tmp_path, device, overrides=None):
    cfg = pcfg.load_config(os.path.join(ROOT, "configs", "step1_bbox.yaml"), {
        "weights": "", "output_dir": str(tmp_path),
        "solver": {"checkpoint_period": 0}, "test": {"eval_period": 0}, **(overrides or {})})
    return trainer_mod.Trainer(cfg, loader=None, device=device)


def test_training_steps_record_their_spans_and_counters(tmp_path, two_threads, monkeypatch):
    monkeypatch.setattr(tracing, "_waits", lambda where: True)     # as on the card
    # the model's own initialisation: the spans need no trained-looking weights
    monkeypatch.setattr(trainer_mod, "random_state_dict", lambda *a, **k: {})
    b, h, w = 2, 64, 96
    trainer = _stage1_trainer(tmp_path, "cpu", {
        "input": {"height": h, "width": w},
        "model": {"dtype": "float32", "rpn": {"pre_nms_topk_train": 64, "post_nms_topk_train": 32},
                  "roi_heads": {"batch_size_per_image": 16}}})
    rs = np.random.RandomState(0)
    trainer.loader = [{"images": rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
                       "gt_boxes": np.asarray([[[8, 6, 40, 38], [0, 0, 0, 0]],
                                               [[12, 10, 50, 44], [40, 4, 90, 60]]], np.float32),
                       "gt_classes": np.asarray([[0, 0], [1, 0]], np.int32),
                       "gt_valid": np.asarray([[True, False], [True, True]])}]
    trainer.train(1)
    with tracing.recording() as rec, tracing.keeping() as kept:
        records = trainer.train(3)
    spans = list(rec.spans)
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == set(STEP_PARENTS) | {"nms", "sync"}
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        if s.name in STEP_PARENTS:
            assert parent == STEP_PARENTS[s.name], s.name
        assert by_id[s.call].name == "train.step"
    assert rec.calls == 2 and len({s.call for s in spans}) == 2
    assert {by_id[s.parent].name for s in spans if s.name == "nms"} == {"rpn.select"}
    c = rec.counters
    assert c["train.images"] == 2 * b
    assert c["sync.train_readback"] == 2 * len(records[0]) - 2 * 2   # all but data_s, wall_s
    assert c["sync.train_keys"] == 2 and c["sync.train_pixel_stats"] == 2 * 2
    assert c["sync.anchors"] == 2 * 5 and c["nms.calls"] == 2 * 1
    assert c["sync.nms"] >= c["nms.calls"]
    assert sum(v for k, v in c.items() if k.startswith("sync.")) == \
        sum(s.name == "sync" for s in spans)
    assert "k1.launches" not in c and "k2.launches" not in c   # the CPU pools with autograd
    # the last step's choices, kept without a copy
    assert set(kept) == {"train.anchors", "train.rois"}
    assert set(kept["train.anchors"]) == {"matched_idx", "labels", "pos", "neg"}
    assert int(kept["train.anchors"]["pos"].sum()) > 0
    rois = kept["train.rois"]["rois"]
    assert rois.is_sampled.shape == (b, 16) and int(rois.is_fg.sum()) >= 3   # the GT appended
    assert set(kept["train.rois"]["proposals"]) == {"boxes", "scores", "valid"}


def test_keeping_holds_references_and_is_off_by_default():
    t = torch.ones(3)
    tracing.keep("x", t=t)                          # no block open: dropped
    with tracing.keeping() as kept:
        tracing.keep("x", t=t)
        tracing.keep("y", u=t, v=t)
        with pytest.raises(RuntimeError):
            with tracing.keeping():
                pass
    assert kept["x"]["t"] is t and set(kept["y"]) == {"u", "v"}
    assert tracing._kept is None


@pytest.mark.cuda
def test_training_step_host_syncs_equal_the_sync_debug_modes_count_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from portbench.program_trace import sync_audit
    from portbench.traffic import train_batches
    trainer = _stage1_trainer(tmp_path, "cuda")
    params = {"height": 480, "width": 640, "ims": 16, "pool_batches": 1, "max_instances": 20,
              "min_boxes": 1, "max_boxes": 6, "min_side": 32, "max_side": 400, "classes": 2}
    trainer.loader = train_batches.Cycle(train_batches.make_pool(params, 7, "cuda"))
    trainer.train(2)                    # builds the kernels, tunes cuDNN
    torch.cuda.synchronize()
    got = sync_audit(SimpleNamespace(run=lambda _: trainer.train(trainer.iter + 1)), None)
    assert got["uncounted"] == [], got
    assert got["host_syncs"] == got["sync_debug_warnings"] > 0, got
    assert got["by_site"]["sync.train_readback"] == 5, got
    assert "sync.nms" not in got["by_site"], got      # K4 makes no host wait
