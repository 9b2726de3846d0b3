"""The port's data parallelism (`parallel/`, the DDP trainer, distributed
evaluators and pipeline) on the CPU, with gloo.

1. Against the JAX package in one process: `pad_to_multiple`,
   `auto_scale_workers` and `gather_predictions` give JAX's results;
   without a process group every helper is the one-process identity.
2. Two processes joined by gloo (a `FileStore` rendezvous under the test's
   tmp directory; each process has a time limit, so a hung rendezvous fails
   the test instead of stalling the suite) run, once for the module:
   * `gather_predictions`, `is_main_process` and `process_count`, as
     `tests/test_multihost.py` checks JAX's;
   * the tiny 64x80 stage-1 and stage-3 recipes (`Trainer` with a
     DistributedDataParallel model, float32, stepping with the
     global-batch step `train_step`, JAX's `make_train_step` over a mesh,
     in place of its own `sharded_train_step`, which
     `tests/test_torch_sharded_step.py` holds against JAX) for two steps,
     each rank taking its contiguous half of a global batch of 4.  Both
     must equal the port's one-process `Trainer` on the whole batch: each step's
     losses within 1e-4 relative, every trainable parameter (a strided
     sample of each tensor) within 1e-3 x the largest change two steps
     make to that tensor, plus 1e-6 x its magnitude, and the depth head's
     BatchNorm statistics (stage 3: batch statistics over both ranks)
     within 1e-5 relative.  The two sides sum the same float32 terms in
     other orders (per-rank partial sums, DDP's gradient mean).  The
     one-process step is itself held against JAX's step in
     `tests/test_torch_train.py` and `tests/test_torch_train_stage3.py`;
   * both evaluators with `distributed=True`, each rank feeding half of
     the images: the main process's results equal one process's dict for
     dict, exactly, and the other rank returns an empty dict;
   * `VideoPipeline` over two ranks: the predictions and depths equal one
     process's, exactly;
   * the stage-1 run checkpoints after its second step: the checkpoint
     written at two ranks resumes at one.
"""

import copy
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch import parallel as ppar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
H, W = 64, 80
GLOBAL_BATCH = 4
STAGES = ("step1_bbox", "step3_plane")
WORKER_TIMEOUT_S = 420
RANK_THREADS = 2


# --------------------------------------------------------------------------- #
# one process, against JAX
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (1, 8), (7, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    from articulation3d_tpu.parallel import pad_to_multiple as jax_pad
    rs = np.random.RandomState(n)
    batch = {"images": rs.randint(0, 255, (n, 4, 5, 3)).astype(np.uint8),
             "valid": rs.rand(n, 3) > 0.5}
    got, n_got = ppar.pad_to_multiple(copy.deepcopy(batch), multiple)
    want, n_want = jax_pad(copy.deepcopy(batch), multiple)
    assert n_got == n_want == n
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape[0] % multiple == 0 and got[k].dtype == want[k].dtype


@pytest.mark.parametrize("ref,workers", [(0, 4), (8, 8), (8, 4), (4, 8), (16, 1)])
def test_auto_scale_workers_matches_jax(ref, workers):
    from articulation3d_tpu import config as jcfg
    over = {"solver": {"reference_world_size": ref, "ims_per_batch": 16, "base_lr": 0.02,
                       "max_iter": 90000, "warmup_iters": 1000, "steps": [60000, 80000],
                       "checkpoint_period": 5000},
            "test": {"eval_period": 3000}}
    got = pcfg.auto_scale_workers(pcfg.load_config(None, over), workers)
    want = jcfg.auto_scale_workers(jcfg.load_config(None, over), workers)
    for section in ("solver", "test"):
        g, w = dataclasses.asdict(getattr(got, section)), dataclasses.asdict(getattr(want, section))
        assert {k: g[k] for k in w if k in g} == {k: w[k] for k in w if k in g}
    if ref in (0, workers):
        assert got == pcfg.load_config(None, over)


def test_one_process_helpers_match_jax(monkeypatch):
    from articulation3d_tpu.parallel import dist as jdist
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert ppar.init_distributed() is False          # no arguments, no environment
    preds = [{"image_id": 3, "instances": [1, 2]}, {"image_id": 4, "instances": []}]
    assert ppar.gather_predictions(preds) == jdist.gather_predictions(preds) == preds
    assert ppar.process_count() == jdist.process_count() == 1
    assert ppar.is_main_process() and jdist.is_main_process()
    mesh = ppar.make_mesh()
    assert (mesh.rank, mesh.size) == (0, 1) and ppar.replicated(mesh) == 0
    assert ppar.batch_sharding(mesh, 6) == slice(0, 6)
    batch = {"a": np.arange(6), "t": torch.arange(6), "name": "x"}
    assert ppar.shard_batch(mesh, batch) is not batch
    two = ppar.Mesh(rank=1, size=2)
    half = ppar.shard_batch(two, batch)
    np.testing.assert_array_equal(half["a"], [3, 4, 5])
    assert half["t"].tolist() == [3, 4, 5] and half["name"] == "x"
    with pytest.raises(ValueError):
        ppar.batch_sharding(two, 5)
    t = torch.ones(3)
    assert ppar.replicate(mesh, t) is t and ppar.all_reduce_sum(t) is t
    assert ppar.global_count(t) is t


def test_detection_loader_splits_each_global_batch():
    from articulation3d_tpu_torch.data.mapper import DetectionLoader
    records = [{"i": i} for i in range(10)]
    mapper = lambda rec: {"i": np.asarray(rec["i"])}
    whole = DetectionLoader(records, mapper, 4, seed=3)
    ranks = [DetectionLoader(records, mapper, 4, seed=3, rank=r, world_size=2)
             for r in range(2)]
    it = [iter(x) for x in [whole] + ranks]
    for _ in range(5):                                  # across an epoch boundary
        full, a, b = (next(x)["i"] for x in it)
        np.testing.assert_array_equal(np.concatenate([a, b]), full)
        assert len(a) == len(b) == 2
    with pytest.raises(ValueError):
        DetectionLoader(records, mapper, 3, rank=0, world_size=2)


# --------------------------------------------------------------------------- #
# shared inputs of the one-process and two-process runs
# --------------------------------------------------------------------------- #

def _train_cfg(stage, out, **solver):
    over = {"model": {"rpn": {"pre_nms_topk_train": 32, "post_nms_topk_train": 16},
                      "roi_heads": {"batch_size_per_image": 8},
                      "depth_head": {"output_height": H, "output_width": W},
                      "dtype": "float32"},
            "input": {"height": H, "width": W},
            "solver": {"ims_per_batch": GLOBAL_BATCH, "base_lr": 0.0002,
                       "warmup_factor": 1.0, "checkpoint_period": 0, **solver},
            "test": {"eval_period": 0, "vis_period": 0},
            "weights": "", "output_dir": str(out)}
    return pcfg.load_config(os.path.join(ROOT, "configs", f"{stage}.yaml"), over)


@pytest.mark.parametrize("stage", ["step2_axis", "step3_refine"])
def test_every_trainable_parameter_gets_a_gradient(stage, tmp_path):
    """DistributedDataParallel raises when a trainable parameter takes no
    gradient; the two-rank runs below cover stages 1 and 3, this the
    axis stage and stage 3 with the refine head, in one process."""
    from articulation3d_tpu_torch.train import train_step as pts
    from articulation3d_tpu_torch.train.trainer import Trainer
    if stage == "step3_refine":
        cfg = _train_cfg("step3_plane", tmp_path)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, refine_on=True,
            refine_head=dataclasses.replace(cfg.model.refine_head, height=32, width=40),
            roi_heads=dataclasses.replace(cfg.model.roi_heads, detections_per_image=8,
                                          score_thresh_test=0.0)))
    else:
        cfg = _train_cfg(stage, tmp_path)
    trainer = Trainer(cfg, loader=[], device="cpu")
    batch = {k: v[:2] for k, v in _global_batch().items()}
    losses = pts.compute_losses(trainer.model, pts.to_device(batch, "cpu"),
                                torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    trainable = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    assert len(trainable) > 10
    assert [n for n, p in trainer.model.named_parameters()
            if p.requires_grad and p.grad is None] == []
    assert ("refine_loss" in losses) == (stage == "step3_refine")


def _global_batch(seed=0):
    """Four images, three GT rows each (some padded), every stage's fields
    on the train mapper's wire encodings."""
    rs = np.random.RandomState(seed)
    b = GLOBAL_BATCH
    x1 = rs.uniform(0, 40, (b, 3))
    y1 = rs.uniform(0, 30, (b, 3))
    boxes = np.stack([x1, y1, x1 + rs.uniform(12, 38, (b, 3)),
                      y1 + rs.uniform(10, 32, (b, 3))], -1).astype(np.float32)
    masks = np.zeros((b, 3, H, W), bool)
    for i in range(b):
        for j in range(3):
            bx = boxes[i, j].astype(int)
            masks[i, j, bx[1] + 2:bx[3] - 2, bx[0] + 2:bx[2] - 2] = True
    axis = lambda: np.concatenate([rs.randn(b, 3, 3), rs.rand(b, 3, 1) > 0.3], -1)
    return {
        "images": rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
        "gt_boxes": boxes,
        "gt_classes": rs.randint(0, 2, (b, 3)).astype(np.int32),
        "gt_valid": np.asarray([[True, True, False], [True, True, True],
                                [True, False, False], [True, True, True]]),
        "gt_masks_packed": np.packbits(masks, axis=-1),
        "gt_planes": rs.randn(b, 3, 3).astype(np.float32),
        "gt_rot_axis": axis().astype(np.float32),
        "gt_tran_axis": axis().astype(np.float32),
        "gt_depth_mm": rs.randint(0, 5000, (b, H, W)).astype(np.uint16),
    }


def _sample(t: torch.Tensor) -> np.ndarray:
    flat = t.detach().reshape(-1).to(torch.float64)
    return flat[::max(1, flat.numel() // 4096)].numpy().copy()


def _train_run(stage, out, checkpoint=False):
    """Two steps of `Trainer` with the global-batch step on the global batch
    (with `checkpoint`, a checkpoint after the second); returns its per-step losses, a sample of
    every trainable parameter before and after, and the depth head's
    statistics."""
    from articulation3d_tpu_torch.train.train_step import train_step
    from articulation3d_tpu_torch.train.trainer import Trainer
    trainer = Trainer(_train_cfg(stage, out, checkpoint_period=2 if checkpoint else 0),
                      loader=[_global_batch()], device="cpu")
    trainer.step_fn = train_step          # the global-batch step at any world size
    trainable = {n: p for n, p in trainer.model.named_parameters() if p.requires_grad}
    before = {n: _sample(p) for n, p in trainable.items()}
    records = trainer.train(2)
    stats = {n: b.detach().numpy().copy() for n, b in trainer.model.named_buffers()
             if n.startswith("depth_head") and "running" in n}
    return {"records": [{k: v for k, v in r.items() if k not in ("data_s", "wall_s")}
                        for r in records],
            "before": before, "after": {n: _sample(p) for n, p in trainable.items()},
            "stats": stats, "wrapped": type(trainer.step_model).__name__,
            "iter": trainer.iter}


def _eval_inputs():
    """Seeded records and predictions of `tests/test_torch_eval.py`, for
    both evaluator types."""
    from test_torch_eval import _random_dataset
    return {"arti": _random_dataset(0, n_images=7), "mp3d": _random_dataset(5, n_images=6)}


def _register(path, name, records, kind):
    from articulation3d_tpu_torch.data import catalog
    classes = ["arti_rot", "arti_tran"] if kind == "arti" else ["plane", "plane2"]
    json_file = os.path.join(path, f"{name}.json")
    cats = [{"id": i, "name": c} for i, c in enumerate(classes)]
    tmp = f"{json_file}.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"info": {}, "categories": cats, "data": records}, f)
    os.replace(tmp, json_file)                  # both ranks write the same file
    catalog.register_dataset(name, lambda: copy.deepcopy(records), catalog.DatasetMetadata(
        name=name, json_file=json_file, image_root="", evaluator_type=kind,
        thing_classes=classes, thing_colors=[[0, 130, 200], [230, 25, 75]],
        thing_dataset_id_to_contiguous_id={1: 0, 2: 1}))


def _evaluate(path, inputs, distributed):
    """Each evaluator over this rank's contiguous share of the images."""
    from articulation3d_tpu_torch import evaluation
    world, rank = ppar.process_count(), ppar.process_index()
    out = {}
    for kind, (records, preds) in inputs.items():
        name = f"tpar_{kind}"
        _register(path, name, records, kind)
        cls = evaluation.ArtiEvaluator if kind == "arti" else evaluation.ScannetEvaluator
        ev = cls(name, distributed=distributed,
                 output_dir=os.path.join(path, f"{kind}_{int(distributed)}"))
        ev.reset()
        per = -(-len(records) // world) if distributed else len(records)
        lo = rank * per if distributed else 0
        for rec, p in list(zip(records, copy.deepcopy(preds)))[lo:lo + per]:
            o = {k: p[k] for k in ("instances", "pred_rot_axis", "pred_tran_axis",
                                   "pred_plane")}
            ev.process([{"image_id": rec["image_id"], "file_name": rec["file_name"]}], [o])
        out[kind] = ev.evaluate()
    return out


def _pipeline_frames():
    return list(np.random.RandomState(7).randint(0, 256, (6, H, W, 3)).astype(np.uint8))


def _pipeline_run(distributed):
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    from articulation3d_tpu_torch.weights import random_state_dict
    cfg = pcfg.load_config(None, {
        "model": {"rpn": {"pre_nms_topk_test": 64, "post_nms_topk_test": 16},
                  "roi_heads": {"detections_per_image": 8, "score_thresh_test": 0.0},
                  "depth_head": {"output_height": H, "output_width": W},
                  "dtype": "float32"},
        "input": {"height": H, "width": W}})
    model = build_model(cfg, device="cpu", state_dict=random_state_dict(0))
    pipe = VideoPipeline(cfg, model, batch_size=2, conf_threshold=0.0, device="cpu",
                         distributed=distributed)
    preds = pipe.run(_pipeline_frames())
    fields = ("boxes", "scores", "classes", "masks", "planes", "rot_axis", "tran_axis")
    return {"preds": [{f: getattr(p, f) for f in fields} for p in preds],
            "depths": pipe.depths}


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a `world`-process run; writes its results to
    `out/rank{rank}.pkl`."""
    torch.set_num_threads(RANK_THREADS)
    assert ppar.init_distributed(f"file://{store}", world, rank, backend="gloo",
                                 timeout_s=WORKER_TIMEOUT_S)
    res = {"count": ppar.process_count(), "main": ppar.is_main_process(),
           "gather": ppar.gather_predictions(
               [{"rank": rank, "items": list(range(rank * 3, rank * 3 + 3))}])}
    for stage in STAGES:
        res[stage] = _train_run(stage, os.path.join(out, stage),
                                checkpoint=stage == "step1_bbox")
    with open(os.path.join(out, "eval_inputs.pkl"), "rb") as f:
        res["eval"] = _evaluate(out, pickle.load(f), distributed=True)
    res["pipeline"] = _pipeline_run(distributed=True)
    ppar.barrier()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    with open(out / "eval_inputs.pkl", "wb") as f:
        pickle.dump(_eval_inputs(), f)
    env = dict(os.environ, OMP_NUM_THREADS=str(RANK_THREADS), PYTHONPATH=os.pathsep.join(
        [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    code = ("import sys, test_torch_parallel as t; "
            "t._worker(int(sys.argv[1]), 2, sys.argv[2], sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(out / "store"),
                               str(out)], env=env, cwd=str(out), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    res = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return out, res


# --------------------------------------------------------------------------- #
# two ranks against one process
# --------------------------------------------------------------------------- #

def test_two_ranks_gather_in_rank_order(two_ranks):
    _, res = two_ranks
    for r in range(2):
        assert res[r]["count"] == 2 and res[r]["main"] == (r == 0)
        assert [m["rank"] for m in res[r]["gather"]] == [0, 1]
        assert res[r]["gather"][0]["items"] == [0, 1, 2]
        assert res[r]["gather"][1]["items"] == [3, 4, 5]


@pytest.mark.parametrize("stage", STAGES)
def test_two_rank_steps_equal_one_process(two_ranks, stage, tmp_path):
    _, res = two_ranks
    one = _train_run(stage, tmp_path)
    assert one["wrapped"] == "PlaneRCNN" and one["iter"] == 2
    for r in range(2):
        two = res[r][stage]
        assert two["wrapped"] == "DistributedDataParallel" and two["iter"] == 2
        assert len(two["records"]) == len(one["records"]) == 2
        for a, b in zip(two["records"], one["records"]):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        assert set(two["after"]) == set(one["after"])
        moved = 0
        for n, want in one["after"].items():
            np.testing.assert_array_equal(two["before"][n], one["before"][n])
            change = np.abs(want - one["before"][n]).max()
            tol = 1e-3 * change + 1e-6 * np.abs(want).max()
            assert np.abs(two["after"][n] - want).max() <= tol, n
            moved += change > 0
        assert moved >= 0.8 * len(one["after"]), (moved, len(one["after"]))
        for n, want in one["stats"].items():
            np.testing.assert_allclose(two["stats"][n], want, rtol=1e-5, atol=1e-7,
                                       err_msg=n)
    assert (stage == "step3_plane") == bool(one["stats"])
    # DDP keeps the replicas identical
    for n in res[0][stage]["after"]:
        np.testing.assert_array_equal(res[0][stage]["after"][n], res[1][stage]["after"][n])


def test_distributed_evaluators_equal_one_process(two_ranks, tmp_path):
    from test_torch_eval import _same
    out, res = two_ranks
    with open(out / "eval_inputs.pkl", "rb") as f:
        one = _evaluate(str(tmp_path), pickle.load(f), distributed=False)
    for kind in ("arti", "mp3d"):
        assert one[kind] and isinstance(res[0]["eval"][kind], OrderedDict)
        _same(res[0]["eval"][kind], one[kind])
        assert res[1]["eval"][kind] == OrderedDict()


def test_distributed_pipeline_equals_one_process(two_ranks):
    _, res = two_ranks
    # at the ranks' thread count: the CPU convolutions' float32 results
    # depend on it (not on how the frames are chunked)
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        one = _pipeline_run(distributed=False)
    finally:
        torch.set_num_threads(threads)
    assert len(one["preds"]) == len(one["depths"]) == 6
    assert sum(len(p["boxes"]) for p in one["preds"]) > 0
    for r in range(2):
        two = res[r]["pipeline"]
        assert len(two["preds"]) == 6
        for a, b in zip(two["preds"], one["preds"]):
            for f in b:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        for a, b in zip(two["depths"], one["depths"]):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_of_two_ranks_resumes_at_one(two_ranks):
    from articulation3d_tpu_torch.train.checkpoint import latest_checkpoint
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import load_torch_state_dict
    out, res = two_ranks
    ckpt_dir = out / "step1_bbox"
    path = latest_checkpoint(str(ckpt_dir))
    assert path.endswith("model_0000001.pth")
    assert sorted(n for n in os.listdir(ckpt_dir) if n.endswith(".pth")) == [
        "model_0000001.pth"]
    assert (ckpt_dir / "metrics.json").exists()
    state = torch.load(path, map_location="cpu", weights_only=False)
    assert not any(k.startswith("module.") for k in state["model"])
    assert set(load_torch_state_dict(path)) == set(state["model"])
    trainer = Trainer(_train_cfg("step1_bbox", ckpt_dir, checkpoint_period=0),
                      loader=[_global_batch()], device="cpu")
    trainer.resume_or_load(resume=True)
    assert trainer.iter == 2 and trainer.step_model is trainer.model
    got = {n: _sample(p) for n, p in trainer.model.named_parameters() if p.requires_grad}
    for n, want in res[0]["step1_bbox"]["after"].items():
        np.testing.assert_array_equal(got[n], want, err_msg=n)
    assert len(trainer.train(3)) == 1 and trainer.iter == 3
    os.remove(path)                          # about 1 GB of weights and momenta


def test_chip_smoke_agreement_helpers():
    """The measures the card's data-parallel tests gate on
    (`tests/test_torch_card_train.py`)."""
    from torch_checks import dicts_agree, params_agree
    before = {"w": np.zeros(4), "b": np.ones(2)}
    after = {"w": np.array([0.0, 1.0, 2.0, 4.0]), "b": np.ones(2)}
    off = {"w": after["w"] + [0, 0, 0, 0.002], "b": np.ones(2)}
    # 0.002 against 1e-3 x 4 (the change) + 1e-6 x 4 (the magnitude)
    assert params_agree(off, after, before) == pytest.approx(0.002 / 0.004004)
    assert params_agree(off, after, before, rel=1e-2) == pytest.approx(0.002 / 0.040004)
    assert params_agree(after, after, before) == 0.0
    a = OrderedDict([("AP", 0.5), ("nested", {"x": float("nan")}), ("n", 3)])
    b = OrderedDict([("AP", 0.5 + 1e-9), ("nested", {"x": float("nan")}), ("n", 3)])
    assert dicts_agree(a, b) == pytest.approx(1e-9)
    with pytest.raises(AssertionError):
        dicts_agree(a, OrderedDict([("n", 3), ("AP", 0.5), ("nested", {"x": 0.0})]))
    with pytest.raises(AssertionError):
        dicts_agree({"x": float("nan")}, {"x": 0.0})


def test_param_samples_strided_over_the_trainable_parameters():
    """`param_samples`, the samples `params_agree` compares: every
    trainable tensor at a stride of numel // 4096 (at least 1), float64 on
    the host; frozen tensors are left out."""
    from torch_checks import param_samples
    model = torch.nn.Sequential(torch.nn.Linear(100, 100), torch.nn.Linear(100, 3))
    model[1].bias.requires_grad_(False)
    got = param_samples(model)
    assert sorted(got) == ["0.bias", "0.weight", "1.weight"]
    w = model[0].weight.detach().reshape(-1).double().numpy()
    np.testing.assert_array_equal(got["0.weight"], w[::2])      # 10000 // 4096 = 2
    assert got["0.weight"].dtype == np.float64 and len(got["0.weight"]) == 5000
    np.testing.assert_array_equal(got["0.bias"], model[0].bias.detach().double().numpy())
    np.testing.assert_array_equal(got["1.weight"],
                                  model[1].weight.detach().reshape(-1).double().numpy())
