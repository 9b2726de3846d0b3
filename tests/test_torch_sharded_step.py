"""Port vs JAX: the `Trainer`'s data-parallel step on two ranks against
JAX's `make_sharded_train_step` on two devices.

JAX's `Trainer` runs `make_sharded_train_step` whenever its mesh has more
than one device (`articulation3d_tpu/train/trainer.py:54-71`): each device
computes its losses on its own shard, so every loss normaliser and the
depth head's train-mode BatchNorm statistics are that device's, and the
trainable gradients, the new running statistics and the metrics are then
averaged over the devices (DDP's semantics, not the global batch's).  With
`solver.grad_sync_dtype: bfloat16` the gradients are averaged in bfloat16.

The JAX side runs that step on a 2-device sub-mesh of the CPU's virtual
devices (as `tests/test_parallel.py` builds one); the port side is two gloo
processes, each running one step of the port's `Trainer` on its half of the
same 4-image global batch, from the same d2-schema weights (the oracle's
`he_state_dict(0)`, which the JAX package's `port_detectron2_state_dict`
carries over exactly) with JAX's per-image sampling draws injected into the
port's `targets._uniform`.  The batch makes the ranks' counts differ: rank
0's images carry 3 GT rows and rank 1's carry 1 (the rest padded), and most
of rank 1's depth pixels are invalid, so foreground ROIs, valid axis rows
and valid depth pixels differ between the halves.  Cases: stage 3 (the
normalisers and the depth head's BatchNorm) and stage 1 at float32, and
stage 1 with the bfloat16 gradient sync.

JAX's depth head runs with flax's two-pass variance
(`use_fast_variance=False`), as `tests/test_torch_train_stage3.py` runs it
(ROADMAP.md section 3).

Gates, those of `tests/test_torch_train.py::_check_step`'s update
comparison: each trainable parameter's change within 1e-3 x the largest
|JAX change| of that tensor plus one float32 ulp of it (a bias that feeds a
train-mode BatchNorm, whose gradient is float32 noise on both sides, within
2e-6 x lr x the depth head's largest gradient); the metrics within 1e-4
relative; the depth head's running statistics within 1e-5 relative (1e-7
absolute).  With the bfloat16 sync each change is held within 2^-6 x the
largest |JAX change| more.  The bfloat16 hook itself is held exactly on
the ranks' own buckets: its result is bit-equal to
((g0/2).bfloat16() + (g1/2).bfloat16()).bfloat16().float() and differs
from the float32 sync.

The batch's seed (41) is one at which each half, in one process, gives
the port's gradients within the gate of JAX's at both stages.  With
random weights the heads and the trunk have ReLU units within float32
noise of zero: on many batches a relative change of 1e-7 of the pooled
ROI features (a float32 rounding) moves the port's own mask and plane
head gradients by 2e-3-6e-3 of their largest value, which no two float32
programs can agree within, and the seed's halves are well clear of that
(`test_batch_halves_are_well_conditioned`).  The stage-3 case's largest
gap is the one-ulp rounding of a depth-head update that the gate allows.

The JAX steps are computed once for the module while the two ranks run
(spawned once for the module, a `FileStore` rendezvous under the test's tmp
directory, each with a time limit).  The worker is this module
(`_worker`): its top imports nothing of JAX, which the ranks import only to
draw JAX's uniforms.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
H, W = 64, 80
GLOBAL_BATCH = 4
WORLD = 2
LR = 0.002
BATCH_SEED = 41
STEP_KEY = 11
CASES = (("step3_plane", "float32"), ("step1_bbox", "float32"), ("step1_bbox", "bfloat16"))
WORKER_TIMEOUT_S = 420
RANK_THREADS = 2


def _case_id(case) -> str:
    return "-".join(case)


def _overrides(stage: str, sync: str, out: str = "") -> dict:
    solver = {"ims_per_batch": GLOBAL_BATCH, "base_lr": LR, "warmup_factor": 1.0,
              "grad_sync_dtype": sync, "checkpoint_period": 0}
    if stage == "step3_plane":        # the recipe's clip, as test_torch_train_stage3
        solver.update(clip_gradients=True, clip_value=0.05)
    return {"model": {"rpn": {"pre_nms_topk_train": 32, "post_nms_topk_train": 16},
                      "roi_heads": {"batch_size_per_image": 8},
                      "depth_head": {"output_height": H, "output_width": W},
                      "dtype": "float32"},
            "input": {"height": H, "width": W},
            "solver": solver,
            "test": {"eval_period": 0, "vis_period": 0},
            "weights": "", "output_dir": out}


def _config_path(stage: str) -> str:
    return os.path.join(ROOT, "configs", f"{stage}.yaml")


def _global_batch(seed: int = BATCH_SEED) -> dict:
    """Four images on the train mapper's wire encodings; images 0-1 (rank
    0's) carry three GT rows, images 2-3 (rank 1's) one, and rank 1's depth
    is valid on a third of its pixels only."""
    rs = np.random.RandomState(seed)
    b = GLOBAL_BATCH
    boxes = np.asarray([[[8, 6, 40, 38], [30, 20, 74, 58], [4, 30, 36, 60]],
                        [[12, 10, 50, 44], [40, 4, 70, 30], [20, 30, 60, 62]],
                        [[10, 8, 58, 50], [0, 0, 1, 1], [0, 0, 1, 1]],
                        [[24, 14, 70, 56], [0, 0, 1, 1], [0, 0, 1, 1]]], np.float32)
    valid = np.asarray([[True, True, True], [True, True, True],
                        [True, False, False], [True, False, False]])
    masks = np.zeros((b, 3, H, W), bool)
    for i in range(b):
        for j in range(3):
            if valid[i, j]:
                x1, y1, x2, y2 = boxes[i, j].astype(int)
                masks[i, j, y1 + 2:y2 - 2, x1 + 2:x2 - 2] = True
    axis = lambda: np.concatenate([rs.randn(b, 3, 3), rs.rand(b, 3, 1) > 0.3], -1)
    depth = rs.randint(1, 5000, (b, H, W)).astype(np.uint16)
    depth[2:, :, : 2 * W // 3] = 0
    return {
        "images": rs.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
        "gt_boxes": boxes,
        "gt_classes": rs.randint(0, 2, (b, 3)).astype(np.int32),
        "gt_valid": valid,
        "gt_masks_packed": np.packbits(masks, axis=-1),
        "gt_planes": rs.randn(b, 3, 3).astype(np.float32),
        "gt_rot_axis": axis().astype(np.float32),
        "gt_tran_axis": axis().astype(np.float32),
        "gt_depth_mm": depth,
    }


class _JaxDraws:
    """Stands in for `targets._uniform` on one rank with the uniforms JAX's
    `compute_losses` draws from that rank's per-image keys (raw uint32
    (2,) keys): per image, ROI sampling from fold_in(k_i, 0), then RPN
    subsampling from fold_in(k_i, 1), each split into positive and
    negative draws (as `tests/test_torch_train.py::_JaxDraws`)."""

    def __init__(self, image_keys):
        import jax
        self.jax = jax
        self.keys = []
        for salt in (0, 1):
            for k in image_keys:
                self.keys += list(jax.random.split(jax.random.fold_in(k, salt)))
        self.calls = 0

    def __call__(self, generator, n, device):
        k = self.keys[self.calls]
        self.calls += 1
        return torch.from_numpy(np.array(self.jax.random.uniform(k, (n,)))).to(device)


def _depth_stats(model) -> dict:
    return {n: b.detach().numpy().copy() for n, b in model.named_buffers()
            if n.startswith("depth_head") and n.endswith(("running_mean", "running_var"))}


def _sample(t: torch.Tensor) -> np.ndarray:
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // 4096)].numpy().copy()


def _port_case(case, rank: int, keys: np.ndarray, out: str) -> dict:
    """One `Trainer` step of this rank on its half of the global batch."""
    from articulation3d_tpu_torch import config as pcfg
    from articulation3d_tpu_torch.parallel import dist as pdist
    from articulation3d_tpu_torch.train import optimizer as popt
    from articulation3d_tpu_torch.train import targets as pt
    from articulation3d_tpu_torch.train.trainer import Trainer
    stage, sync = case
    cfg = pcfg.load_config(_config_path(stage),
                           _overrides(stage, sync, os.path.join(out, _case_id(case))))
    from torch_checks import check_bf16_buckets, recording_bf16_hook
    buckets: list = []
    hook = pdist.bf16_grad_sync_hook
    pdist.bf16_grad_sync_hook = recording_bf16_hook(buckets)
    try:
        trainer = Trainer(cfg, loader=[_global_batch()], device="cpu")
    finally:
        pdist.bf16_grad_sync_hook = hook
    per = GLOBAL_BATCH // WORLD
    orig = pt._uniform
    pt._uniform = _JaxDraws(keys[rank * per:(rank + 1) * per])
    try:
        (rec,) = trainer.train(1)
    finally:
        pt._uniform = orig
    trainable = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    return {"metrics": {k: v for k, v in rec.items() if k not in ("data_s", "wall_s")},
            # rank 0 keeps every value, rank 1 a sample for the replica check
            "after": {n: (p.detach().numpy().copy() if rank == 0 else _sample(p))
                      for n, p in trainable},
            "no_decay": sorted(popt._norm_param_names(trainer.model)),
            "stats": _depth_stats(trainer.model),
            "wrapped": type(trainer.step_model).__name__,
            "step_fn": trainer.step_fn.__name__,
            "bf16": check_bf16_buckets(buckets, WORLD)}


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank: every case's step, pickled to `out/rank{rank}.pkl`."""
    from articulation3d_tpu_torch.parallel import barrier, init_distributed
    from articulation3d_tpu_torch.train import trainer as trainer_mod
    from torch_oracle import he_state_dict
    torch.set_num_threads(RANK_THREADS)
    assert init_distributed(f"file://{store}", world, rank, backend="gloo",
                            timeout_s=WORKER_TIMEOUT_S)
    sd = he_state_dict(0)
    trainer_mod.random_state_dict = lambda seed, **kw: sd
    with open(os.path.join(out, "keys.pkl"), "rb") as f:
        keys = pickle.load(f)
    res = {case: _port_case(case, rank, keys, out) for case in CASES}
    barrier()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# --------------------------------------------------------------------------- #
# fixtures: the ranks start first and run while JAX computes its steps
# --------------------------------------------------------------------------- #

def _image_keys() -> np.ndarray:
    """JAX's per-image keys of the step: split from fold_in(PRNGKey(11),
    step 0) over the global batch, as `make_sharded_train_step` splits
    them."""
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(STEP_KEY), 0)
    return np.asarray(jax.random.split(key, GLOBAL_BATCH))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The two ranks, started, with the keys handed over in `keys.pkl`."""
    out = tmp_path_factory.mktemp("sharded")
    with open(out / "keys.pkl", "wb") as f:
        pickle.dump(_image_keys(), f)
    env = dict(os.environ, OMP_NUM_THREADS=str(RANK_THREADS), PYTHONPATH=os.pathsep.join(
        [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(var, None)
    code = ("import sys, test_torch_sharded_step as t; "
            "t._worker(int(sys.argv[1]), 2, sys.argv[2], sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(out / "store"),
                               str(out)], env=env, cwd=str(out), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        yield out, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _jax_case(case, he: dict) -> dict:
    """JAX's `make_sharded_train_step` on two devices, one step."""
    import functools

    import jax
    import jax.numpy as jnp
    from flax import linen as flax_nn

    from articulation3d_tpu import config as jcfg
    from articulation3d_tpu.models.planercnn import PlaneRCNN
    from articulation3d_tpu.parallel import make_mesh, replicate, shard_batch
    from articulation3d_tpu.train import optimizer as jopt
    from articulation3d_tpu.train import train_step as jts
    from articulation3d_tpu.train.checkpoint import port_detectron2_state_dict

    from articulation3d_tpu_torch.weights import state_dict_from_jax
    from test_torch_train import _jax_zeros, _np_tree

    stage, sync = case
    jc = jcfg.load_config(_config_path(stage), _overrides(stage, sync))
    assert jc.solver.grad_sync_dtype == sync
    zeros = _jax_zeros(stage)
    params, batch_stats, _ = port_detectron2_state_dict(he, zeros["params"],
                                                        zeros.get("batch_stats", {}))
    tx = jopt.build_optimizer(jc, params)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=batch_stats, opt_state=tx.init(params))
    mesh = make_mesh(jax.devices()[:WORLD])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "BatchNorm",
                   functools.partial(flax_nn.BatchNorm, use_fast_variance=False))
        step = jax.jit(jts.make_sharded_train_step(jc, PlaneRCNN(jc), tx, mesh))
        with mesh:
            new, metrics = step(replicate(mesh, state), shard_batch(mesh, _global_batch()),
                                replicate(mesh, jax.random.PRNGKey(STEP_KEY)))
            jax.block_until_ready(new.params)
    # the decay part of JAX's first update: the update of zero gradients
    decay, _ = tx.update(jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params),
                         params)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "new": state_dict_from_jax(_np_tree(new.params), _np_tree(new.batch_stats)),
            "decay": state_dict_from_jax(_np_tree(decay))}


@pytest.fixture(scope="module")
def he():
    from torch_oracle import he_state_dict
    return he_state_dict(0)


@pytest.fixture(scope="module")
def jax_side(started, he):
    return {case: _jax_case(case, he) for case in CASES}


@pytest.fixture(scope="module")
def port_side(started, jax_side):
    out, procs = started
    logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


# --------------------------------------------------------------------------- #
# the comparison
# --------------------------------------------------------------------------- #

def _pre_bn_bias(name: str) -> bool:
    """A conv bias that feeds a train-mode BatchNorm (its gradient is
    analytically zero): `depth_head.conv{i}.0.bias`, `deconv{i}.1.bias`."""
    return re.fullmatch(r"depth_head\.(conv\d\.0|deconv\d\.1)\.bias", name) is not None


def _update_gaps(he: dict, j: dict, port: dict, rel: float, extra: float = 0.0) -> dict:
    """Per trainable parameter, the largest |port change - JAX change| over
    its gate (rel x max|JAX change| + one ulp, + extra x max|JAX change|);
    > 1 fails.  JAX's change has its decay of the parameters the port does
    not decay (norm parameters) taken out."""
    no_decay = set(port["no_decay"])
    deltas = {}
    for name, after in port["after"].items():
        old = np.asarray(he[name], np.float64)
        jdelta = j["new"][name].astype(np.float64) - old
        if name in no_decay:
            jdelta = jdelta - j["decay"][name]
        deltas[name] = (after.astype(np.float64) - old, jdelta)
    # the depth head's largest gradient, read off JAX's first update
    head = [np.abs(jd - (0 if n in no_decay else j["decay"][n])).max() / LR
            for n, (_, jd) in deltas.items()
            if n.startswith("depth_head.") and not _pre_bn_bias(n)]
    head_scale = max(head, default=0.0)
    gaps = {}
    for name, (delta, jdelta) in deltas.items():
        ulp = float(np.spacing(np.float32(np.abs(j["new"][name]).max())))
        big = float(np.abs(jdelta).max())
        tol = 2e-6 * LR * head_scale if _pre_bn_bias(name) else rel * big
        gaps[name] = float(np.abs(delta - jdelta).max()) / (tol + extra * big + ulp)
    return gaps


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_step_matches_jax(case, he, jax_side, port_side):
    j = jax_side[case]
    ranks = [r[case] for r in port_side]
    assert all(r["wrapped"] == "DistributedDataParallel" for r in ranks)
    assert all(r["step_fn"] == "sharded_train_step" for r in ranks)
    port = ranks[0]
    got = port["metrics"]
    assert set(got) == set(j["metrics"]) and len(got) > 1
    loss_gap = {k: abs(got[k] - v) / abs(v) for k, v in j["metrics"].items()}
    extra = 2.0 ** -6 if case[1] == "bfloat16" else 0.0
    gaps = _update_gaps(he, j, port, 1e-3, extra)
    worst = max(gaps, key=gaps.get)
    stats_gap = max([float(np.abs(v - j["new"][n]).max()
                           / (1e-7 + 1e-5 * np.abs(j["new"][n]).max()))
                     for n, v in port["stats"].items()], default=0.0)
    summary = (f"losses' largest relative gap {max(loss_gap.values()):.3e} "
               f"({max(loss_gap, key=loss_gap.get)}); updates' largest gap "
               f"{gaps[worst]:.3f} x the gate ({worst}); "
               f"{sum(g > 1 for g in gaps.values())}/{len(gaps)} tensors over it; running "
               f"statistics' largest gap {stats_gap:.3f} x their gate")
    print(summary)
    for k, v in j["metrics"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=f"{k}: {summary}")
    assert gaps[worst] <= 1.0, summary
    for n, want in j["new"].items():
        if n in port["stats"]:
            np.testing.assert_allclose(port["stats"][n], want, rtol=1e-5, atol=1e-7,
                                       err_msg=n)
    assert bool(port["stats"]) == (case[0] == "step3_plane")
    # DDP keeps the replicas identical
    for n, v in ranks[1]["after"].items():
        np.testing.assert_array_equal(v, _sample(torch.from_numpy(port["after"][n])))


def test_bf16_hook_is_jax_order(port_side):
    """On every bucket of the bfloat16 case's step, both ranks' synced
    gradients are bit-equal to JAX's order on their local gradients, and
    not to the float32 sync; the float32 cases register no hook."""
    for r in port_side:
        got = r[("step1_bbox", "bfloat16")]["bf16"]
        assert got["buckets"] >= 1 and got["values"] > 10 ** 6, got
        assert got["exact"], got
        assert got["off_f32"] > 0, got
        for case in CASES[:2]:
            assert r[case]["bf16"]["buckets"] == 0


@pytest.mark.parametrize("rank", range(WORLD))
def test_batch_halves_are_well_conditioned(rank, he):
    """The stage-3 case's premise: on each rank's half, with that rank's
    draws, multiplying the pooled ROI features by (1 + 1e-7 noise) moves no
    trainable gradient (clipped at the recipe's 0.05, as the update sees
    it) by half the gate, 1e-3 x its largest value, in one process."""
    from articulation3d_tpu_torch import config as pcfg
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.train import optimizer as popt
    from articulation3d_tpu_torch.train import targets as pt
    from articulation3d_tpu_torch.train import train_step as pts
    from articulation3d_tpu_torch.weights import warm_start

    stage = "step3_plane"
    cfg = pcfg.load_config(_config_path(stage), _overrides(stage, "float32"))
    model = build_model(cfg, device="cpu")
    warm_start(model, he)
    popt.freeze_mask(model, cfg.model.freeze)
    model.train()
    per = GLOBAL_BATCH // WORLD
    batch = pts.to_device({k: v[rank * per:(rank + 1) * per]
                           for k, v in _global_batch().items()}, "cpu")
    keys = _image_keys()[rank * per:(rank + 1) * per]
    pool = model._pool
    clip = cfg.solver.clip_value

    def grads(eps, seed=0):
        noise = torch.Generator().manual_seed(seed)

        def noisy_pool(*a, **kw):
            out = pool(*a, **kw)
            return out * (1 + eps * torch.randn(out.shape, generator=noise))

        model._pool = noisy_pool
        model.zero_grad()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pt, "_uniform", _JaxDraws(keys))
            losses = pts.compute_losses(model, batch, [torch.Generator()] * per)
        sum(losses.values()).backward()
        return {n: p.grad.clamp(-clip, clip).clone() for n, p in model.named_parameters()
                if p.grad is not None}

    base = grads(0.0)
    worst = 0.0
    for seed in (0, 1):
        moved = grads(1e-7, seed)
        worst = max(worst, max(float((moved[n] - g).abs().max())
                               / (1e-3 * float(g.abs().max())) for n, g in base.items()
                               if float(g.abs().max()) > 0))
    assert worst < 0.5, worst
