"""Port vs JAX: the training step, the optimizer, checkpoints and `Trainer`.

On the tiny 64x80 config (float32, the shipped stage-1 recipe here and
the stage-3 recipe in `tests/test_torch_train_stage3.py`, which shares
these helpers and runs in its own xdist worker), one step starts from the same weights in both packages (the
oracle's `he_state_dict` ported into JAX, then back through
`state_dict_from_jax`) with JAX's sampling draws injected into the port's
`targets._uniform`.  Tolerances: each loss within 1e-4 relative; every
trainable parameter's gradient, and the change one SGD step makes to it,
within 1e-3 x max |JAX| of that tensor (two float32 stacks that sum a
50-layer trunk in different orders, `tests/test_torch_model.py`), the
change plus one float32 ulp of the parameter for the rounding of the
update into it; the depth head's BatchNorm statistics after the step
within 1e-4 x (1 + max |JAX|).

The depth head's train-mode BatchNorms take the batch variance in two
passes on both sides: the JAX step runs with flax's
`use_fast_variance=False` (the same function; flax's default one-pass
formula loses digits on the tiny config's coarse lanes, where a 1e-6
change of the input moves the head's gradients by 1e-3 of their size).
A conv bias that feeds a train-mode BatchNorm has an analytically zero
gradient, which both sides give as float32 rounding noise: it is held
below 1e-6 x the largest |gradient| of the depth head on both sides.

The port follows detectron2 where the JAX package departs from it
(ROADMAP.md section 3): FrozenBatchNorm statistics are buffers and the
stages `freeze_at` covers take no update, so the port's trainable set is
JAX's minus those; norm parameters never decay.
"""

import dataclasses
import functools
import json
import os
import re

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as flax_nn

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.models.planercnn import PlaneRCNN as JaxPlaneRCNN
from articulation3d_tpu.train import optimizer as jopt
from articulation3d_tpu.train import train_step as jts
from articulation3d_tpu.train.checkpoint import port_detectron2_state_dict

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.train import optimizer as popt
from articulation3d_tpu_torch.train import targets as pt
from articulation3d_tpu_torch.train import train_step as pts
from articulation3d_tpu_torch.train import trainer as trainer_mod
from articulation3d_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from articulation3d_tpu_torch.train.trainer import Trainer
from articulation3d_tpu_torch.weights import state_dict_from_jax
from torch_oracle import he_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 80
B = 2


def _overrides(model=None, **solver):
    return {"model": {"rpn": {"pre_nms_topk_train": 32, "post_nms_topk_train": 16},
                      "roi_heads": {"batch_size_per_image": 8},
                      "depth_head": {"output_height": H, "output_width": W},
                      "dtype": "float32", **(model or {})},
            "input": {"height": H, "width": W},
            "solver": {"ims_per_batch": B, "base_lr": 0.002, "warmup_factor": 1.0,
                       **solver},
            "weights": ""}


def _cfgs(stage, model=None, **solver):
    """The stage's (JAX, port) configs on the tiny shapes; `model` holds
    extra model overrides (e.g. {"resnet": {"remat": True}})."""
    path = os.path.join(ROOT, "configs", f"{stage}.yaml")
    return (jcfg.load_config(path, _overrides(model, **solver)),
            pcfg.load_config(path, _overrides(model, **solver)))


def _batch(seed=0):
    """Two images, three GT rows (one padded), every stage's fields on the
    train mapper's wire encodings (uint8 pixels, packed masks, u16 mm)."""
    rs = np.random.RandomState(seed)
    boxes = np.asarray([[[8, 6, 40, 38], [30, 20, 74, 58], [0, 0, 1, 1]],
                        [[12, 10, 50, 44], [40, 4, 70, 30], [20, 30, 60, 62]]],
                       np.float32)
    masks = np.zeros((B, 3, H, W), bool)
    for i in range(B):
        for j in range(3):
            x1, y1, x2, y2 = boxes[i, j].astype(int)
            masks[i, j, y1 + 2:y2 - 2, x1 + 2:x2 - 2] = True
    axis = lambda: np.concatenate([rs.randn(B, 3, 3), rs.rand(B, 3, 1) > 0.3], -1)
    return {
        "images": rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        "gt_boxes": boxes,
        "gt_classes": np.asarray([[0, 1, 0], [1, 1, 0]], np.int32),
        "gt_valid": np.asarray([[True, True, False], [True, True, True]]),
        "gt_masks_packed": np.packbits(masks, axis=-1),
        "gt_planes": rs.randn(B, 3, 3).astype(np.float32),
        "gt_rot_axis": axis().astype(np.float32),
        "gt_tran_axis": axis().astype(np.float32),
        "gt_depth_mm": rs.randint(0, 5000, (B, H, W)).astype(np.uint16),
    }


class _JaxDraws:
    """Stands in for `targets._uniform` with the uniforms JAX
    `compute_losses` draws from `key`: per image, ROI sampling from
    fold_in(k_i, 0), then RPN subsampling from fold_in(k_i, 1); each
    `subsample_labels` splits its key into positive and negative draws."""

    def __init__(self, key, b):
        base = jax.random.split(key, b)
        self.keys = []
        for salt in (0, 1):
            for k in base:
                self.keys += list(jax.random.split(jax.random.fold_in(k, salt)))
        self.calls = 0

    def __call__(self, generator, n, device):
        k = self.keys[self.calls]
        self.calls += 1
        return torch.from_numpy(np.array(jax.random.uniform(k, (n,)))).to(device)


@functools.lru_cache(maxsize=None)
def _jax_zeros(stage):
    """Zero-filled JAX variables {"params", "batch_stats"} of the stage's
    tiny model (the solver overrides do not change them)."""
    jc = _cfgs(stage)[0]
    shapes = jax.eval_shape(
        lambda r: JaxPlaneRCNN(jc).init(r, jnp.zeros((1, H, W, 3)),
                                        method=JaxPlaneRCNN.inference),
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def oracle():
    return he_state_dict(0)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_step(jc, params, batch_stats, batch, key):
    model = JaxPlaneRCNN(jc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(prm):
        losses, stats = jts.compute_losses(model, prm, batch_stats, jbatch, key, jc)
        return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), (losses, stats)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "BatchNorm",
                   functools.partial(flax_nn.BatchNorm, use_fast_variance=False))
        (_, (losses, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jopt.build_optimizer(jc, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    # the decay part of JAX's first update: the update of zero gradients
    decay, _ = tx.update(jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params),
                         params)
    return dict(losses={k: float(v) for k, v in losses.items()}, grads=_np_tree(grads),
                params=_np_tree(optax.apply_updates(params, updates)),
                stats=_np_tree(stats), decay=_np_tree(decay), tx=tx)


def _run(oracle, stage, model=None, **solver):
    jc, pc = _cfgs(stage, model, **solver)
    zeros = _jax_zeros(stage)
    params, batch_stats, _ = port_detectron2_state_dict(
        oracle, zeros["params"], zeros.get("batch_stats", {}))
    batch, key = _batch(), jax.random.PRNGKey(11)
    j = _jax_step(jc, params, batch_stats, batch, key)
    return dict(jc=jc, pc=pc, params=_np_tree(params), batch_stats=_np_tree(batch_stats),
                sd=state_dict_from_jax(params, batch_stats), batch=batch, key=key, j=j)


@pytest.fixture(scope="module")
def stage1(oracle):
    return _run(oracle, "step1_bbox")


def _port_step(run, impl="auto"):
    pc = run["pc"]
    pc = pc.replace(model=dataclasses.replace(pc.model, roi_pooler_impl=impl))
    model = build_model(pc, device="cpu", state_dict=run["sd"]).train()
    opt, sched = popt.build_optimizer(pc, model)
    draws = _JaxDraws(run["key"], B)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "_uniform", draws)
        metrics = pts.train_step(model, opt, sched, pts.to_device(run["batch"], "cpu"),
                                 torch.Generator().manual_seed(0))
    return model, metrics


_PRE_BN_BIAS = re.compile(r"depth_head\.(conv\d\.0|deconv\d\.1)\.bias$")


def _check_step(run, model, metrics):
    j = run["j"]
    got = {k: float(v) for k, v in metrics.items() if k != "total_loss"}
    assert set(got) == set(j["losses"]) and got
    for k, v in j["losses"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(metrics["total_loss"]), sum(j["losses"].values()),
                               rtol=1e-4)
    jgrad = state_dict_from_jax(j["grads"])
    solver = run["pc"].solver
    if solver.clip_gradients:           # the port clips in place before the step
        jgrad = {k: np.clip(v, -solver.clip_value, solver.clip_value)
                 for k, v in jgrad.items()}
    jnew = state_dict_from_jax(j["params"], j["stats"])
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert trainable
    head_scale = max([float(np.abs(v).max()) for k, v in jgrad.items()
                      if k.startswith("depth_head.") and not _PRE_BN_BIAS.match(k)],
                     default=0.0)
    jdecay = state_dict_from_jax(j["decay"])
    no_decay = popt._norm_param_names(model)
    lr = solver.base_lr * popt.lr_factor(run["pc"], 0)
    still = []
    for name, prm in trainable:
        ref = jgrad[name]
        grad = np.zeros_like(ref) if prm.grad is None else prm.grad.numpy()
        pre_bn = bool(_PRE_BN_BIAS.match(name))
        if pre_bn:
            assert float(np.abs(ref).max()) <= 1e-6 * head_scale, name
            assert float(np.abs(grad).max()) <= 1e-6 * head_scale, name
        else:
            np.testing.assert_allclose(grad, ref, rtol=0,
                                       atol=1e-3 * float(np.abs(ref).max()), err_msg=name)
        old = np.asarray(run["sd"][name], np.float64)
        delta = prm.detach().numpy().astype(np.float64) - old
        jdelta = jnew[name].astype(np.float64) - old
        if name in no_decay:            # JAX decays the depth head's deconv BNs
            jdelta -= jdecay[name]
        # each side rounds old + update to float32 once: one ulp of the
        # largest new value on top of the update's own tolerance
        ulp = float(np.spacing(np.float32(np.abs(jnew[name]).max())))
        # a pre-BN bias's update differs by lr x its two noise gradients
        tol = 2e-6 * lr * head_scale if pre_bn else 1e-3 * float(np.abs(jdelta).max())
        np.testing.assert_allclose(delta, jdelta, rtol=0, atol=tol + ulp, err_msg=name)
        if float(np.abs(jdelta).max()) <= 10 * ulp:
            still.append(name)
    # outside the depth head (whose gradients are ~1e-5 of its weights at
    # this init) every update is well above the rounding, so a skipped or
    # mis-scaled update fails the check above
    assert all(n.startswith("depth_head.") for n in still), still
    return jnew


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_stage1_step_matches_jax(stage1, impl):
    """The stage-1 recipe: RPN and box losses with the trunk trainable, so
    the pooler's adjoint reaches the FPN (impl "cuda": K1/K2's plain
    versions through the autograd Function; "torch": the gather pooler)."""
    model, metrics = _port_step(stage1, impl)
    _check_step(stage1, model, metrics)
    assert set(stage1["j"]["losses"]) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                                          "loss_box_reg"}
    assert float(model.backbone.fpn_output2.weight.grad.abs().max()) > 0


def test_weight_decay_groups(stage1):
    """With zero gradients a JAX step moves exactly the decayed parameters;
    the port decays the same ones, except where the JAX package departs
    from detectron2 (ROADMAP.md section 3): it decays the depth head's
    `deconv{i}_bn` scales and biases and the stages `freeze_at` stops."""
    run = stage1
    params = run["params"]
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    updates, _ = run["j"]["tx"].update(zeros, run["j"]["tx"].init(params), params)
    moved = {k for k, v in state_dict_from_jax(_np_tree(updates)).items()
             if v.size and np.abs(v).max() > 0}
    model = build_model(run["pc"], device="cpu", state_dict=run["sd"])
    opt, _ = popt.build_optimizer(run["pc"], model)
    names = {id(p): n for n, p in model.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups if g["weight_decay"] > 0
               for p in g["params"]}
    assert decayed and decayed <= moved
    assert all(n.startswith(("backbone.bottom_up.stem", "backbone.bottom_up.res2."))
               for n in moved - decayed), sorted(moved - decayed)[:5]
    assert all(g["weight_decay"] == 0 for g in opt.param_groups
               if any(".norm." in names[id(p)] for p in g["params"]))


@pytest.mark.parametrize("step", [0, 1, 999, 1000, 1001, 209999, 210000, 249999,
                                  250000, 300000])
def test_lr_schedule_matches_jax(step):
    jc, pc = jcfg.Config(), pcfg.Config()
    want = float(jopt.warmup_multistep_schedule(jc)(step))
    np.testing.assert_allclose(pc.solver.base_lr * popt.lr_factor(pc, step), want,
                               rtol=1e-6)
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=pc.solver.base_lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: popt.lr_factor(pc, s))
    for _ in range(min(step, 1001)):
        opt.step()
        sched.step()
    if step <= 1001:
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=1e-6)


def test_unpack_bitmasks_inverts_packbits():
    rs = np.random.RandomState(3)
    masks = rs.rand(2, 3, 5, 21) > 0.5
    got = pts.unpack_bitmasks(torch.from_numpy(np.packbits(masks, axis=-1)), 21)
    np.testing.assert_array_equal(got.numpy(), masks.astype(np.float32))


def test_trainer_runs_writes_metrics_and_checkpoints(tmp_path, stage1, monkeypatch):
    # the oracle's weights stand in for the seeded random ones (the same
    # schema, without generating 208 M values twice); on noise images a
    # small rate keeps the 6 steps finite
    monkeypatch.setattr(trainer_mod, "random_state_dict", lambda seed: stage1["sd"])
    pc = stage1["pc"]
    pc = pc.replace(output_dir=str(tmp_path / "exps"), solver=dataclasses.replace(
        pc.solver, checkpoint_period=5, base_lr=1e-5))
    trainer = Trainer(pc, [stage1["batch"]], device="cpu")
    records = trainer.train(5)
    assert len(records) == 5 and trainer.iter == 5
    assert all(np.isfinite(v) for r in records for v in r.values())
    lines = (tmp_path / "exps" / "metrics.json").read_text().splitlines()
    rows = [json.loads(x) for x in lines]
    assert [r["iteration"] for r in rows] == [1]
    assert {"total_loss", "s_per_it", "loss_cls", "loss_rpn_cls"} <= set(rows[0])
    path = latest_checkpoint(pc.output_dir)
    assert path and path.endswith("model_0000004.pth")
    again = Trainer(pc, [stage1["batch"]], device="cpu")
    again.resume_or_load(resume=True)
    assert again.iter == 5
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         again.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    assert again.scheduler.last_epoch == 5
    st = again.optimizer.state_dict()["state"]
    assert st and all("momentum_buffer" in v for v in st.values())
    assert load_checkpoint(path, again.model, again.optimizer, again.scheduler) == 5
    records = again.train(6)
    assert len(records) == 1 and np.isfinite(records[0]["total_loss"])
