"""`resnet.remat` in the port: each Bottleneck of res2-res5 that takes a
gradient runs through `torch.utils.checkpoint` in a training forward
(JAX `nn.remat(Bottleneck)`, `articulation3d_tpu/models/resnet.py:182-185`).

On the tiny 64x80 stage-1 recipe (float32, the oracle's `he_state_dict(0)`):

  * a port step with remat on is bit-equal to the step with it off
    (losses, every gradient, every updated parameter), and the trunk
    checkpoints exactly the blocks that take a gradient (res3-res5 at
    `freeze_at` 2).  Both run on one CPU thread: with more, two runs of
    the same step differ in the last bits of some gradients (the CPU's
    threaded reductions), remat or not;
  * the port's remat step matches JAX's stage-1 step with
    `resnet.remat=True` at `tests/test_torch_train.py::_check_step`'s
    tolerances, with JAX's sampling draws injected;
  * inference with remat set, and a training forward of the frozen trunk
    (stage 3), checkpoint nothing and give the same results.
"""

import dataclasses

import numpy as np
import pytest
import torch

from articulation3d_tpu_torch.models import resnet as presnet
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.train import optimizer as popt
from articulation3d_tpu_torch.train import train_step as pts
from articulation3d_tpu_torch.weights import warm_start
from test_torch_train import _batch, _cfgs, _check_step, _port_step, _run
from torch_oracle import he_state_dict

REMAT = {"resnet": {"remat": True}}


@pytest.fixture(scope="module")
def oracle():
    return he_state_dict(0)


class _CountCheckpoints:
    """Counts `torch.utils.checkpoint` calls of the trunk."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = presnet.checkpoint

        def counted(*a, **kw):
            self.n += 1
            return orig(*a, **kw)

        monkeypatch.setattr(presnet, "checkpoint", counted)


def _model(pc, oracle):
    """The stage's model with the oracle's weights (the keys it has)."""
    model = build_model(pc, device="cpu")
    warm_start(model, oracle)
    return model


def _port_run(pc, oracle):
    model = _model(pc, oracle).train()
    opt, sched = popt.build_optimizer(pc, model)
    metrics = pts.train_step(model, opt, sched, pts.to_device(_batch(), "cpu"),
                             torch.Generator().manual_seed(0))
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return model, metrics, grads


def test_remat_step_is_bit_equal(oracle, monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _remat_step_is_bit_equal(oracle, monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _remat_step_is_bit_equal(oracle, monkeypatch):
    _, off_cfg = _cfgs("step1_bbox")
    _, on_cfg = _cfgs("step1_bbox", REMAT)
    assert on_cfg.model.resnet.remat and not off_cfg.model.resnet.remat
    count = _CountCheckpoints(monkeypatch)
    off, m_off, g_off = _port_run(off_cfg, oracle)
    assert count.n == 0
    on, m_on, g_on = _port_run(on_cfg, oracle)
    assert count.n == 4 + 6 + 3                      # res3-res5; res2 is frozen
    assert m_on.keys() == m_off.keys()
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    assert g_on.keys() == g_off.keys() and any(
        n.startswith("backbone.bottom_up.res3") for n in g_on)
    for n in g_off:
        assert torch.equal(g_on[n], g_off[n]), n
    for (n, a), b in zip(on.named_parameters(), off.parameters()):
        assert torch.equal(a, b), n


@pytest.fixture(scope="module")
def stage1_remat(oracle):
    return _run(oracle, "step1_bbox", REMAT)


def test_remat_step_matches_jax(stage1_remat, monkeypatch):
    """JAX's stage-1 step with `resnet.remat=True` against the port's remat
    step, at `_check_step`'s tolerances."""
    assert stage1_remat["jc"].model.resnet.remat
    count = _CountCheckpoints(monkeypatch)
    model, metrics = _port_step(stage1_remat)
    assert count.n == 13
    _check_step(stage1_remat, model, metrics)
    assert float(model.backbone.bottom_up.res3[0].conv1.weight.grad.abs().max()) > 0


def test_remat_leaves_inference_and_frozen_trunk_alone(oracle, monkeypatch):
    _, off_cfg = _cfgs("step3_plane")
    _, on_cfg = _cfgs("step3_plane", REMAT)
    count = _CountCheckpoints(monkeypatch)
    images = torch.from_numpy(np.random.RandomState(1).randn(2, 64, 80, 3).astype(np.float32))
    out = {}
    for tag, cfg in (("off", off_cfg), ("on", on_cfg)):
        model = _model(cfg, oracle)
        with torch.no_grad():
            det = model.inference(images)["detections"]
        # stage 3 freezes the backbone: its training forward takes no gradient
        popt.freeze_mask(model, cfg.model.freeze)
        model.train()
        losses = pts.compute_losses(model, pts.to_device(_batch(), "cpu"),
                                    torch.Generator().manual_seed(0))
        out[tag] = (det, losses)
    assert count.n == 0
    for f in dataclasses.fields(out["off"][0]):
        a, b = getattr(out["on"][0], f.name), getattr(out["off"][0], f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    for k, v in out["off"][1].items():
        assert torch.equal(out["on"][1][k], v), k
