"""Port vs JAX: the stage-3 training step and the frozen parameter sets.

The helpers and tolerances are those of `tests/test_torch_train.py`; this
file holds the stage-3 recipe's step (mask, plane and depth losses, the
elementwise clip, the depth head's train-mode BatchNorm) and the
frozen-set check of all three recipes, so that its JAX compiles run in
another xdist worker than the stage-1 step's.
"""

import jax
import numpy as np
import pytest

from articulation3d_tpu.train import optimizer as jopt

from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
from articulation3d_tpu_torch.train import optimizer as popt
from articulation3d_tpu_torch.weights import state_dict_from_jax
from test_torch_train import _cfgs, _check_step, _jax_zeros, _port_step, _run
from torch_oracle import he_state_dict


@pytest.fixture(scope="module")
def stage3():
    return _run(he_state_dict(0), "step3_plane", clip_gradients=True, clip_value=0.05)


def test_stage3_step_matches_jax(stage3):
    """The stage-3 recipe: frozen detector and axis head; mask, plane and
    depth losses (and the axis head's, which stage 3 freezes, not at all),
    the elementwise clip, and the depth head's BatchNorm statistics."""
    model, metrics = _port_step(stage3)
    jnew = _check_step(stage3, model, metrics)
    assert set(stage3["j"]["losses"]) == {"loss_mask", "loss_plane", "depth_loss"}
    bns = [n for n, _ in model.named_buffers() if n.startswith("depth_head")
           and n.endswith(("running_mean", "running_var"))]
    assert len(bns) == 20
    state = model.state_dict()
    for n in bns:
        ref = jnew[n]
        assert not np.allclose(ref, stage3["sd"][n])             # the step moved them
        np.testing.assert_allclose(state[n].numpy(), ref, rtol=0,
                                   atol=1e-4 * (1 + float(np.abs(ref).max())), err_msg=n)


@pytest.mark.parametrize("stage", ["step1_bbox", "step2_axis", "step3_plane"])
def test_frozen_set_matches_jax(stage):
    jc, pc = _cfgs(stage)
    params = _jax_zeros(stage)["params"]
    flags = jax.tree_util.tree_map(lambda t, x: np.full(np.shape(x), float(t), np.float32),
                                   jopt.freeze_mask(params, jc.model.freeze), params)
    jax_trainable = {k: bool(v.reshape(-1)[0]) for k, v in state_dict_from_jax(flags).items()
                     if v.size}
    model = PlaneRCNN(pc)
    mask = popt.freeze_mask(model, pc.model.freeze)
    at = pc.model.resnet.freeze_at
    by_freeze_at = lambda n: n.startswith("backbone.bottom_up.stem") or any(
        n.startswith(f"backbone.bottom_up.res{i}.") for i in range(2, at + 1))
    assert set(mask) <= set(jax_trainable)
    for name, trainable in mask.items():
        assert trainable == (jax_trainable[name] and not by_freeze_at(name)), name
    assert any(mask.values()) and not all(mask.values())
    assert all(not p.requires_grad for n, p in model.named_parameters() if not mask[n])
