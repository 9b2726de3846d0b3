"""Port vs JAX: one tiny stage-3 training step with the refine head on.

`configs/step3_plane.yaml` at 64x80 (float32, 2 images, 8 ROIs and 8
detections per image, the refine head at 32x40) starts from the same
weights in both packages: the oracle's `he_state_dict` (mask logits
softened, `tests/test_torch_refine.py`) ported into JAX, the refine head's
parameters drawn with numpy in flax's layout, and all of it carried to the
port through `state_dict_from_jax`; JAX's sampling draws are injected into
the port (`tests/test_torch_train.py`).  The refine cascade runs without
gradient on the sampled proposals (fast R-CNN inference, the mask and
plane pools and heads) and feeds the refine head, whose loss is
`refine_loss`.  Its own gradients on identical inputs are held within
1e-4 in `tests/test_torch_refine.py`; here the JAX step also hands out the
cascade's outputs (the refine pass's detections and depth, through
`jax.debug.callback`), and the port's step run on them shows where the
whole step's gradient gap comes from.
"""

import dataclasses

import os

import numpy as np
import pytest
import torch

import jax

from articulation3d_tpu import config as jcfg

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
from articulation3d_tpu_torch.weights import state_dict_from_jax
from test_torch_refine import _close, _jax_variables
from test_torch_train import JaxPlaneRCNN, _batch, _jax_step, _port_step
from torch_oracle import he_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 80


def _train_cfgs():
    over = {"model": {"rpn": {"pre_nms_topk_train": 32, "post_nms_topk_train": 16},
                      "roi_heads": {"batch_size_per_image": 8, "detections_per_image": 8,
                                    "score_thresh_test": 0.0},
                      "depth_head": {"output_height": H, "output_width": W},
                      "refine_head": {"height": 32, "width": 40},
                      "refine_on": True, "dtype": "float32"},
            "input": {"height": H, "width": W},
            "solver": {"ims_per_batch": 2, "base_lr": 0.002, "warmup_factor": 1.0},
            "weights": ""}
    path = os.path.join(ROOT, "configs", "step3_plane.yaml")
    return jcfg.load_config(path, over), pcfg.load_config(path, over)


@pytest.fixture(scope="module")
def train_parity():
    jc, pc = _train_cfgs()
    sd = he_state_dict(0)
    sd["roi_heads.mask_head.predictor.weight"] = (
        sd["roi_heads.mask_head.predictor.weight"] * 0.02).astype(np.float32)
    params, batch_stats = _jax_variables(jc, sd, refine_pred_bias=2.0)
    batch, key = _batch(), jax.random.PRNGKey(11)
    cascade = {}
    refine = JaxPlaneRCNN._refine

    def recording_refine(self, images, dets, depth):
        jax.debug.callback(lambda **kw: cascade.update(
            {k: np.array(v) for k, v in kw.items()}), boxes=dets.boxes, scores=dets.scores,
            valid=dets.valid, masks=dets.masks, planes=dets.planes, depth=depth)
        return refine(self, images, dets, depth)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPlaneRCNN, "_refine", recording_refine)
        j = _jax_step(jc, params, batch_stats, batch, key)
    run = dict(jc=jc, pc=pc, sd=state_dict_from_jax(params, batch_stats), batch=batch,
               key=key, j=j, cascade=cascade)
    model, metrics = _port_step(run)
    return dict(run, model=model, metrics=metrics)


def _refine_grads_close(model, j, tol):
    jgrad = state_dict_from_jax(j["grads"])
    names = [n for n, _ in model.named_parameters() if n.startswith("refine_head.")]
    assert len(names) == 26
    for name, prm in model.named_parameters():
        if name.startswith("refine_head."):
            ref = jgrad[name]
            assert float(np.abs(ref).max()) > 0, name
            _close(prm.grad.numpy(), ref, tol)


def test_refine_train_step_matches_jax(train_parity):
    """Every loss within 1e-4 relative, `refine_loss` included, and the
    refine head's gradients within 2e-2 x max |JAX| of each tensor: the
    cascade's detections come out of two float32 stacks (boxes 3.4e-4 px
    apart after the box decode, mask probabilities 1.6e-5, planes 1.9e-5),
    the pasted soft masks move with the boxes at their edges, and the
    random-weight U-Net's gradients move with them by 1.26e-2 of their
    size (measured).  `test_refine_step_on_jax_cascade_matches_jax` is the
    witness: on JAX's cascade outputs the same gradients agree within
    2.2e-6."""
    j, metrics, model = train_parity["j"], train_parity["metrics"], train_parity["model"]
    assert "refine_loss" in j["losses"] and j["losses"]["refine_loss"] > 0
    got = {k: float(v) for k, v in metrics.items() if k != "total_loss"}
    assert set(got) == set(j["losses"])
    for k, v in j["losses"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    _refine_grads_close(model, j, 2e-2)


def test_refine_step_on_jax_cascade_matches_jax(train_parity):
    """The port's step with the refine pass fed JAX's cascade outputs (its
    detections, and its depth values on the port's depth graph, so the
    depth head keeps its gradient path): the cascade's own inputs agree
    (mask probabilities and planes within 1e-4, boxes within 1e-2 px,
    depth within 1e-4 relative), and the refine head's gradients then fall
    to within 1e-4 x max |JAX| (measured 2.2e-6): the whole step's 2e-2
    is the float32 gap of the cascade in front of the head, not the head."""
    cascade = train_parity["cascade"]
    t = lambda k: torch.from_numpy(cascade[k])
    refine = PlaneRCNN._refine
    gaps = {}

    def injected(self, images, dets, depth):
        for k in ("boxes", "masks", "planes"):
            gaps[k] = float((getattr(dets, k) - t(k)).abs().max())
        gaps["depth"] = float((depth.detach() - t("depth")).abs().max() / t("depth").abs().max())
        dets = dataclasses.replace(dets, boxes=t("boxes"), scores=t("scores"),
                                   valid=t("valid"), masks=t("masks"), planes=t("planes"))
        return refine(self, images, dets, depth + (t("depth") - depth).detach())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PlaneRCNN, "_refine", injected)
        model, metrics = _port_step(train_parity)
    assert gaps["boxes"] <= 1e-2 and gaps["depth"] <= 1e-4, gaps
    assert gaps["masks"] <= 1e-4 and gaps["planes"] <= 1e-4, gaps
    np.testing.assert_allclose(float(metrics["refine_loss"]),
                               train_parity["j"]["losses"]["refine_loss"], rtol=1e-5)
    _refine_grads_close(model, train_parity["j"], 1e-4)


def test_refine_cascade_through_the_kernel_route(train_parity):
    """The same step with the "cuda" pooler (K1's and K2's plain versions on
    CPU tensors): the cascade's no-grad pools go through the training
    pooler's forward alone, and every loss still matches JAX within 1e-4
    relative (at 64x80 no ROI leaves its detectron2 level)."""
    model, metrics = _port_step(train_parity, impl="cuda")
    for k, v in train_parity["j"]["losses"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4, err_msg=k)
    assert all(p.grad is None or bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
