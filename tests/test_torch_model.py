"""Whole-model parity of the port's PlaneRCNN, on the CPU in float32.

1. Against JAX `PlaneRCNN.inference_probe` at the tiny config of
   `tests/test_goldens.py` (64x80, 32 proposals, 8 detections, score
   threshold 0, JAX pooler "xla", port pooler "torch"), one set of weights:
   the oracle's `he_state_dict` ported into JAX, then back through
   `state_dict_from_jax`.  Tolerances: features and depth 2e-4 x (1 + max
   |ref|), as `tests/test_torch_oracle.py` sets them for two float32
   stacks that sum a 50-layer trunk in different orders; detections must
   all match (IoU >= 0.7) within 1e-2 px and their head outputs within
   1e-3 x (1 + max |ref|) (the heads' random weights amplify the trunk's
   float32 differences: measured 7e-4 relative on the axis offsets); mask
   probabilities within 1e-2, because the random weights drive
   mask logits to |x| ~ 30 where the sigmoid's slope turns float32
   differences of the logits into up to 2.3e-3 (measured).
2. Against the committed `tests/fixtures/golden_oracle_64x96.npz` at the
   tolerances of `tests/test_goldens.py:124-150`.
3. The kernel path's plain version ("cuda" pooler on CPU tensors), the
   EVAL_GT_BOX branch and `share_detection_pool` inside the whole model.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import torch

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.evaluation.goldens import (load_goldens,
                                                   match_detections, run_probe)
from articulation3d_tpu.models.planercnn import PlaneRCNN as JaxPlaneRCNN
from articulation3d_tpu.train.checkpoint import port_detectron2_state_dict

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.ops.preprocess import preprocess_images
from articulation3d_tpu_torch.weights import state_dict_from_jax
from torch_oracle import bias_state_dict_for_detections, he_state_dict

H, W = 64, 80
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_oracle_64x96.npz")


def _cfgs(h, w, topk, dets, score_thresh, impl="torch"):
    def build(m):
        model = m.ModelConfig(
            rpn=m.RPNConfig(pre_nms_topk_test=topk, post_nms_topk_test=topk),
            roi_heads=m.ROIHeadsConfig(detections_per_image=dets,
                                       score_thresh_test=score_thresh),
            depth_head=m.DepthHeadConfig(output_height=h, output_width=w),
            dtype="float32",
            roi_pooler_impl="xla" if m is jcfg else impl)
        return m.Config(model=model, input=m.InputConfig(height=h, width=w))
    return build(jcfg), build(pcfg)


def _port_run(cfg, state_dict, image, **kw):
    model = build_model(cfg, device="cpu", state_dict=state_dict)
    images = preprocess_images(torch.from_numpy(image[None]), height=cfg.input.height,
                               width=cfg.input.width)
    return model, model.inference(images, **kw)


def _scale_atol(ref, scale=2e-4):
    return scale * (1.0 + float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def parity():
    jc, pc = _cfgs(H, W, 32, 8, 0.0)
    shapes = jax.eval_shape(
        lambda r: JaxPlaneRCNN(jc).init(r, jax.numpy.zeros((1, H, W, 3)),
                                        method=JaxPlaneRCNN.inference),
        jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, batch_stats, stats = port_detectron2_state_dict(
        he_state_dict(0), zeros["params"], zeros["batch_stats"])
    assert stats["skipped"] == 0 and stats["unmapped"] == 0
    image = np.random.RandomState(1).randint(0, 255, (H, W, 3)).astype(np.uint8)
    j = run_probe(jc, {"params": params, "batch_stats": batch_stats}, image)
    sd = state_dict_from_jax(params, batch_stats)
    model, p = _port_run(pc, sd, image)
    return dict(j=j, p=p, model=model, sd=sd, image=image, cfg=pc)


def test_features_match_jax(parity):
    j, p = parity["j"], parity["p"]
    for k in ("p2", "p3", "p4", "p5", "p6"):
        ref = j["features"][k][0].transpose(2, 0, 1)
        got = p["features"][k][0].numpy()
        assert got.shape == ref.shape, k
        np.testing.assert_allclose(got, ref, rtol=0, atol=_scale_atol(ref), err_msg=k)


def test_proposals_match_jax(parity):
    j, p = parity["j"], parity["p"]
    jv = j["proposal_valid"][0]
    pv = p["proposals"]["valid"][0].numpy()
    assert pv.sum() == jv.sum() > 0
    ref, got = j["proposal_boxes"][0][jv], p["proposals"]["boxes"][0].numpy()[pv]
    ri, oi = match_detections(ref, got, iou_thresh=0.9)
    assert len(ri) == len(ref)
    np.testing.assert_allclose(got[oi], ref[ri], rtol=0, atol=1e-2)
    np.testing.assert_allclose(p["proposals"]["scores"][0].numpy()[pv][oi],
                               j["proposal_logits"][0][jv][ri], rtol=0,
                               atol=_scale_atol(j["proposal_logits"][0][jv]))


def test_detections_and_heads_match_jax(parity):
    jd, pd = parity["j"]["detections"], parity["p"]["detections"]
    jv, pv = jd.valid[0], pd.valid[0].numpy()
    assert pv.sum() == jv.sum() > 0
    ri, oi = match_detections(jd.boxes[0][jv], pd.boxes[0].numpy()[pv])
    assert len(ri) == jv.sum()
    sel = lambda t: t[0].numpy()[pv][oi]
    np.testing.assert_allclose(sel(pd.boxes), jd.boxes[0][jv][ri], rtol=0, atol=1e-2)
    np.testing.assert_array_equal(sel(pd.classes), jd.classes[0][jv][ri])
    for key in ("scores", "masks", "planes", "rot_axis", "tran_axis"):
        ref = getattr(jd, key)[0][jv][ri]
        atol = 1e-2 if key == "masks" else _scale_atol(ref, 1e-3)
        np.testing.assert_allclose(sel(getattr(pd, key)), ref, rtol=0, atol=atol,
                                   err_msg=key)


def test_depth_matches_jax(parity):
    ref = parity["j"]["depth"][0]
    got = parity["p"]["depth"][0].numpy()
    assert got.shape == (H, W)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_scale_atol(ref))


def test_kernel_path_plain_version_matches_torch_pooler(parity):
    """The "cuda" pooler on CPU tensors (the kernel's plain version) gives
    the detections of the gather pooler: same pooled values up to float32
    rounding (tests/test_torch_roi_align.py)."""
    cfg = parity["cfg"]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, roi_pooler_impl="cuda"))
    _, out = _port_run(cfg, parity["sd"], parity["image"])
    a, b = parity["p"]["detections"], out["detections"]
    np.testing.assert_array_equal(a.valid.numpy(), b.valid.numpy())
    v = a.valid   # the kernel path pools invalid rows to zeros, the gather path does not
    for key in ("boxes", "scores", "masks", "planes", "rot_axis", "tran_axis"):
        torch.testing.assert_close(getattr(b, key)[v], getattr(a, key)[v], rtol=0,
                                   atol=1e-3, msg=key)


def test_eval_gt_box_branch_reproduces_cascade(parity):
    """Feeding the detections back as GT boxes re-runs the same cascade."""
    d = parity["p"]["detections"]
    model = parity["model"]
    images = preprocess_images(torch.from_numpy(parity["image"][None]),
                               height=H, width=W)
    out = model.inference(images, gt_boxes=d.boxes, gt_classes=d.classes,
                          gt_valid=d.valid)["detections"]
    v = d.valid[0]
    assert bool(out.scores[0][v].eq(1.0).all())
    for key in ("masks", "planes", "rot_axis", "tran_axis"):
        torch.testing.assert_close(getattr(out, key)[0][v], getattr(d, key)[0][v],
                                   rtol=0, atol=1e-5, msg=key)


def test_share_detection_pool(parity):
    model = parity["model"]
    cfg = parity["cfg"]
    model.config = cfg.replace(model=dataclasses.replace(cfg.model,
                                                         share_detection_pool=True))
    try:
        images = preprocess_images(torch.from_numpy(parity["image"][None]),
                                   height=H, width=W)
        out = model.inference(images)
    finally:
        model.config = cfg
    assert set(out["pool_valid"]) == {"box", "shared"}
    d, ref = out["detections"], parity["p"]["detections"]
    torch.testing.assert_close(d.planes, ref.planes, rtol=0, atol=1e-6)
    assert d.masks.shape == ref.masks.shape


def test_golden_fixture_64x96():
    """The committed oracle fixture at tests/test_goldens.py tolerances."""
    g = load_goldens(FIXTURE)
    h, w = g["image"].shape[:2]
    _, cfg = _cfgs(h, w, int(g["meta_topk"]), int(g["meta_dets"]),
                   float(g["meta_score_thresh"]))
    sd = he_state_dict(int(g["meta_weights_seed"]))
    if int(g.get("meta_bias", 0)):
        sd = bias_state_dict_for_detections(sd)
    _, out = _port_run(cfg, sd, g["image"])
    for k in ("p2", "p3", "p4", "p5", "p6"):
        assert np.abs(out["features"][k][0].numpy() - g[k]).max() < 0.02, k
    pv = out["proposals"]["valid"][0].numpy()
    ours = out["proposals"]["boxes"][0].numpy()[pv]
    n = min(len(g["proposal_boxes"]), len(ours), 100)
    ri, _ = match_detections(g["proposal_boxes"][:n], ours[:n], iou_thresh=0.9)
    assert len(ri) / max(n, 1) >= 0.9
    d = out["detections"]
    keep = (d.valid[0] & (d.scores[0] > 0.05)).numpy()
    ref_keep = g["det_scores"] > 0.05
    assert ref_keep.sum() >= 1
    ri, oi = match_detections(g["det_boxes"][ref_keep], d.boxes[0].numpy()[keep])
    assert len(ri) == ref_keep.sum()
    got = lambda t: t[0].numpy()[keep][oi]
    assert np.abs(got(d.boxes) - g["det_boxes"][ref_keep][ri]).max() < 0.05
    for field, key in (("pred_masks", "masks"), ("pred_planes", "planes"),
                       ("pred_rot_axis", "rot_axis"), ("pred_tran_axis", "tran_axis")):
        assert np.abs(got(getattr(d, key)) - g[field][ref_keep][ri]).max() < 0.05, key
    depth = g["depth"]
    assert np.abs(out["depth"][0].numpy() - depth).max() < 2e-4 * (1 + np.abs(depth).max())
