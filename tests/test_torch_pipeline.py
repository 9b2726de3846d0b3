"""Port vs JAX: `VideoPipeline.run` end to end, on the CPU in float32.

Three synthetic frames at batch 2 (so the second chunk is padded with a
repeat), the tiny config of `tests/test_goldens.py` and one set of weights
(the oracle's `he_state_dict`, through the JAX porter and back).  Both
pipelines must give the same `FramePrediction`s after confidence trimming
and the depth-based plane-offset override.  Tolerances: boxes 1e-2 px;
scores, planes and axes 1e-3 x (1 + max |ref|) (the whole-model drift of
`tests/test_torch_model.py`); pasted masks may differ on at most 0.1% of
pixels (soft values at the 0.5 threshold); depth within 1 mm of the u16
millimetre encoding plus the same relative drift.
"""

import numpy as np
import pytest

import jax

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.models.planercnn import PlaneRCNN as JaxPlaneRCNN
from articulation3d_tpu.train.checkpoint import port_detectron2_state_dict
from articulation3d_tpu.video.pipeline import VideoPipeline as JaxPipeline

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.video.pipeline import VideoPipeline
from articulation3d_tpu_torch.weights import state_dict_from_jax
from torch_oracle import he_state_dict

H, W = 64, 80


def _cfg(m):
    model = m.ModelConfig(
        rpn=m.RPNConfig(pre_nms_topk_test=32, post_nms_topk_test=32),
        roi_heads=m.ROIHeadsConfig(detections_per_image=8, score_thresh_test=0.0),
        depth_head=m.DepthHeadConfig(output_height=H, output_width=W),
        dtype="float32", roi_pooler_impl="xla" if m is jcfg else "auto")
    return m.Config(model=model, input=m.InputConfig(height=H, width=W))


@pytest.fixture(scope="module")
def pipelines():
    jc = _cfg(jcfg)
    jmodel = JaxPlaneRCNN(jc)
    shapes = jax.eval_shape(
        lambda r: jmodel.init(r, jax.numpy.zeros((1, H, W, 3)),
                              method=JaxPlaneRCNN.inference), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, batch_stats, _ = port_detectron2_state_dict(
        he_state_dict(0), zeros["params"], zeros["batch_stats"])
    jpipe = JaxPipeline(jc, jmodel, {"params": params, "batch_stats": batch_stats},
                        batch_size=2, conf_threshold=0.0)
    pc = _cfg(pcfg)
    model = build_model(pc, device="cpu",
                        state_dict=state_dict_from_jax(params, batch_stats))
    ppipe = VideoPipeline(pc, model, batch_size=2, conf_threshold=0.0, device="cpu")
    rs = np.random.RandomState(3)
    frames = [rs.randint(0, 255, (H, W, 3)).astype(np.uint8) for _ in range(3)]
    return jpipe, ppipe, frames


def _atol(ref, scale=1e-3):
    return scale * (1.0 + float(np.abs(ref).max())) if ref.size else scale


def _assert_same(jpreds, ppreds):
    assert len(jpreds) == len(ppreds) == 3
    for j, p in zip(jpreds, ppreds):
        assert len(p) == len(j)
        np.testing.assert_allclose(p.boxes, j.boxes, rtol=0, atol=1e-2)
        np.testing.assert_array_equal(p.classes, j.classes)
        for key in ("scores", "planes", "rot_axis", "tran_axis"):
            ref = getattr(j, key)
            np.testing.assert_allclose(getattr(p, key), ref, rtol=0, atol=_atol(ref),
                                       err_msg=key)
        assert p.masks.shape == j.masks.shape == (len(j), H, W)
        assert p.masks.dtype == bool
        assert np.mean(p.masks != j.masks) <= 1e-3 if len(j) else True


def test_pipeline_matches_jax(pipelines):
    jpipe, ppipe, frames = pipelines
    jpreds = jpipe.run(frames)
    ppreds = ppipe.run(frames)
    assert len(ppipe.chunk_walls) == 2
    assert ppipe.pool_valid["box"] > 0 and ppipe.pool_valid["mask"] > 0
    _assert_same(jpreds, ppreds)
    assert sum(len(p) for p in ppreds) > 0
    for jd, pd in zip(jpipe.depths, ppipe.depths):
        assert pd.shape == (H, W)
        np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-3 + _atol(jd))


def test_pipeline_conf_threshold_trims_like_jax(pipelines):
    jpipe, ppipe, frames = pipelines
    all_scores = np.concatenate([p.scores for p in ppipe.run(frames)])
    thr = float(np.median(all_scores))
    jpipe.conf_threshold = ppipe.conf_threshold = thr
    try:
        jpreds, ppreds = jpipe.run(frames), ppipe.run(frames)
    finally:
        jpipe.conf_threshold = ppipe.conf_threshold = 0.0
    assert 0 < sum(len(p) for p in ppreds) < len(all_scores)
    assert all((p.scores > thr).all() for p in ppreds)
    _assert_same(jpreds, ppreds)


def test_pipeline_pads_last_chunk_with_repeats(pipelines):
    """The padded repeat in chunk 2 must not leak into the predictions:
    frame 2 alone (batch 2 = frame + its repeat) predicts the same."""
    _, ppipe, frames = pipelines
    full = ppipe.run(frames)
    alone = ppipe.run(frames[2:])
    assert len(alone) == 1
    np.testing.assert_array_equal(alone[0].boxes, full[2].boxes)
    np.testing.assert_array_equal(alone[0].masks, full[2].masks)
