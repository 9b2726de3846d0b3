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

The host side alone (no JAX): a stand-in step sends random packed mask
bits at a width that is not a multiple of 8, and every `FramePrediction`
field and depth must equal, byte for byte, what unpacking every slot and
then trimming gives.
"""

import itertools

import numpy as np
import pytest
import torch

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


def _sent_chunk(rs, b, d, h, w, kept):
    """What the step sends for one chunk: random detections and packed mask
    bits (the last byte's spare bits random too); `kept` picks the slots
    that pass `valid` and a 0.5 threshold: "empty", "partial" or "full"."""
    scores = rs.uniform(0.0, 1.0, (b, d)).astype(np.float32)
    valid = rs.uniform(0.0, 1.0, (b, d)) < 0.7
    if kept == "empty":
        valid[:] = False
    elif kept == "full":
        valid[:] = True
        scores[:] = 1.0
    f32 = lambda *s: rs.normal(size=s).astype(np.float32)
    return {"boxes": f32(b, d, 4), "scores": scores,
            "classes": rs.randint(0, 3, (b, d)).astype(np.int64), "valid": valid,
            "planes": f32(b, d, 3), "rot_axis": f32(b, d, 3), "tran_axis": f32(b, d, 2),
            "full_masks_packed": rs.randint(0, 256, (b, d, h, -(-w // 8))).astype(np.uint8),
            "depth_mm": rs.randint(0, 70000, (b, h, w)).astype(np.int32)}


@pytest.mark.parametrize("kept", ["empty", "partial", "full"])
def test_pipeline_unpacks_kept_masks_like_unpacking_every_slot(kept):
    """Trimming first and unpacking the kept rows once gives the bytes of
    `np.unpackbits(all).astype(bool)[i][idx]` (every slot unpacked), as a bool
    (len(idx), H, W) array per frame that no other frame shares; the
    padded repeat of the last chunk is never read."""
    out_w, d, thr = 77, 6, 0.5
    pipe = VideoPipeline(_cfg(pcfg), torch.nn.Linear(1, 1), batch_size=2,
                         conf_threshold=thr, output_width=out_w, device="cpu")
    rs = np.random.RandomState(["empty", "partial", "full"].index(kept))
    sent = []

    def step(batch):
        sent.append(_sent_chunk(rs, batch.shape[0], d, H, out_w, kept))
        return {k: torch.from_numpy(v) for k, v in sent[-1].items()}

    pipe.step = step
    frames = [np.full((H, W, 3), i, np.uint8) for i in range(3)]
    preds = pipe.run(frames)
    assert len(sent) == 2 and len(preds) == len(pipe.depths) == 3
    for f, (p, depth) in enumerate(zip(preds, pipe.depths)):
        out, i = sent[f // 2], f % 2
        idx = np.nonzero(out["valid"][i] & (out["scores"][i] > thr))[0]
        masks = np.unpackbits(out["full_masks_packed"], axis=-1,
                              count=out_w).astype(bool)[i][idx]
        assert p.masks.dtype == bool and p.masks.shape == (len(idx), H, out_w)
        assert p.masks.flags.c_contiguous
        assert p.masks.tobytes() == masks.tobytes()
        for key in ("boxes", "scores", "classes", "planes", "rot_axis", "tran_axis"):
            assert getattr(p, key).tobytes() == out[key][i][idx].tobytes(), key
        ref = out["depth_mm"].astype(np.uint16).astype(np.float32) / 1000.0
        assert depth.dtype == np.float32 and depth.tobytes() == ref[i].tobytes()
    n = [len(p) for p in preds]
    assert n == [0, 0, 0] if kept == "empty" else (
        n == [d] * 3 if kept == "full" else 0 < sum(n) < 3 * d)
    for a, b in itertools.combinations(preds, 2):
        assert not np.shares_memory(a.masks, b.masks)
