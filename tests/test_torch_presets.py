"""The port's presets and last public helpers against the JAX package.

1. `serving_config`, `step1_bbox_config`, `step2_axis_config` and
   `step3_plane_config` equal JAX's field for field.
2. The serving contract (JAX `config.py::serving_config`,
   tests/test_serving_parity.py) in the port, at 128x160 in float32 on two
   uint8 noise frames, with the oracle's He weights biased for detections
   and score threshold 0.  Parity keeps `inference_config`'s 100
   detections per image and serving `serving_config`'s 30; the post-NMS
   caps are scaled down (parity 64, serving 32) so that a 128x160 frame can
   overrun them.  Pre-NMS 48 per level leaves 25 and 27 RPN survivors per
   frame, under both caps (unsaturated: the serving detections must be
   parity's top 30 exactly); pre-NMS 256 overruns both (saturated: every
   matched pair exact, at least 95 % of the serving detections matched).
   JAX's gates: box 1e-2 px, score 1e-4, mask 1e-4; the depth equal.
3. One anchor against JAX: `serving_config` in both packages at 64x80 with
   serving-shaped caps (pre-NMS 128 per level, 23 RPN survivors, post-NMS
   16, 8 detections), the He weights placed into JAX's tree by the d2 key
   map and brought back by `state_dict_from_jax`, through JAX's `run_probe`
   and the port's, at the tolerances of tests/test_torch_model.py.
4. Each helper of `structures.py`, `ops/preprocess.py::sem_seg_postprocess`,
   `utils/camera.py`'s `get_pcd_depth` and `precompute_K_inv_dot_xy_1`,
   `data/axis_codec.py::axis_to_angle_offset_torch`,
   `models/depth_head.py::depth_l1_loss_masked` and
   `evaluation/serving_contract.py::match_detections` against the JAX
   function on the same seeded numpy inputs: exact where the arithmetic is elementwise and
   unfused, within 1e-6 relative for the resize, the camera rays, the depth
   loss's sum and the axis codec (XLA fuses its products into multiply-adds).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from articulation3d_tpu import config as jcfg
from articulation3d_tpu import structures as jstruct
from articulation3d_tpu.data.axis_codec import axis_to_angle_offset_jnp
from articulation3d_tpu.evaluation.goldens import match_detections as iou_match
from articulation3d_tpu.evaluation.goldens import run_probe as jax_run_probe
from articulation3d_tpu.models.depth_head import depth_l1_loss_masked as jdepth_loss
from articulation3d_tpu.ops.preprocess import sem_seg_postprocess as jsem_seg
from articulation3d_tpu.utils import camera as jcam
from articulation3d_tpu.utils.debug_weights import match_detections as jmatch

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch import structures as pstruct
from articulation3d_tpu_torch.data.axis_codec import axis_to_angle_offset_torch
from articulation3d_tpu_torch.evaluation.goldens import run_probe
from articulation3d_tpu_torch.evaluation.serving_contract import match_detections
from articulation3d_tpu_torch.models.depth_head import depth_l1_loss_masked
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.ops.preprocess import preprocess_images, sem_seg_postprocess
from articulation3d_tpu_torch.utils import camera as pcam
from articulation3d_tpu_torch.weights import bias_for_detections, state_dict_from_jax
from test_torch_trainer_data import _jax_variables
from torch_oracle import he_state_dict

PRESETS = ("serving_config", "step1_bbox_config", "step2_axis_config",
           "step3_plane_config")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_jax(name):
    got, want = getattr(pcfg, name)(), getattr(jcfg, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_serving_preset_trims_only_the_two_caps():
    inf, srv = pcfg.inference_config(), pcfg.serving_config()
    assert (srv.model.rpn.post_nms_topk_test, srv.model.roi_heads.detections_per_image) == (500, 30)
    assert srv.replace(model=dataclasses.replace(
        srv.model, rpn=inf.model.rpn, roi_heads=inf.model.roi_heads)) == inf


# --------------------------------------------------------------------------- #
# the serving contract in the port
# --------------------------------------------------------------------------- #

H, W = 128, 160


@pytest.fixture(scope="module")
def he_weights():
    return he_state_dict(0)


def _sized(base, h, w, pre, post, dets=None, score_thresh=0.0):
    m = base.model
    heads = dataclasses.replace(m.roi_heads, score_thresh_test=score_thresh,
                                **({} if dets is None else {"detections_per_image": dets}))
    return base.replace(
        input=dataclasses.replace(base.input, height=h, width=w),
        model=dataclasses.replace(
            m, dtype="float32",
            roi_pooler_impl="xla" if isinstance(m, jcfg.ModelConfig) else "torch",
            rpn=dataclasses.replace(m.rpn, pre_nms_topk_test=pre, post_nms_topk_test=post),
            roi_heads=heads,
            depth_head=dataclasses.replace(m.depth_head, output_height=h, output_width=w)))


@pytest.fixture(scope="module")
def contract_runs(he_weights):
    sd = bias_for_detections(he_weights)
    frames = np.random.RandomState(7).randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    images = preprocess_images(torch.from_numpy(frames), height=H, width=W)
    runs = {}
    for regime, pre in (("unsaturated", 48), ("saturated", 256)):
        for name, base, post in (("parity", pcfg.inference_config(), 64),
                                 ("serving", pcfg.serving_config(), 32)):
            model = build_model(_sized(base, H, W, pre, post), device="cpu", state_dict=sd)
            with torch.no_grad():
                out = model.inference(images)
            d = out["detections"]
            r = {k: getattr(d, k).numpy() for k in ("boxes", "scores", "classes", "valid",
                                                     "masks")}
            r["rpn_survivors"] = out["proposals"]["valid"].sum(1).numpy()
            r["depth"] = out["depth"].numpy()
            runs[regime, name] = r
    return runs


def test_serving_equals_parity_when_rpn_unsaturated(contract_runs):
    pv, sv = contract_runs["unsaturated", "parity"], contract_runs["unsaturated", "serving"]
    assert (sv["rpn_survivors"] < 32).all(), sv["rpn_survivors"]
    np.testing.assert_array_equal(sv["rpn_survivors"], pv["rpn_survivors"])
    assert sv["valid"].sum() > 0
    m = match_detections(sv, pv, box_tol=1e-2, score_tol=1e-4, mask_tol=1e-4)
    assert m["n_matched"] == m["n_serving"], m
    assert m["n_parity_extra"] == 0, m
    np.testing.assert_array_equal(sv["depth"], pv["depth"])


def test_serving_per_box_identity_when_saturated(contract_runs):
    pv, sv = contract_runs["saturated", "parity"], contract_runs["saturated", "serving"]
    assert (pv["rpn_survivors"] == 64).all(), pv["rpn_survivors"]
    assert (sv["rpn_survivors"] == 32).all(), sv["rpn_survivors"]
    assert sv["valid"].sum() > 0
    m = match_detections(sv, pv, box_tol=1e-2, score_tol=1e-4, mask_tol=1e-4)
    assert m["n_matched"] >= 0.95 * m["n_serving"], m
    assert m["max_box_diff"] <= 1e-2 and m["max_score_diff"] <= 1e-4, m
    np.testing.assert_array_equal(sv["depth"], pv["depth"])


# --------------------------------------------------------------------------- #
# one anchor against JAX
# --------------------------------------------------------------------------- #

def _scale_atol(ref, scale=2e-4):
    return scale * (1.0 + float(np.abs(ref).max()))


def test_serving_preset_matches_jax(he_weights):
    h, w = 64, 80
    jc = _sized(jcfg.serving_config(), h, w, 128, 16, dets=8)
    pc = _sized(pcfg.serving_config(), h, w, 128, 16, dets=8)
    model = build_model(pc, device="cpu", state_dict=he_weights)
    variables = _jax_variables(model)
    image = np.random.RandomState(1).randint(0, 255, (h, w, 3)).astype(np.uint8)
    j = jax_run_probe(jc, variables, image)
    p = run_probe(build_model(pc, device="cpu", state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"])), image)

    jv, pv = j["proposal_valid"][0], p["proposal_valid"][0]
    assert pv.sum() == jv.sum() == 16
    ri, oi = iou_match(j["proposal_boxes"][0][jv], p["proposal_boxes"][0][pv], iou_thresh=0.9)
    assert len(ri) == 16
    np.testing.assert_allclose(p["proposal_boxes"][0][pv][oi], j["proposal_boxes"][0][jv][ri],
                               rtol=0, atol=1e-2)

    jd, pd = j["detections"], p["detections"]
    jv, pv = jd.valid[0], pd.valid[0]
    assert pv.sum() == jv.sum() > 0
    ri, oi = iou_match(jd.boxes[0][jv], pd.boxes[0][pv])
    assert len(ri) == jv.sum()
    np.testing.assert_allclose(pd.boxes[0][pv][oi], jd.boxes[0][jv][ri], rtol=0, atol=1e-2)
    np.testing.assert_array_equal(pd.classes[0][pv][oi], jd.classes[0][jv][ri])
    for key in ("scores", "masks", "planes", "rot_axis", "tran_axis"):
        ref = getattr(jd, key)[0][jv][ri]
        atol = 1e-2 if key == "masks" else _scale_atol(ref, 1e-3)
        np.testing.assert_allclose(getattr(pd, key)[0][pv][oi], ref, rtol=0, atol=atol,
                                   err_msg=key)
    np.testing.assert_allclose(p["depth"][0], j["depth"][0], rtol=0,
                               atol=_scale_atol(j["depth"][0]))


# --------------------------------------------------------------------------- #
# the helpers, one case each
# --------------------------------------------------------------------------- #

RS = np.random.RandomState(3)
DET = {"boxes": RS.uniform(0, 100, (2, 5, 4)).astype(np.float32),
       "scores": RS.uniform(0, 1, (2, 5)).astype(np.float32),
       "classes": RS.randint(0, 2, (2, 5)).astype(np.int32),
       "valid": RS.uniform(0, 1, (2, 5)) > 0.4,
       "masks": RS.uniform(0, 1, (2, 5, 6, 6)).astype(np.float32),
       "planes": RS.randn(2, 5, 3).astype(np.float32),
       "rot_axis": RS.randn(2, 5, 3).astype(np.float32),
       "tran_axis": RS.randn(2, 5, 2).astype(np.float32)}


def _pair(**fields):
    return (jstruct.Detections(**{k: jnp.asarray(v) for k, v in fields.items()}),
            pstruct.Detections(**{k: torch.from_numpy(v) for k, v in fields.items()}))


def _capacity_and_num_valid():
    j, p = _pair(**DET)
    assert p.capacity == j.capacity == 5
    np.testing.assert_array_equal(p.num_valid().numpy(), np.asarray(j.num_valid()))


def _replace_and_asdict():
    j, p = _pair(**{k: DET[k] for k in ("boxes", "scores", "classes", "valid", "planes")})
    new = DET["scores"][::-1].copy()
    jr, pr = j.replace(scores=jnp.asarray(new)), p.replace(scores=torch.from_numpy(new))
    assert list(pr.asdict()) == list(jr.asdict())
    for k, v in jr.asdict().items():
        np.testing.assert_array_equal(pr.asdict()[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(p.scores.numpy(), DET["scores"])


def _empty():
    for kw in ({}, {"with_masks": 28, "planes": True, "axes": True}):
        j, p = jstruct.Detections.empty(7, **kw), pstruct.Detections.empty(7, device="cpu", **kw)
        assert list(p.asdict()) == list(j.asdict())
        for k, v in j.asdict().items():
            got = p.asdict()[k]
            assert tuple(got.shape) == v.shape and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
            assert got.dtype == (torch.int64 if k == "classes" else
                                 torch.bool if k == "valid" else torch.float32)


def _to_host():
    one = {k: v[1] for k, v in DET.items()}
    j, p = _pair(**one)
    jh, ph = j.to_host(), p.to_host()
    assert isinstance(ph, pstruct.HostDetections) and len(ph) == len(jh) == one["valid"].sum()
    for k in ("boxes", "scores", "classes", "masks", "planes", "rot_axis", "tran_axis"):
        np.testing.assert_array_equal(getattr(ph, k), getattr(jh, k))
    assert ph.full_masks is None and jh.full_masks is None
    with pytest.raises(AssertionError):
        _pair(**DET)[1].to_host()


def _pad_to():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 2).astype(np.float32)
    for n, axis, value in ((8, 1, 0), (2, 1, 0), (5, 1, 0), (6, 0, -1.5), (4, -1, 7)):
        np.testing.assert_array_equal(
            pstruct.pad_to(torch.from_numpy(x), n, axis, value).numpy(),
            np.asarray(jstruct.pad_to(jnp.asarray(x), n, axis, value)))


def _sem_seg_postprocess():
    rs = np.random.RandomState(4)
    logits = rs.randn(5, 64, 96).astype(np.float32)
    for img_size, out_hw in (((60, 90), (120, 180)), ((64, 96), (48, 50))):
        want = np.asarray(jsem_seg(jnp.asarray(logits), img_size, *out_hw))
        got = sem_seg_postprocess(torch.from_numpy(logits), img_size, *out_hw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _get_pcd_depth():
    rs = np.random.RandomState(4)
    depth = rs.uniform(0.5, 5.0, (640, 640)).astype(np.float32)
    verts = np.stack([rs.randint(0, 640, 50), rs.randint(0, 480, 50)], 1).astype(np.float32)
    want = np.asarray(jcam.get_pcd_depth(jnp.asarray(verts), jnp.asarray(depth)))
    got = pcam.get_pcd_depth(verts, depth)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _precompute_k_inv_dot_xy_1():
    for h, w in ((480, 640), (120, 200)):
        np.testing.assert_allclose(pcam.precompute_K_inv_dot_xy_1(h, w),
                                   jcam.precompute_K_inv_dot_xy_1(h, w), rtol=1e-6, atol=0)


def _axis_to_angle_offset_torch():
    rs = np.random.RandomState(4)
    axis = rs.uniform(0, 640, (3, 40, 4)).astype(np.float32)
    centers = rs.uniform(0, 640, (3, 40, 2)).astype(np.float32)
    axis[0, :4, 2:] = axis[0, :4, :2]                 # degenerate segments
    centers[1, :4] = axis[1, :4, :2]                  # centre on the line
    want = np.asarray(axis_to_angle_offset_jnp(jnp.asarray(axis), jnp.asarray(centers)))
    got = axis_to_angle_offset_torch(torch.from_numpy(axis), torch.from_numpy(centers)).numpy()
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_array_equal(got[0, :4], want[0, :4])
    np.testing.assert_array_equal(got[1, :4, :2], 0)
    # XLA contracts c = x1*y2 - x2*y1 into a fused multiply-add: an ulp apart
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _depth_l1_loss_masked():
    rs = np.random.RandomState(4)
    pred = rs.randn(2, 30, 40).astype(np.float32)
    gt = np.where(rs.uniform(0, 1, (2, 30, 40)) > 0.3, rs.uniform(0, 5, (2, 30, 40)), 0)
    gt = gt.astype(np.float32)
    for g in (gt, np.zeros_like(gt)):
        got = depth_l1_loss_masked(torch.from_numpy(pred), torch.from_numpy(g))
        np.testing.assert_allclose(float(got), float(jdepth_loss(jnp.asarray(pred),
                                                                 jnp.asarray(g))), rtol=1e-6)


def _match_detections():
    serving = {k: DET[k][:, :3] for k in ("boxes", "scores", "classes", "valid", "masks")}
    parity = {k: v.copy() for k, v in serving.items()}
    parity = {k: np.concatenate([parity[k], DET[k][:, 3:]], 1) for k in parity}
    parity["boxes"][0, 0] += 0.3
    parity["scores"][1, 1] += 2e-3
    for tols in ({}, {"box_tol": 1e-2, "score_tol": 1e-4, "mask_tol": 1e-4}):
        assert match_detections(serving, parity, **tols) == jmatch(serving, parity, **tols)


HELPERS = {f.__name__[1:]: f for f in (
    _capacity_and_num_valid, _replace_and_asdict, _empty, _to_host, _pad_to,
    _sem_seg_postprocess, _get_pcd_depth, _precompute_k_inv_dot_xy_1,
    _axis_to_angle_offset_torch, _depth_l1_loss_masked, _match_detections)}


@pytest.mark.parametrize("name", list(HELPERS))
def test_helper_matches_jax(name):
    HELPERS[name]()
