"""The port's weights: d2 schema, seeded random weights, JAX parameters.

  * the test oracle's full-schema `he_state_dict` loads into the port's
    PlaneRCNN with only the anchor buffers unexpected and nothing missing;
  * `random_state_dict(seed)` draws exactly the oracle's weights;
  * JAX `init_params` -> `state_dict_from_jax` loads strictly;
  * d2 -> `port_detectron2_state_dict` -> `state_dict_from_jax` returns
    every tensor bit-exactly (the conversions are pure permutations).
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.models.planercnn import init_params
from articulation3d_tpu.train.checkpoint import port_detectron2_state_dict

from articulation3d_tpu_torch.config import load_config
from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
from articulation3d_tpu_torch.weights import (d2_key_shapes, load_d2_state_dict,
                                              random_state_dict, state_dict_from_jax)
from torch_oracle import he_state_dict

H, W = 64, 80


def _ignorable(k):
    return k.endswith("num_batches_tracked") or ".anchor_generator." in k


@pytest.fixture(scope="module")
def he_sd():
    return he_state_dict(0)


@pytest.fixture(scope="module")
def jax_variables():
    model = jcfg.ModelConfig(
        rpn=jcfg.RPNConfig(pre_nms_topk_test=32, post_nms_topk_test=32),
        roi_heads=jcfg.ROIHeadsConfig(detections_per_image=8, score_thresh_test=0.0),
        depth_head=jcfg.DepthHeadConfig(output_height=H, output_width=W),
        dtype="float32", roi_pooler_impl="xla")
    cfg = jcfg.Config(model=model, input=jcfg.InputConfig(height=H, width=W))
    return init_params(cfg, jax.random.PRNGKey(0))[1]


def test_schema_matches_model_and_he_state_dict_loads(he_sd):
    model = PlaneRCNN(load_config())
    shapes = d2_key_shapes()
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: v for k, v in shapes.items() if not _ignorable(k)} == \
        {k: v for k, v in own.items() if not _ignorable(k)}
    sd = {k: torch.from_numpy(v) for k, v in he_sd.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert missing == []
    assert unexpected and all(".anchor_generator." in k for k in unexpected)
    load_d2_state_dict(model, he_sd)
    got = model.state_dict()["roi_heads.axis_head.axis_T_fc1.weight"].numpy()
    np.testing.assert_array_equal(got, he_sd["roi_heads.axis_head.axis_T_fc1.weight"])


def test_random_state_dict_is_the_oracles(he_sd):
    sd = random_state_dict(0)
    assert list(sd) == list(he_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], he_sd[k], err_msg=k)


def test_load_rejects_foreign_keys(he_sd):
    model = PlaneRCNN(load_config())
    bad = dict(he_sd)
    bad["roi_heads.box_head.fc3.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError):
        load_d2_state_dict(model, bad)


def test_jax_init_params_load_strictly(jax_variables):
    sd = state_dict_from_jax(jax_variables["params"], jax_variables["batch_stats"])
    model = PlaneRCNN(load_config())
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    # num_batches_tracked is absent from JAX; torch's BatchNorm fills it in
    assert unexpected == [] and missing == []
    # the JAX kernel layout really was inverted: a conv and a first FC
    k = np.asarray(jax_variables["params"]["fpn"]["output_p3"]["kernel"])
    np.testing.assert_array_equal(sd["backbone.fpn_output3.weight"][4, 5],
                                  k[:, :, 5, 4])


def test_d2_to_jax_to_d2_round_trip(he_sd, jax_variables):
    params, batch_stats, stats = port_detectron2_state_dict(
        he_sd, jax_variables["params"], jax_variables["batch_stats"])
    assert stats["skipped"] == 0 and stats["unmapped"] == 0
    back = state_dict_from_jax(params, batch_stats)
    want = {k: v for k, v in he_sd.items() if not _ignorable(k)}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_state_dict_from_jax_skips_absent_heads(he_sd, jax_variables):
    params = dict(jax_variables["params"])
    params.pop("mask_head")
    sd = state_dict_from_jax(params, jax_variables["batch_stats"])
    assert not any(k.startswith("roi_heads.mask_head.") for k in sd)
    cfg = load_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, mask_on=False))
    model = PlaneRCNN(cfg)
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    assert unexpected == [] and missing == []
