"""The port's goldens harness (`evaluation/goldens.py`, the
`compare_goldens` CLI) against the JAX package's, on the CPU.

  * `match_detections` and `full_d2_key_shapes` equal JAX's;
  * the CLI, `python -m articulation3d_tpu_torch.compare_goldens --device
    cpu`, on the committed oracle fixtures with their weights, is
    `tests/test_torch_goldens.py::test_fixture_at_tight_gates` (one 480x640
    forward serves both files' checks);
  * a fixture the port writes from its own probe (`goldens_from_probe`,
    `save_goldens`) at the tiny 64x80 config, with the same weights,
    compares to itself with every error 0, through the CLI's `meta_*`
    config rule.
"""

import os

import numpy as np
import pytest
import torch

from articulation3d_tpu.evaluation import goldens as jgold
from articulation3d_tpu_torch import compare_goldens as cli
from articulation3d_tpu_torch.evaluation import goldens as pgold
from torch_oracle import bias_state_dict_for_detections, he_state_dict

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _boxes(rs, n):
    xy = rs.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rs.uniform(1, 40, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("seed,iou", [(0, 0.7), (1, 0.5), (2, 0.9)])
def test_match_detections_matches_jax(seed, iou):
    rs = np.random.RandomState(seed)
    ref = _boxes(rs, 30)
    out = np.concatenate([ref[rs.permutation(30)[:20]] + rs.normal(0, 1.5, (20, 4)),
                          _boxes(rs, 10)]).astype(np.float32)
    ref[3, 2:] = ref[3, :2]                              # a degenerate box
    out[0] = ref[3]
    got = pgold.match_detections(ref, out, iou_thresh=iou)
    want = jgold.match_detections(ref, out, iou_thresh=iou)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0
    empty = pgold.match_detections(ref[:0], out)
    assert [len(x) for x in empty] == [0, 0]


@pytest.mark.parametrize("num_classes", [2, 3])
def test_full_d2_key_shapes_matches_jax(num_classes):
    got = pgold.full_d2_key_shapes(num_classes)
    want = jgold.full_d2_key_shapes(num_classes)
    assert list(got) == list(want) and got == want


@pytest.fixture(scope="module")
def oracle_weights(tmp_path_factory):
    """The oracle's biased weights in memory and as a d2 `.pth` (about 830
    MB, removed after the module)."""
    sd = bias_state_dict_for_detections(he_state_dict(0))
    path = tmp_path_factory.mktemp("weights") / "oracle.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    yield sd, path
    os.remove(path)


def test_port_written_fixture_compares_to_itself(tmp_path, oracle_weights):
    meta = {"topk": 32, "dets": 8, "score_thresh": 0.0}
    g = {"image": np.random.RandomState(3).randint(0, 256, (64, 80, 3)).astype(np.uint8),
         "meta_topk": np.asarray(32), "meta_dets": np.asarray(8),
         "meta_score_thresh": np.asarray(0.0)}
    cfg = cli._config_for(g, "torch")
    assert (cfg.input.height, cfg.input.width, cfg.model.dtype) == (64, 80, "float32")
    from articulation3d_tpu_torch.models.planercnn import build_model
    sd, weights = oracle_weights
    model = build_model(cfg, device="cpu", state_dict=sd)
    fixture = pgold.goldens_from_probe(model, g["image"], meta)
    assert fixture["det_boxes"].shape == (8, 4) and fixture["pred_masks"].shape[0] == 8
    path = tmp_path / "port.npz"
    pgold.save_goldens(str(path), fixture)
    loaded = pgold.load_goldens(str(path))
    assert sorted(loaded) == sorted(fixture)
    report = cli.run_compare(str(path), str(weights), device="cpu", score_thresh=0.0)
    assert report["det_match_frac"] == 1.0 and report["det_out_count"] == 8
    assert report["proposal_top100_match_frac"] == 1.0
    errs = {k: v for k, v in report.items() if k.endswith("_max_err")}
    assert len(errs) == 12 and all(v == 0.0 for v in errs.values()), errs
