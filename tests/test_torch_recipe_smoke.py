"""The helpers of the card's recipe tests (`tests/torch_checks.py`, used by
`tests/test_torch_card_train.py`), on the CPU at 96x128.

  * `write_recipe_dataset` writes the schema `tools/generate_arti.py`
    emits, which both packages' catalogs load: the split sizes, negatives,
    both classes in val, file names that `opt_arti.parse_frame_name`
    groups by video, u16 depth, and the val clips;
  * `known_answer_predictions` gives the known answers the card tests
    assert, here through the port's evaluators and JAX's alike: bbox
    and bbox+axis AP 1.0 per class and AUROC 1.0; bbox+axis AP 0 with the
    axes turned by 90 degrees; plane AP 1.0;
  * `check_eval_values` lets NaN through only where no GT is in the area
    range or the category;
  * `recipe_argv` puts `train_net`'s flags before its overrides;
  * `record_pools` keeps the first pools' inputs and hands every call on;
    `main_path_err` takes both kinds of pool (on CPU tensors the wrappers
    run their plain versions, so the error is that of the bookkeeping).
"""

import math
import os
import types

import cv2
import numpy as np
import pytest
import torch

from articulation3d_tpu.data import catalog as j_catalog
from articulation3d_tpu.evaluation import ArtiEvaluator as JaxArtiEvaluator

from articulation3d_tpu_torch import opt_arti, train_net
from articulation3d_tpu_torch.data import catalog as p_catalog
from articulation3d_tpu_torch.evaluation import ArtiEvaluator, ScannetEvaluator
from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
from articulation3d_tpu_torch.ops import roi_align_cuda as rac
from articulation3d_tpu_torch.train import trainer as trainer_mod
import torch_checks as cs

H, W, CLIP = 96, 128, 8


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recipe_data"))
    splits = cs.write_recipe_dataset(root, h=H, w=W, clip_frames=CLIP)
    p_catalog.register_builtin_datasets(root)
    j_catalog.register_builtin_datasets(root)
    yield root, splits
    p_catalog.register_builtin_datasets()
    j_catalog.register_builtin_datasets()


def test_recipe_dataset_schema(recipe):
    root, splits = recipe
    for split, (n_pos, per_pos, n_neg, per_neg) in cs.RECIPE_SPLITS.items():
        recs = splits[split]
        assert len(recs) == n_pos * per_pos + n_neg * per_neg
        assert sum(1 for r in recs if not r["annotations"]) == n_neg * per_neg
        assert [r["image_id"] for r in recs] == list(range(len(recs)))
        assert p_catalog.get_dataset_dicts(f"arti_{split}") == recs
        assert j_catalog.get_dataset_dicts(f"arti_{split}") == recs
    assert len(splits["train"]) == 48 and len(splits["val"]) == len(splits["test"]) == 16
    assert p_catalog.get_dataset_dicts("scannet_val") == splits["val"]
    assert p_catalog.get_metadata("scannet_val").thing_classes == ["plane", "plane2"]
    val = splits["val"]
    assert {a["category_id"] for r in val for a in r["annotations"]} == {0, 1}
    for r in val:
        img = cv2.imread(r["file_name"])
        depth = cv2.imread(r["depth_path"], cv2.IMREAD_UNCHANGED)
        assert img.shape == (H, W, 3) and depth.dtype == np.uint16
        for a in r["annotations"]:
            x1, y1, x2, y2 = a["bbox"]
            assert a["bbox_mode"] == 0 and 0 <= x1 < x2 <= W and 0 <= y1 < y2 <= H
            assert (a["rot_axis"] is None) != (a["tran_axis"] is None)
            assert abs(np.linalg.norm(a["normal"]) - 1) < 1e-9
            # the object's bright rectangle sits at its box in the frame
            assert img[int(y1) + 2, int(x2) - 2].min() >= 180
    videos = {opt_arti.parse_frame_name(r["file_name"])[0] for r in val}
    clips = sorted(os.listdir(os.path.join(root, "clips")))
    assert len(videos) == 3 and len(clips) == 2
    assert all(c[:-4] in videos for c in clips)
    cap = cv2.VideoCapture(os.path.join(root, "clips", clips[0]))
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == CLIP


def test_known_answers(recipe, tmp_path):
    _, splits = recipe
    val = splits["val"]
    res = {}
    for rotate in (False, True):
        for tag, cls in (("port", ArtiEvaluator), ("jax", JaxArtiEvaluator)):
            ev = cls("arti_val", output_dir=str(tmp_path / f"{tag}{rotate}"))
            ev._predictions = cs.known_answer_predictions(val, rotate_axes=rotate)
            res[tag, rotate] = ev.evaluate()
    for c in ("arti_rot", "arti_tran"):
        assert res["port", False][f"bbox - {c}"] == 1.0
        assert res["port", False][f"bbox+axis - {c}"] == 1.0
        assert res["port", False][f"bbox+normal - {c}"] == 1.0
        assert res["port", True][f"bbox+axis - {c}"] == 0.0
        assert res["port", True][f"bbox - {c}"] == 1.0
    assert res["port", False]["auroc"] == 1.0 and res["port", False]["bbox/AP"] == 100.0
    for rotate in (False, True):
        a, b = res["jax", rotate], res["port", rotate]
        assert list(a) == list(b)
        assert all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)
    assert cs.check_eval_values(res["port", False], "arti_val") == [
        k for k, v in res["port", False].items() if math.isnan(v)]

    sev = ScannetEvaluator("scannet_val")
    scan_val = p_catalog.get_dataset_dicts("scannet_val")
    for rec, p in zip(scan_val, cs.known_answer_predictions(scan_val)):
        sev.process([{"image_id": rec["image_id"], "file_name": rec["file_name"]}],
                    [{"instances": p["instances"],
                      "pred_plane": [a["plane"] for a in rec["annotations"]]}])
    scan = sev.evaluate()
    assert scan[cs.PLANE_KEY] == 1.0 and scan["mask_ap@0.5"] == 1.0
    assert "depth_l1_dist" not in scan


def test_check_eval_values_allows_nan_only_without_gt(recipe):
    _, splits = recipe
    areas = [(a["bbox"][2] - a["bbox"][0]) * (a["bbox"][3] - a["bbox"][1])
             for r in splits["val"] for a in r["annotations"]]
    assert max(areas) < 96 ** 2                     # no large GT at 96x128
    ok = {"bbox/AP": 3.0, "segm/APl": float("nan"), "auroc": -1}
    assert cs.check_eval_values(ok, "arti_val") == ["segm/APl"]
    with pytest.raises(AssertionError):
        cs.check_eval_values({"bbox/AP": float("nan")}, "arti_val")
    with pytest.raises(AssertionError):
        cs.check_eval_values({"bbox+axis - arti_rot": float("inf")}, "arti_val")
    with pytest.raises(AssertionError):
        cs.check_eval_values({"segm/AP-arti_rot": float("nan")}, "arti_val")


def test_recipe_argv_reaches_the_trainer(recipe, monkeypatch, tmp_path):
    seen = {}

    class Stub:
        def __init__(self, cfg, device=None):
            seen["cfg"], seen["device"] = cfg, device
            self.iter = 0

        def resume_or_load(self, resume=False):
            seen["resume"] = resume

        def test(self):
            return {"arti_val": {}}

        def train(self, max_iter=None):
            seen["max_iter"] = max_iter
            return []

    monkeypatch.setattr(trainer_mod, "Trainer", Stub)
    out = str(tmp_path / "s1")
    train_net.main(cs.recipe_argv("step1_bbox", out, "w.pth", 22, "--max-iter", "22",
                                   "--device", "cpu"))
    cfg = seen["cfg"]
    assert seen["max_iter"] == 22 and seen["device"] == "cpu" and seen["resume"] is False
    assert cfg.weights == "w.pth" and cfg.output_dir == out
    assert cfg.solver.checkpoint_period == 22 and cfg.solver.warmup_iters == 0
    assert cfg.solver.base_lr == 0.002 and cfg.solver.ims_per_batch == 16
    assert cfg.model.roi_pooler_impl == "cuda" and cfg.model.roi_heads.score_thresh_test == 0.0
    assert cfg.test.eval_period == 0 and cfg.datasets_test == ("arti_val",)
    _, res = train_net.main(cs.recipe_argv("step3_plane", out, "c.pth", 12, "--eval-only",
                                            "--resume", "--device", "cpu"))
    assert seen["resume"] is True and res == {"arti_val": {}}
    assert seen["cfg"].solver.ims_per_batch == 8 and "backbone" in seen["cfg"].model.freeze


def test_record_pools_and_main_path_err():
    rs = np.random.RandomState(0)
    feats = [torch.from_numpy(rs.randn(2, 64 // s, 64 // s, 8).astype(np.float32))
             for s in (4, 8, 16, 32)]
    xy = rs.uniform(0, 40, (2, 5, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rs.uniform(4, 24, (2, 5, 2))],
                                            -1).astype(np.float32))
    valid = torch.from_numpy(rs.rand(2, 5) > 0.3)
    stub = types.SimpleNamespace(_pooler_impl=lambda device: "cuda")
    orig = PlaneRCNN._pool
    pools = cs.record_pools(2)
    try:
        outs = [PlaneRCNN._pool(stub, feats, boxes, resolution=p, sampling_ratio=sr,
                                aligned=al, valid=valid, training=tr)
                for p, sr, al, tr in ((7, 0, True, True), (14, 2, False, False),
                                      (14, 0, False, True))]
    finally:
        pools.restore()
    assert PlaneRCNN._pool is orig
    assert len(pools.calls) == 2 and [o.shape[2] for o in outs] == [7, 14, 14]
    for (f, b, kw), want in zip(pools.calls, outs):
        assert b is not boxes and torch.equal(b, boxes) and len(f) == 4
        again = orig(stub, f, b, **kw)
        torch.testing.assert_close(again, want, rtol=0, atol=0)
    assert [kw["training"] for _, _, kw in pools.calls] == [True, False]
    assert cs.main_path_err(rac, pools.calls) <= 1e-6
