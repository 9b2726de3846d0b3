"""Port vs JAX: the RLE codec, VOC AP, COCO conversion, COCO mAP and the
two evaluators, on the CPU.

Every case builds its inputs once from a seed and runs them through the
JAX function and the port's.  The metric dicts must be equal exactly, key
for key in the same order, NaN where JAX gives NaN: the port runs the same
float64 numpy in the same order.  RLE strings must be byte-equal, and the
port's C++ codec (`csrc/rle.cc`) equal to its numpy twin.  The synthetic
cases are those of `tests/test_evaluation.py` and `tests/test_coco_eval.py`,
plus seeded random datasets with 1-3 objects per image.
"""

import copy
import json
import math
import os
import types

import numpy as np
import pytest
import torch

import articulation3d_tpu.data.axis_codec as j_codec
import articulation3d_tpu.data.catalog as j_catalog
import articulation3d_tpu.evaluation as j_eval
import articulation3d_tpu.evaluation.coco_eval as j_coco_eval
import articulation3d_tpu.utils.rle as j_rle
import articulation3d_tpu.utils.tables as j_tables
import articulation3d_tpu.utils.vocap as j_vocap

import articulation3d_tpu_torch.data.axis_codec as p_codec
import articulation3d_tpu_torch.data.catalog as p_catalog
import articulation3d_tpu_torch.evaluation as p_eval
import articulation3d_tpu_torch.evaluation.coco_eval as p_coco_eval
import articulation3d_tpu_torch.utils.rle as p_rle
import articulation3d_tpu_torch.utils.tables as p_tables
import articulation3d_tpu_torch.utils.vocap as p_vocap
from articulation3d_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = types.SimpleNamespace(codec=j_codec, catalog=j_catalog, ev=j_eval, coco=j_coco_eval,
                            rle=j_rle)
PORT = types.SimpleNamespace(codec=p_codec, catalog=p_catalog, ev=p_eval, coco=p_coco_eval,
                             rle=p_rle)


def _same(a, b):
    """Equal exactly: NaN for NaN, arrays element for element, dicts in
    the same key order."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (list(a), list(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), b
    else:
        assert a == b, (a, b)


def _meta(m, name, json_file="", kind="arti"):
    classes = (["arti_rot", "arti_tran"] if kind == "arti" else ["plane", "plane2"])
    return m.catalog.DatasetMetadata(
        name=name, json_file=json_file, image_root="", evaluator_type=kind,
        thing_classes=list(classes), thing_colors=[[0, 130, 200], [230, 25, 75]],
        thing_dataset_id_to_contiguous_id={1: 0, 2: 1})


# --------------------------------------------------------------------------- #
# RLE, VOC AP, tables
# --------------------------------------------------------------------------- #

def _masks():
    rs = np.random.RandomState(0)
    out = [np.zeros((7, 5), np.uint8), np.ones((7, 5), np.uint8),
           np.eye(6, 9, dtype=np.uint8), (rs.rand(1, 33) > 0.5).astype(np.uint8),
           (rs.rand(40, 1) > 0.5).astype(np.uint8)]
    for h, w in ((48, 64), (120, 160), (480, 640)):
        m = np.zeros((h, w), np.uint8)
        m[h // 5:h // 2, w // 3:w - 3] = 1
        m[0, 0] = 1
        out.append(m)
        out.append((rs.rand(h, w) > 0.7).astype(np.uint8))
    return out


def test_rle_strings_byte_equal_to_jax():
    for m in _masks():
        a, b = j_rle.rle_encode(m), p_rle.rle_encode(m)
        assert a == b
        assert a["counts"].encode("ascii") == b["counts"].encode("ascii")
        np.testing.assert_array_equal(p_rle.rle_decode(b), m)
        np.testing.assert_array_equal(p_rle.rle_decode(b), j_rle.rle_decode(a))
        assert p_rle.rle_area(b) == j_rle.rle_area(a) == int(m.sum())
        # plain counts and bytes strings decode too
        plain = {"size": b["size"], "counts": p_rle.mask_to_counts_np(m).tolist()}
        np.testing.assert_array_equal(p_rle.rle_decode(plain), m)
        byt = {"size": b["size"], "counts": b["counts"].encode("ascii")}
        np.testing.assert_array_equal(p_rle.rle_decode(byt), j_rle.rle_decode(byt))


def test_native_rle_codec_equals_numpy_twin():
    path = native.build()
    assert path == native.lib_path() and path.endswith(".so")
    for m in _masks():
        counts = native.rle_encode_counts(m)
        np.testing.assert_array_equal(counts, p_rle.mask_to_counts_np(m))
        assert counts.dtype == np.int64
        h, w = m.shape
        np.testing.assert_array_equal(native.rle_decode_counts(counts, h, w),
                                      p_rle.counts_to_mask_np(counts, h, w))
    # nonzero values other than 1 count as 1 in the native encoder
    m = _masks()[6] * 255
    np.testing.assert_array_equal(native.rle_encode_counts(m),
                                  p_rle.mask_to_counts_np(m > 0))


def test_mask_iou_matches_jax():
    rs = np.random.RandomState(1)
    dt = [p_rle.rle_encode((rs.rand(30, 40) > t).astype(np.uint8)) for t in (0.3, 0.6, 0.9)]
    gt = [p_rle.rle_encode((rs.rand(30, 40) > t).astype(np.uint8)) for t in (0.5, 0.8)]
    for crowd in (None, [0, 1]):
        _same(j_rle.mask_iou(dt, gt, iscrowd=crowd), p_rle.mask_iou(dt, gt, iscrowd=crowd))
    assert p_rle.mask_iou([], gt).shape == (0, 2)


def test_vocap_and_tables_match_jax():
    rs = np.random.RandomState(2)
    for n in (1, 5, 40):
        scores = np.round(rs.rand(n), 2)              # ties included
        labels = (rs.rand(n) > 0.5).astype(int)
        npos = float(labels.sum() + 2)
        _same(j_vocap.compute_ap(scores, labels, npos), p_vocap.compute_ap(scores, labels, npos))
        rec, prec = np.sort(rs.rand(n)), rs.rand(n)
        _same(j_vocap.xVOCap(rec, prec), p_vocap.xVOCap(rec, prec))
    assert p_vocap.compute_ap([], [], 3.0) == 0.0
    table = {"AP": 51.2, "auroc": float("nan"), "name": "x"}
    assert p_tables.create_small_table(table) == j_tables.create_small_table(table)


# --------------------------------------------------------------------------- #
# COCO conversion and COCO mAP (tests/test_coco_eval.py:24-104)
# --------------------------------------------------------------------------- #

def test_convert_to_coco_dict_matches_jax():
    records = [{
        "image_id": "x", "width": 640, "height": 480, "file_name": "x.png",
        "annotations": [
            {"bbox": [10, 20, 110, 220], "bbox_mode": 0, "category_id": 0,
             "segmentation": [[10, 20, 110, 20, 110, 220, 10, 220]],
             "plane": [1, 2, 3], "rot_axis": [1, 2, 3, 4], "normal": [0, 0, 1]},
            {"bbox": [5, 6, 30, 40], "bbox_mode": 1, "category_id": 1,
             "segmentation": {"size": [480, 640],
                              "counts": p_rle.rle_encode(np.eye(480, 640, dtype=np.uint8))
                              ["counts"].encode("ascii")},
             "tran_axis": [1, 1, 9, 9]},
            {"bbox": [0, 0, 10, 10], "bbox_mode": 0, "category_id": 1, "iscrowd": 1},
        ],
    }, {"width": 64, "height": 48, "file_name": "y.png", "annotations": []}]
    a = j_eval.convert_to_coco_dict(copy.deepcopy(records), _meta(JAX, "t"))
    b = p_eval.convert_to_coco_dict(copy.deepcopy(records), _meta(PORT, "t"))
    a.pop("info"), b.pop("info")
    _same(a, b)
    assert b["annotations"][0]["category_id"] == 1 and b["images"][1]["id"] == 1


def _coco_gt(m, anns, n_imgs=2, h=100, w=100):
    return m.ev.CocoIndex({
        "images": [{"id": i, "height": h, "width": w, "file_name": f"{i}.png"}
                   for i in range(n_imgs)],
        "annotations": [dict(a, id=i + 1, iscrowd=0, area=a["bbox"][2] * a["bbox"][3])
                        for i, a in enumerate(anns)],
        "categories": [{"id": 1, "name": "arti_rot"}, {"id": 2, "name": "arti_tran"}]})


_COCO_CASES = {
    "perfect": ([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 40, 40]},
                 {"image_id": 1, "category_id": 2, "bbox": [20, 20, 50, 30]}],
                [{"image_id": 0, "category_id": 1, "bbox": [10, 10, 40, 40], "score": 0.9},
                 {"image_id": 1, "category_id": 2, "bbox": [20, 20, 50, 30], "score": 0.8}]),
    "fp_halves": ([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 40, 40]},
                   {"image_id": 1, "category_id": 1, "bbox": [10, 10, 40, 40]}],
                  [{"image_id": 0, "category_id": 1, "bbox": [10, 10, 40, 40], "score": 0.9},
                   {"image_id": 0, "category_id": 1, "bbox": [60, 60, 30, 30], "score": 0.8}]),
    "localization": ([{"image_id": 0, "category_id": 1, "bbox": [0, 0, 100, 10]}],
                     [{"image_id": 0, "category_id": 1, "bbox": [25, 0, 100, 10],
                       "score": 0.9}]),
}


@pytest.mark.parametrize("case", sorted(_COCO_CASES))
def test_coco_bbox_ap_matches_jax(case):
    anns, dets = _COCO_CASES[case]
    a = j_coco_eval.CocoAPEvaluator(_coco_gt(JAX, anns), "bbox").evaluate(dets)
    b = p_coco_eval.CocoAPEvaluator(_coco_gt(PORT, anns), "bbox").evaluate(dets)
    _same(a, b)


def test_coco_segm_and_skip_match_jax():
    h = w = 60
    mask = np.zeros((h, w), np.uint8)
    mask[10:30, 10:30] = 1

    def run(m):
        gt = m.ev.CocoIndex({
            "images": [{"id": 0, "height": h, "width": w, "file_name": "0.png"}],
            "annotations": [{"id": 1, "image_id": 0, "category_id": 1, "iscrowd": 0,
                             "bbox": [10, 10, 20, 20], "area": 400,
                             "segmentation": [[10, 10, 30, 10, 30, 30, 10, 30]]}],
            "categories": [{"id": 1, "name": "arti_rot"}]})
        preds = [{"image_id": 0, "instances": [
            {"image_id": 0, "category_id": 1, "bbox": [10, 10, 20, 20], "score": 0.95,
             "segmentation": m.rle.rle_encode(mask)}]}]
        boxes_only = [{"image_id": 0, "instances": [
            {"image_id": 0, "category_id": 1, "bbox": [12, 10, 20, 20], "score": 0.9}]}]
        return (m.coco.evaluate_coco_map(preds, gt, tasks=("bbox", "segm")),
                m.coco.evaluate_coco_map(boxes_only, gt))

    a, b = run(JAX), run(PORT)
    _same(a, b)
    assert b[0]["segm/AP50"] == 100.0 and not any(k.startswith("segm") for k in b[1])


# --------------------------------------------------------------------------- #
# arti and scannet metrics (tests/test_evaluation.py:59-255)
# --------------------------------------------------------------------------- #

def _arti_ds(m, bboxes_per_image):
    images, annotations = [], []
    for i, bboxes in enumerate(bboxes_per_image):
        images.append({"id": f"img{i}", "width": 640, "height": 480, "file_name": f"img{i}.png"})
        for bbox in bboxes:
            annotations.append({
                "id": len(annotations) + 1, "image_id": f"img{i}", "bbox": bbox,
                "area": bbox[2] * bbox[3], "iscrowd": 0, "category_id": 1,
                "rot_axis": [200, 50, 200, 400], "tran_axis": None, "normal": [0.0, 0.0, 1.0]})
    return m.ev.CocoIndex({"images": images, "annotations": annotations,
                           "categories": [{"id": 1, "name": "arti_rot"},
                                          {"id": 2, "name": "arti_tran"}]})


def _perfect(image_id, axis=(200.0, 50, 200, 400)):
    rot = j_codec.axis_to_angle_offset(np.array([axis]), np.array([[200.0, 175.0]]))[0][:3]
    return {"image_id": image_id, "file_name": f"{image_id}.png",
            "instances": [{"image_id": image_id, "category_id": 0,
                           "bbox": [100, 100, 200, 150], "score": 0.99}],
            "pred_rot_axis": rot[None], "pred_tran_axis": np.array([[0.0, 1.0]]),
            "pred_plane": np.array([[0.0, 1.0, 0.0]])}


def _arti_cases():
    one = [[[100, 100, 200, 150]]]
    cases = {
        "perfect": (one * 4, [_perfect(f"img{i}") for i in range(4)]),
        "wrong_axis": (one * 4, [_perfect(f"img{i}", (50.0, 120, 400, 120)) for i in range(4)]),
        "half_recall": (one * 4, [_perfect(f"img{i}") for i in range(2)]),
    }
    p = _perfect("img0")
    p["instances"][0]["bbox"] = [400, 300, 100, 100]
    cases["filter_iou"] = (one * 2, [p])
    p = _perfect("img0")
    p["instances"].insert(0, {"image_id": "img0", "category_id": 0, "bbox": [0, 300, 60, 60],
                              "score": 0.999})
    for k in ("pred_rot_axis", "pred_tran_axis", "pred_plane"):
        p[k] = np.concatenate([p[k]] * 2)
    cases["multi_gt"] = ([[[100, 100, 200, 150], [420, 320, 100, 100]]], [p])
    return cases


@pytest.mark.parametrize("case", sorted(_arti_cases()))
def test_arti_axis_metrics_match_jax(case):
    gt_boxes, preds = _arti_cases()[case]
    for quirks in (True, False):
        a = j_eval.evaluate_for_arti_axis(copy.deepcopy(preds), _arti_ds(JAX, gt_boxes),
                                          _meta(JAX, "t"), filter_iou=0.7, legacy_quirks=quirks)
        b = p_eval.evaluate_for_arti_axis(copy.deepcopy(preds), _arti_ds(PORT, gt_boxes),
                                          _meta(PORT, "t"), filter_iou=0.7, legacy_quirks=quirks)
        _same(a, b)
    if case == "multi_gt":
        assert b["bbox - arti_rot"] == 0.5          # the uniform rule, as JAX


def test_recognition_and_roc_auc_match_jax():
    preds = [_perfect("img0"), _perfect("img1"),
             {"image_id": "neg0", "instances": [{"image_id": "neg0", "category_id": 0,
                                                 "bbox": [0, 0, 10, 10], "score": 0.1}]},
             {"image_id": "neg1", "instances": []}]
    a = j_eval.evaluate_for_recognition(preds, _arti_ds(JAX, [[[100, 100, 200, 150]]] * 2),
                                        _meta(JAX, "t"), filter_iou=0.7)
    b = p_eval.evaluate_for_recognition(preds, _arti_ds(PORT, [[[100, 100, 200, 150]]] * 2),
                                        _meta(PORT, "t"), filter_iou=0.7)
    _same(a, b)
    assert b == {"auroc": 1.0, "accuracy": 1.0}
    rs = np.random.RandomState(3)
    labels, scores = rs.rand(50) > 0.5, np.round(rs.rand(50), 1)
    _same(j_eval.roc_auc(labels, scores), p_eval.roc_auc(labels, scores))
    # one class only: -1 in both
    _same(j_eval.evaluate_for_recognition(preds[:2], _arti_ds(JAX, [[[1, 1, 5, 5]]] * 2),
                                          _meta(JAX, "t"), 0.7),
          p_eval.evaluate_for_recognition(preds[:2], _arti_ds(PORT, [[[1, 1, 5, 5]]] * 2),
                                          _meta(PORT, "t"), 0.7))


def _scannet_ds(m, rle):
    return m.ev.CocoIndex({
        "images": [{"id": "s0", "width": 640, "height": 480, "file_name": "s0.png"}],
        "annotations": [{"id": 1, "image_id": "s0", "bbox": [100, 100, 200, 150],
                         "area": 30000, "iscrowd": 0, "category_id": 1,
                         "segmentation": rle, "plane": [0.1, 0.2, 2.0]}],
        "categories": [{"id": 1, "name": "plane"}, {"id": 2, "name": "plane2"}]})


@pytest.mark.parametrize("plane", [[0.1, 0.2, 2.0], [0.15, 0.3, 3.0]])
def test_planes_metrics_match_jax(plane):
    mask = np.zeros((480, 640), np.uint8)
    mask[100:250, 100:300] = 1
    rle = p_rle.rle_encode(mask)
    pred = {"image_id": "s0", "pred_plane": np.array([plane]),
            "instances": [{"image_id": "s0", "category_id": 0, "bbox": [100, 100, 200, 150],
                           "score": 0.9, "segmentation": rle}]}
    a = j_eval.evaluate_for_planes([pred], _scannet_ds(JAX, rle), _meta(JAX, "s", kind="mp3d"),
                                   filter_iou=0.7)
    b = p_eval.evaluate_for_planes([pred], _scannet_ds(PORT, rle), _meta(PORT, "s", kind="mp3d"),
                                   filter_iou=0.7)
    _same(a, b)


# --------------------------------------------------------------------------- #
# ArtiEvaluator and ScannetEvaluator, end to end on a random dataset
# --------------------------------------------------------------------------- #

H, W = 48, 64


def _random_dataset(seed, n_images=6):
    """d2 records (1-3 objects, polygon segmentations, XYXY boxes, axes,
    normals, planes; one negative image) and matching predictions: GT boxes
    jittered, extra false positives, RLE masks, random axes and planes."""
    rs = np.random.RandomState(seed)
    records, preds = [], []
    for i in range(n_images):
        annos = []
        for _ in range(0 if i == n_images - 1 else rs.randint(1, 4)):
            x1, y1 = rs.uniform(0, W - 20), rs.uniform(0, H - 16)
            x2, y2 = x1 + rs.uniform(8, 20), y1 + rs.uniform(6, 16)
            cat = int(rs.randint(0, 2))
            seg = [[x1, y1, x2, y1, x2, y2, x1, y2]]
            ax = [x1 + 2, y1, x1 + 2, y2] if rs.rand() > 0.2 else [x1, y1, x2, y1 + 1]
            annos.append({"bbox": [x1, y1, x2, y2], "bbox_mode": 0, "category_id": cat,
                          "segmentation": seg,
                          "rot_axis": ax if cat == 0 else None,
                          "tran_axis": ax if cat == 1 else None,
                          "normal": rs.randn(3).tolist() if rs.rand() > 0.3 else None,
                          "plane": rs.randn(3).tolist()})
        records.append({"image_id": i, "file_name": f"img{i}.png", "height": H, "width": W,
                        "annotations": annos})
        inst, axes_r, axes_t, planes = [], [], [], []
        for a in annos + [None] * rs.randint(0, 3):
            if a is None:
                x1, y1 = rs.uniform(0, W - 20), rs.uniform(0, H - 16)
                box = [x1, y1, x1 + 12, y1 + 10]
                cat = int(rs.randint(0, 2))
            else:
                box = (np.asarray(a["bbox"]) + rs.uniform(-2, 2, 4)).tolist()
                cat = a["category_id"] if rs.rand() > 0.1 else 1 - a["category_id"]
            m = np.zeros((H, W), np.uint8)
            m[int(max(box[1], 0)):int(box[3]), int(max(box[0], 0)):int(box[2])] = 1
            inst.append({"image_id": i, "category_id": cat,
                         "bbox": [box[0], box[1], box[2] - box[0], box[3] - box[1]],
                         "score": float(np.round(rs.rand(), 3)),
                         "segmentation": p_rle.rle_encode(m)})
            axes_r.append(rs.randn(3))
            axes_t.append(rs.randn(2))
            planes.append(rs.randn(3))
        preds.append({"instances": inst, "pred_rot_axis": np.asarray(axes_r).reshape(-1, 3),
                      "pred_tran_axis": np.asarray(axes_t).reshape(-1, 2),
                      "pred_plane": np.asarray(planes).reshape(-1, 3),
                      "depth": rs.uniform(0.5, 4.0, (H, W)), "gt_depth": rs.uniform(0, 4, (H, W))})
    return records, preds


def _register(tmp_path, name, records, kind):
    path = tmp_path / f"{name}.json"
    cats = ([{"id": 0, "name": "arti_rot"}, {"id": 1, "name": "arti_tran"}] if kind == "arti"
            else [{"id": 0, "name": "plane"}, {"id": 1, "name": "plane2"}])
    path.write_text(json.dumps({"info": {}, "categories": cats, "data": records}))
    for m in (JAX, PORT):
        m.catalog.register_dataset(name, lambda: copy.deepcopy(records),
                                   _meta(m, name, str(path), kind))


@pytest.mark.parametrize("seed", [0, 1])
def test_arti_evaluator_matches_jax(tmp_path, seed):
    records, preds = _random_dataset(seed)
    name = f"teval_arti_{seed}"
    _register(tmp_path, name, records, "arti")
    for quirks in (True, False):
        res = {}
        for tag, m in (("jax", JAX), ("port", PORT)):
            out = tmp_path / f"{tag}_{quirks}"
            ev = m.ev.ArtiEvaluator(name, output_dir=str(out), legacy_quirks=quirks)
            ev.reset()
            for rec, p in zip(records, copy.deepcopy(preds)):
                ev.process([{"image_id": rec["image_id"], "file_name": rec["file_name"]}], [p])
            res[tag] = ev.evaluate()
            # the COCO cache and the predictions dump, as in JAX
            assert (out / "instances_predictions.pth").exists()
            assert list(out.glob("arti_coco_*.json"))
        _same(res["jax"], res["port"])
        assert {"bbox/AP", "segm/AP", "auroc", "bbox+axis - arti_rot"} <= set(res["port"])
    dumped = torch.load(out / "instances_predictions.pth", weights_only=False)
    assert len(dumped) == len(records) and "pred_depth" in dumped[0]
    with pytest.raises(NotImplementedError):
        p_eval.ArtiEvaluator(name, distributed=True)


@pytest.mark.parametrize("with_depth", [False, True])
def test_scannet_evaluator_matches_jax(tmp_path, with_depth):
    """With depth, `process` runs `override_depth` (the double ScanNet <->
    SunCG swap) and the masked depth L1 at the evaluator's 480x640."""
    hh, ww = (480, 640) if with_depth else (H, W)
    records, preds = _random_dataset(5, n_images=3 if with_depth else 6)
    if with_depth:
        scale = np.array([ww / W, hh / H] * 2)
        for rec, p in zip(records, preds):
            rec["height"], rec["width"] = hh, ww
            for a in rec["annotations"]:
                a["bbox"] = (np.asarray(a["bbox"]) * scale).tolist()
                a["segmentation"] = [(np.asarray(a["segmentation"][0]) * np.tile(scale[:2], 4))
                                     .tolist()]
            for ins in p["instances"]:
                ins["bbox"] = (np.asarray(ins["bbox"]) * scale).tolist()
                m = p_rle.rle_decode(ins["segmentation"])
                ins["segmentation"] = p_rle.rle_encode(np.kron(m, np.ones((10, 10), np.uint8)))
            p["depth"] = np.kron(p["depth"], np.ones((10, 10)))
            p["gt_depth"] = np.kron(p["gt_depth"], np.ones((10, 10)))
    name = f"teval_scannet_{int(with_depth)}"
    _register(tmp_path, name, records, "mp3d")
    res = {}
    for tag, m in (("jax", JAX), ("port", PORT)):
        ev = m.ev.ScannetEvaluator(name, output_dir=str(tmp_path / tag))
        ev.reset()
        for rec, p in zip(records, copy.deepcopy(preds)):
            out = {k: p[k] for k in ("instances", "pred_plane")}
            if with_depth:
                out["depth"] = p["depth"]
            ev.process([{"image_id": rec["image_id"], "file_name": rec["file_name"],
                         "depth": p["gt_depth"] if with_depth else None}], [out])
        res[tag] = (ev.evaluate(), [q["pred_plane"] for q in ev._predictions])
    _same(res["jax"], res["port"])
    assert ("depth_l1_dist" in res["port"][0]) == with_depth


def test_override_depth_matches_jax(tmp_path):
    """A flat depth of 3 m behind a centred mask re-estimates the offset
    to about 3, in both packages alike."""
    _register(tmp_path, "teval_override", [{"image_id": "s0", "width": 640, "height": 480,
                                            "file_name": "s0.png", "annotations": []}], "mp3d")
    mask = np.zeros((480, 640), np.uint8)
    mask[200:280, 280:360] = 1
    out = []
    for m in (JAX, PORT):
        ev = m.ev.ScannetEvaluator("teval_override")
        inst = {"instances": [{"segmentation": m.rle.rle_encode(mask)},
                              {"segmentation": m.rle.rle_encode(np.zeros_like(mask))}],
                "pred_plane": np.array([[0.0, 1.0, 0.0], [0.3, 0.4, 0.5]])}
        out.append(ev.override_depth(ev.depth2XYZ(np.full((480, 640), 3.0)), inst)["pred_plane"])
    _same(out[0], out[1])
    assert abs(np.linalg.norm(out[1][0]) - 3.0) < 0.03


@pytest.mark.parametrize("run", ["soak_r5", "soak_r5b"])
def test_soak_predictions_reproduce_the_recorded_metrics(run):
    """The JAX soak's committed predictions and COCO GT (exps/<run>): the
    port's evaluators give JAX's dict, which is the one the soak wrote to
    metrics.json (bbox AP 0, AUROC 0.5): every prediction there is empty."""
    preds = torch.load(f"{ROOT}/exps/{run}/instances_predictions.pth", weights_only=False)
    gt = f"{ROOT}/exps/{run}/arti_coco_datasets_articulation_cached_set_val.json"
    out = {}
    for tag, m in (("jax", JAX), ("port", PORT)):
        coco, meta = m.ev.CocoIndex(gt), _meta(m, "arti_val")
        res = dict(m.coco.evaluate_coco_map(preds, coco, metadata=meta))
        res.update(m.ev.evaluate_for_recognition(preds, coco, meta, 0.7))
        res.update(m.ev.evaluate_for_arti_axis(preds, coco, meta, 0.7))
        out[tag] = res
    _same(out["jax"], out["port"])
    with open(f"{ROOT}/exps/{run}/metrics.json") as f:
        recorded = [json.loads(x) for x in f if "eval_dataset" in x][-1]
    for k, v in out["port"].items():
        _same(float(recorded[k]), float(v))
    assert all(len(p["instances"]) == 0 for p in preds)
    assert out["port"]["auroc"] == 0.5 and out["port"]["bbox/AP"] == 0.0
