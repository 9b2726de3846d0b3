"""Port vs JAX: the dataset catalog, the mapper and the loaders, on the CPU.

The same records (files written from a seed at 64x80) go through
`articulation3d_tpu.data` and `articulation3d_tpu_torch.data`; the mapped
samples and collated batches must be array-equal, dtype for dtype.  One
departure is pinned instead (ROADMAP.md section 3): in training the port
ships `gt_depth_mm` for every record, so a batch that mixes a u16 depth
file with a missing or non-u16 one collates, where JAX raises KeyError.
"""

import copy
import json
import os
import threading

import cv2
import numpy as np
import pytest

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.data import catalog as j_catalog
from articulation3d_tpu.data import mapper as j_mapper

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.data import catalog as p_catalog
from articulation3d_tpu_torch.data import mapper as p_mapper
from articulation3d_tpu_torch.utils.rle import rle_encode

H, W = 64, 80
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def builtin_catalog():
    """Re-registers the builtin splits under the default root afterwards,
    so tests that move them leave the catalog as import made it."""
    yield
    j_catalog.register_builtin_datasets()
    p_catalog.register_builtin_datasets()


def _cfgs(stage):
    path = f"{ROOT}/configs/{stage}.yaml"
    over = {"input": {"height": H, "width": W}}
    return jcfg.load_config(path, over), pcfg.load_config(path, over)


def _records(tmp_path, seed=0):
    """Records over files on disk: polygon, RLE and ndarray masks, XYWH and
    XYXY boxes, an empty box, more objects than max_instances, crowd, u16
    depth, the .jpg -> .png and frames_hq -> frames_hq_neg fallbacks and a
    missing image."""
    rs = np.random.RandomState(seed)
    (tmp_path / "frames_hq").mkdir(exist_ok=True)
    (tmp_path / "frames_hq_neg").mkdir(exist_ok=True)
    depth = str(tmp_path / "depth.png")
    cv2.imwrite(depth, rs.randint(0, 8000, (H, W)).astype(np.uint16))
    records = []
    for i in range(7):
        img = rs.randint(0, 255, (H + 8 * (i % 2), W, 3)).astype(np.uint8)
        name = str(tmp_path / f"img_{i}.png")
        if i == 4:
            name = str(tmp_path / "frames_hq_neg" / f"img_{i}.png")
        cv2.imwrite(name, img)
        if i == 3:
            name = name.replace(".png", ".jpg")          # only the .png exists
        if i == 4:
            name = name.replace("frames_hq_neg", "frames_hq")
        if i == 5:
            name = str(tmp_path / "missing.png")
        annos = []
        for j in range(rs.randint(1, 4) if i != 6 else 7):
            x1, y1 = rs.uniform(-4, W - 20), rs.uniform(-4, H - 16)
            x2, y2 = x1 + rs.uniform(6, 30), y1 + rs.uniform(5, 24)
            mode = int(rs.randint(0, 2))
            bbox = [x1, y1, x2, y2] if mode == 0 else [x1, y1, x2 - x1, y2 - y1]
            kind = (i + j) % 3
            if kind == 0:
                seg = [[x1, y1, x2, y1, x2, y2, x1, y2], [x1, y1, x1 + 3, y1 + 3]]
            else:
                m = np.zeros((H, W), np.uint8)
                m[max(int(y1), 0):int(y2), max(int(x1), 0):int(x2)] = 1
                seg = rle_encode(m) if kind == 1 else m
            axis = [x1 + 2, y1, x1 + 3, y2]
            annos.append({"bbox": bbox, "bbox_mode": mode, "category_id": j % 2,
                          "segmentation": seg, "plane": rs.randn(3).tolist(),
                          "rot_axis": axis if j % 2 == 0 else None,
                          "tran_axis": axis if j % 2 == 1 else None,
                          "iscrowd": int(j == 2 and i == 2)})
        if i == 1:
            annos.append({"bbox": [10, 10, 10, 30], "bbox_mode": 0, "category_id": 0})
        records.append({"image_id": i, "file_name": name, "height": H, "width": W,
                        "depth_path": depth, "annotations": annos})
    return records


def _assert_same(a, b):
    assert list(a) == list(b), (list(a), list(b))
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert isinstance(b[k], np.ndarray) and a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("stage,is_train", [("step1_bbox", True), ("step3_plane", True),
                                            ("step3_plane", False), ("config", False)])
def test_mapper_matches_jax(tmp_path, stage, is_train):
    jc, pc = _cfgs(stage)
    records = _records(tmp_path)
    jm = j_mapper.PlaneRCNNMapper(jc, is_train=is_train, max_instances=4)
    pm = p_mapper.PlaneRCNNMapper(pc, is_train=is_train, max_instances=4)
    for rec in records:
        a, b = jm(copy.deepcopy(rec)), pm(copy.deepcopy(rec))
        _assert_same(a, b)
    assert not pm(records[5])["images"].any()                   # the missing image
    assert pm(records[3])["images"].any() and pm(records[4])["images"].any()
    out = pm(records[6])
    assert out["gt_valid"].sum() == 4                           # 7 objects, 4 kept
    if stage == "step3_plane":
        assert ("gt_masks_packed" in out) == is_train and ("gt_masks" in out) != is_train
        assert ("gt_depth_mm" if is_train else "gt_depth") in out
    if stage == "step1_bbox":
        assert "gt_masks_packed" not in out and "gt_planes" not in out


def test_mapper_with_refine_on_matches_jax(tmp_path):
    """`model.refine_on` makes the mapper emit masks even where the mask head
    is off (the refine loss reads them): stage 1 with the switch on, both
    packages alike."""
    path = f"{ROOT}/configs/step1_bbox.yaml"
    over = {"input": {"height": H, "width": W}, "model": {"refine_on": True}}
    jc, pc = jcfg.load_config(path, over), pcfg.load_config(path, over)
    assert not pc.model.mask_on and pc.model.refine_on
    jm = j_mapper.PlaneRCNNMapper(jc, is_train=True, max_instances=4)
    pm = p_mapper.PlaneRCNNMapper(pc, is_train=True, max_instances=4)
    records = _records(tmp_path)
    for rec in records:
        _assert_same(jm(copy.deepcopy(rec)), pm(copy.deepcopy(rec)))
    assert "gt_masks_packed" in pm(records[6])


def test_mapper_helpers_match_jax():
    for box, mode in (([1, 2, 30, 40], 0), ([1, 2, 30, 40], 1)):
        np.testing.assert_array_equal(p_mapper.convert_box(box, mode),
                                      j_mapper.convert_box(box, mode))
    with pytest.raises(ValueError):
        p_mapper.convert_box([0, 0, 1, 1], 4)
    polys = [[3.2, 4.7, 40.1, 5.5, 30.2, 50.9], [1, 1, 2, 2]]
    np.testing.assert_array_equal(p_mapper.polygons_to_bitmask(polys, H, W),
                                  j_mapper.polygons_to_bitmask(polys, H, W))


def _loader_batches(m, cfg, records, shuffle, n):
    loader = m.DetectionLoader(records, m.PlaneRCNNMapper(cfg, is_train=shuffle,
                                                          max_instances=4),
                               batch_size=3, shuffle=shuffle, seed=7)
    it = iter(loader)
    return len(loader), [next(it) for _ in range(n)], it


def test_detection_loader_matches_jax(tmp_path):
    """Two shuffled epochs (the last partial batch dropped: 7 records make
    2 batches of 3) and one ordered eval pass (3 batches, the last of 1)."""
    jc, pc = _cfgs("step3_plane")
    records = _records(tmp_path)
    for rec in records:
        rec["annotations"] = [a for a in rec["annotations"] if "segmentation" in a]
    for shuffle, n in ((True, 4), (False, 3)):
        nj, ja, jit = _loader_batches(j_mapper, jc, records, shuffle, n)
        npt, pa, pit = _loader_batches(p_mapper, pc, records, shuffle, n)
        assert nj == npt == 3
        for a, b in zip(ja, pa):
            _assert_same(a, b)
        if not shuffle:
            assert [len(b["image_id"]) for b in pa] == [3, 3, 1]
            assert next(pit, None) is None and next(jit, None) is None
    assert [b["image_id"] for b in pa] == [[0, 1, 2], [3, 4, 5], [6]]


def test_prefetch_loader_order_errors_and_stop():
    batches = [{"x": np.full(2, i)} for i in range(6)]
    got = list(p_mapper.PrefetchLoader(batches, depth=2))
    assert [int(b["x"][0]) for b in got] == list(range(6))
    assert len(p_mapper.PrefetchLoader(batches)) == 6

    def failing():
        yield batches[0]
        yield batches[1]
        raise ValueError("bad record")

    seen = []
    with pytest.raises(ValueError, match="bad record"):
        for b in p_mapper.PrefetchLoader(failing()):
            seen.append(int(b["x"][0]))
    assert seen == [0, 1]

    def endless():
        i = 0
        while True:
            yield {"x": np.full(2, i)}
            i += 1

    before = threading.active_count()
    it = iter(p_mapper.PrefetchLoader(endless(), depth=2))
    assert [int(next(it)["x"][0]) for _ in range(3)] == [0, 1, 2]
    it.close()              # the consumer stops early: the thread is joined
    assert threading.active_count() == before


def test_training_depth_key_is_always_mm(tmp_path):
    """The departure from JAX: a training batch of a u16 depth file, a
    missing one and an 8-bit one collates with `gt_depth_mm` (zeros for the
    missing file, the 8-bit file's metres in mm) where JAX's raises."""
    jc, pc = _cfgs("step3_plane")
    records = _records(tmp_path)[:3]
    records[1]["depth_path"] = str(tmp_path / "no_depth.png")
    eight = np.random.RandomState(1).randint(0, 255, (H, W)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "depth8.png"), eight)
    records[2]["depth_path"] = str(tmp_path / "depth8.png")
    jm = j_mapper.PlaneRCNNMapper(jc, is_train=True, max_instances=4)
    pm = p_mapper.PlaneRCNNMapper(pc, is_train=True, max_instances=4)
    js = [jm(r) for r in records]
    assert "gt_depth_mm" in js[0] and "gt_depth" in js[1] and "gt_depth" in js[2]
    with pytest.raises(KeyError):
        j_mapper.collate(js)
    batch = p_mapper.collate([pm(r) for r in records])
    assert "gt_depth" not in batch and batch["gt_depth_mm"].dtype == np.uint16
    assert batch["gt_depth_mm"].shape == (3, H, W)
    np.testing.assert_array_equal(batch["gt_depth_mm"][0], js[0]["gt_depth_mm"])
    assert not batch["gt_depth_mm"][1].any()
    np.testing.assert_array_equal(batch["gt_depth_mm"][2], eight)
    np.testing.assert_allclose(batch["gt_depth_mm"][2] / 1000.0, js[2]["gt_depth"], atol=5e-7)
    # evaluation keeps JAX's float metres, zeros for a missing file
    ev = p_mapper.PlaneRCNNMapper(pc, is_train=False)(records[1])
    jev = j_mapper.PlaneRCNNMapper(jc, is_train=False)(records[1])
    np.testing.assert_array_equal(ev["gt_depth"], jev["gt_depth"])


def test_catalog_registry_matches_jax(tmp_path, builtin_catalog):
    builtin = sorted({**p_catalog.ARTI_SPLITS, **p_catalog.SCANNET_SPLITS})
    assert builtin == sorted({**j_catalog.ARTI_SPLITS, **j_catalog.SCANNET_SPLITS})
    assert set(builtin) <= set(p_catalog.list_datasets())
    for name in builtin:
        assert vars(p_catalog.get_metadata(name)) == vars(j_catalog.get_metadata(name)), name
    assert p_catalog.get_metadata("scannet_val").evaluator_type == "mp3d"
    assert p_catalog.get_metadata("arti_val").evaluator_type == "arti"
    with pytest.raises(KeyError):
        p_catalog.get_dataset_dicts("no_such_set")
    with pytest.raises(KeyError):
        p_catalog.get_metadata("no_such_set")

    root = tmp_path / "data"
    (root / "articulation").mkdir(parents=True)
    recs = [{"image_id": 0, "file_name": "a.png", "height": H, "width": W, "annotations": []}]
    (root / "articulation" / "cached_set_val.json").write_text(json.dumps({
        "info": {}, "categories": [{"id": 1, "name": "door"}, {"id": 0, "name": "drawer"}],
        "data": recs}))
    for cat in (p_catalog, j_catalog):
        cat.register_builtin_datasets(str(root))
        meta = cat.get_metadata("arti_val")
        assert meta.json_file == str(root / "articulation" / "cached_set_val.json")
        assert meta.image_root == str(root / "arti")
        assert meta.thing_classes == ["arti_rot", "arti_tran"]
        assert cat.get_dataset_dicts("arti_val") == recs
        # the JSON's categories replace the class names, in place, by id
        assert meta.thing_classes == ["drawer", "door"]
        assert cat.get_metadata("scannet_train").json_file == str(
            root / "scannet" / "cached_set_train.json")
    p_catalog.register_dataset("tdata_custom", lambda: recs, p_catalog.get_metadata("arti_val"))
    assert p_catalog.get_dataset_dicts("tdata_custom") == recs
    assert "tdata_custom" in p_catalog.list_datasets()
    assert p_catalog.load_scannet_json is p_catalog.load_arti_json
