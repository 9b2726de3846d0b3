"""Port vs JAX: the dataset-driven `Trainer`, its hooks, `train_net`,
`opt_arti` and `draw_gt`, on the CPU at 64x80.

A tiny dataset in the `tools/generate_arti.py` schema (XYXY boxes,
contiguous category ids, `{youtube11}_{shot}_{frame}_{offset}.png` file
names, one negative record) is written from a seed and registered in both
catalogs; the val frames are cut from two shifted-noise clips, which are
also written as mp4 for `opt_arti`.

  * `Trainer(cfg, device="cpu")` trains from its own loader, checkpoints
    and resumes; `test()` and the visualisation hand the model back in
    train mode, and the steps after them have the losses of a trainer
    without those hooks (within 1e-5 relative: two trainers on the CPU
    differ by float32 reduction order alone);
  * `test()`'s dict equals JAX's `ArtiEvaluator` run on the port's own
    predictions, and those predictions match JAX's `VideoPipeline` on the
    same weights at the gates of the 64x96 golden fixture
    (`tests/test_goldens.py:124-150`: every detection matched, boxes within
    0.05 px, scores and axes within 0.05, planes within 0.05 of their size,
    since the depth override of random weights puts offsets near 1e5; masks
    here on at most 5 % of the pixels);
  * `opt_arti --load-results` gives the dict of `tools/opt_arti.py
    --load-results` on the same shard files;
  * `draw_gt` is pixel-equal to JAX's.
"""

import dataclasses
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.data import catalog as j_catalog
from articulation3d_tpu.data.axis_codec import axis_to_angle_offset
from articulation3d_tpu.data.mapper import PlaneRCNNMapper as JaxMapper
from articulation3d_tpu.evaluation import ArtiEvaluator as JaxArtiEvaluator
from articulation3d_tpu.models.planercnn import PlaneRCNN as JaxPlaneRCNN
from articulation3d_tpu.train.checkpoint import _BN_MAP, _BN_STATS, _convert, _map_name
from articulation3d_tpu.video.pipeline import VideoPipeline as JaxPipeline
from articulation3d_tpu.vis import visualizer as j_vis

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch import opt_arti, train_net, weights
from articulation3d_tpu_torch.data import catalog as p_catalog
from articulation3d_tpu_torch.train import trainer as trainer_mod
from articulation3d_tpu_torch.train.checkpoint import latest_checkpoint
from articulation3d_tpu_torch.train.trainer import Trainer
from articulation3d_tpu_torch.utils.rle import rle_decode, rle_encode
from articulation3d_tpu_torch.vis import visualizer as p_vis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 80
CLIP = 12                     # frames per val clip; val records at offsets 0, 5, 10


def _fast_state_dict(seed=0):
    """`weights.random_state_dict`'s He-style rules with float32 draws from
    `np.random.default_rng` (a few times faster than the 208 M float64
    draws of RandomState at the d2 schema's size)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in weights.d2_key_shapes().items():
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, s)
        elif k.endswith("running_mean"):
            v = rng.standard_normal(s, dtype=np.float32) * 0.1
        elif ".norm.weight" in k or (k.endswith((".1.weight", ".2.weight"))
                                     and "depth_head" in k):
            v = rng.uniform(0.6, 1.1, s)
        elif k.endswith("num_batches_tracked"):
            out[k] = np.zeros(s, np.int64)
            continue
        elif k.endswith(".bias"):
            v = rng.standard_normal(s, dtype=np.float32) * 0.05
        elif len(s) == 4:
            fan_in = s[0] * s[2] * s[3] if ("deconv" in k and "depth_head" not in k) \
                else s[1] * s[2] * s[3]
            v = rng.standard_normal(s, dtype=np.float32) * (0.8 * np.sqrt(2.0 / fan_in))
        elif len(s) == 2:
            v = rng.standard_normal(s, dtype=np.float32) * np.sqrt(2.0 / s[1])
        else:
            v = rng.standard_normal(s, dtype=np.float32)
        if "anchor_deltas" in k:
            v = v * 0.02
        elif "bbox_pred" in k or "cls_score" in k:
            v = v * 0.002
        elif "depth_head" in k and len(s) == 4:
            v = v * 0.1
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def state_dict():
    return _fast_state_dict(0)


@pytest.fixture(scope="module", autouse=True)
def _weights(state_dict):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "random_state_dict", lambda seed: state_dict)
        mp.setattr(weights, "random_state_dict", lambda seed: state_dict)
        yield


def _video(rs, yt, n_objects, clip_dir, n_frames, offsets):
    """One clip of a seeded noise scene shifted a pixel per frame, with
    bright boxes and axis lines; the records of `offsets`."""
    base = rs.randint(0, 90, (H, W + n_frames, 3)).astype(np.uint8)
    objects = []
    for j in range(n_objects):
        x1, y1 = rs.uniform(n_frames, W - 22), rs.uniform(2, H - 24)
        x2, y2 = x1 + rs.uniform(14, 22), y1 + rs.uniform(12, 22)
        cv2.rectangle(base, (int(x1), int(y1)), (int(x2), int(y2)), (230, 230, 230), -1)
        cat = (n_objects + j) % 2
        ax = [x1 + 3, y1, x1 + 3, y2] if cat == 0 else [x1, y1 + 3, x2, y2 - 2]
        cv2.line(base, (int(ax[0]), int(ax[1])), (int(ax[2]), int(ax[3])), (20, 20, 20), 1)
        objects.append((x1, y1, x2, y2, cat, ax, rs.randn(3).tolist()))
    frames = [np.ascontiguousarray(base[:, t:t + W]) for t in range(n_frames)]
    if clip_dir is not None:
        vw = cv2.VideoWriter(str(clip_dir / f"{yt}_1_5.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (W, H))
        for f in frames:
            vw.write(f)
        vw.release()
    records = []
    for t in offsets:
        annos = []
        for x1, y1, x2, y2, cat, ax, plane in objects:
            s = [x1 - t, y1, x2 - t, y2]
            a = [ax[0] - t, ax[1], ax[2] - t, ax[3]]
            annos.append({"bbox": s, "bbox_mode": 0, "category_id": cat,
                          "segmentation": [[s[0], s[1], s[2], s[1], s[2], s[3], s[0], s[3]]],
                          "rot_axis": a if cat == 0 else None,
                          "tran_axis": a if cat == 1 else None,
                          "normal": [0.0, 0.0, 1.0], "plane": plane})
        records.append((frames[t], f"{yt}_001_5_{t}.png", annos))
    return records


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ttd")
    clips = root / "clips"
    clips.mkdir()
    rs = np.random.RandomState(0)
    splits = {
        "train": (_video(rs, "TRAINAAAAAA", 2, None, 6, [0, 2, 4])
                  + _video(rs, "TRAINBBBBBB", 1, None, 6, [1, 3, 5])),
        "val": (_video(rs, "VALAAAAAAAA", 2, clips, CLIP, [0, 5, 10])
                + _video(rs, "VALBBBBBBBB", 1, clips, CLIP, [0, 5, 10])
                + _video(rs, "VALNEGCCCCC", 0, None, 1, [0])),
    }
    depth = (1500 + np.arange(H)[:, None] * 20 + np.arange(W)[None] * 3).astype(np.uint16)
    cv2.imwrite(str(root / "depth.png"), depth)
    out = {}
    for split, items in splits.items():
        records = []
        for i, (img, name, annos) in enumerate(items):
            cv2.imwrite(str(root / name), img)
            records.append({"file_name": str(root / name), "image_id": i, "height": H,
                            "width": W, "depth_path": str(root / "depth.png"),
                            "annotations": annos})
        path = root / f"cached_set_{split}.json"
        path.write_text(json.dumps({"info": {}, "data": records, "categories": [
            {"id": 0, "name": "arti_rot"}, {"id": 1, "name": "arti_tran"}]}))
        for cat in (j_catalog, p_catalog):
            meta = cat.DatasetMetadata(
                name=f"ttd_{split}", json_file=str(path), image_root=str(root),
                evaluator_type="arti", thing_classes=["arti_rot", "arti_tran"],
                thing_colors=[[0, 130, 200], [230, 25, 75]],
                thing_dataset_id_to_contiguous_id={1: 0, 2: 1})
            cat.register_dataset(f"ttd_{split}", (lambda p=path, n=f"ttd_{split}", c=cat:
                                                  c.load_arti_json(str(p), n)), meta)
        out[split] = records
    out["root"], out["clips"] = root, clips
    return out


def _overrides(out_dir, **extra):
    over = {"model": {"rpn": {"pre_nms_topk_train": 32, "post_nms_topk_train": 16,
                              "pre_nms_topk_test": 32, "post_nms_topk_test": 32},
                      "roi_heads": {"batch_size_per_image": 8, "detections_per_image": 4,
                                    "score_thresh_test": 0.0},
                      "depth_head": {"output_height": H, "output_width": W},
                      "dtype": "float32"},
            "input": {"height": H, "width": W},
            "solver": {"ims_per_batch": 2, "base_lr": 1e-4, "warmup_iters": 0,
                       "checkpoint_period": 2},
            "test": {"eval_period": 0, "vis_period": 0},
            "datasets_train": ["ttd_train"], "datasets_test": ["ttd_val"],
            "output_dir": str(out_dir), "weights": ""}
    for k, v in extra.items():
        over[k] = {**over[k], **v} if isinstance(v, dict) else v
    return over


def _cfg(stage, out_dir, m=pcfg, **extra):
    return m.load_config(os.path.join(ROOT, "configs", f"{stage}.yaml"),
                         _overrides(out_dir, **extra))


def test_trainer_trains_from_its_loader_checkpoints_and_resumes(dataset, tmp_path):
    cfg = _cfg("step1_bbox", tmp_path / "s1")
    trainer = Trainer(cfg, device="cpu", max_instances=4)
    assert trainer.loader is None                   # built at the first step
    records = trainer.train(2)
    assert len(records) == 2 and trainer.iter == 2
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert all(r["data_s"] >= 0 and r["wall_s"] > 0 for r in records)
    path = latest_checkpoint(cfg.output_dir)
    assert path and path.endswith("model_0000001.pth")
    again = Trainer(cfg, device="cpu", max_instances=4)
    again.resume_or_load(resume=True)
    assert again.iter == 2
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         again.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    assert len(again.train(3)) == 1
    # a checkpoint directory warm-starts the weights, not the step count
    warm = Trainer(cfg.replace(weights=cfg.output_dir, output_dir=str(tmp_path / "w")),
                   device="cpu")
    warm.resume_or_load(resume=False)
    assert warm.iter == 0
    key = "roi_heads.box_head.fc1.weight"
    torch.testing.assert_close(warm.model.state_dict()[key], trainer.model.state_dict()[key],
                               rtol=0, atol=0)


def _jax_variables(model):
    """The port model's weights as JAX variables, placed by the d2 key map
    of `port_detectron2_state_dict` (the tree equals the one tracing the
    flax model's init gives, which takes about 10 s on the CPU)."""
    params, batch_stats = {}, {}
    for key, value in model.state_dict().items():
        mapped = _map_name(key)
        if (mapped is None or key.endswith("num_batches_tracked")
                or key in ("pixel_mean", "pixel_std")
                or ".anchor_generator.cell_anchors" in key):
            continue
        path, kind = mapped
        value = value.detach().cpu().numpy()
        if kind != "torch_bn":
            tree, value = params, _convert(value, kind, path)
        elif path[-1] in _BN_MAP:
            tree, path = params, path[:-1] + (_BN_MAP[path[-1]],)
        else:
            tree, path = batch_stats, path[:-1] + (_BN_STATS[path[-1]],)
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.asarray(value, np.float32)
    return {"params": params, "batch_stats": batch_stats}


def _match(ref, out, thresh=0.7):
    lt = np.maximum(ref[:, None, :2], out[None, :, :2])
    rb = np.minimum(ref[:, None, 2:], out[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.clip(area(ref)[:, None] + area(out)[None] - inter, 1e-9, None)
    used, pairs = np.zeros(len(out), bool), []
    for i in range(len(ref)):
        j = int(np.argmax(np.where(used, -1.0, iou[i])))
        if iou[i, j] >= thresh and not used[j]:
            used[j] = True
            pairs.append((i, j))
    return pairs


@pytest.fixture(scope="module")
def evaluated(dataset, tmp_path_factory):
    """A trainer on configs/config.yaml after one step and `test()`."""
    cfg = _cfg("config", tmp_path_factory.mktemp("evaluated"))
    trainer = Trainer(cfg, device="cpu", max_instances=4)
    trainer.train(1)
    return trainer, trainer.test()


def test_test_matches_jax(dataset, evaluated, tmp_path):
    trainer, results = evaluated
    cfg = trainer.cfg
    assert trainer.model.training
    res = results["ttd_val"]
    assert set(trainer.test_walls["ttd_val"]) == {"mapper", "inference", "rle", "evaluator"}
    assert {"bbox/AP", "segm/AP", "auroc", "bbox+axis - arti_tran"} <= set(res)
    preds = torch.load(os.path.join(cfg.output_dir, "instances_predictions.pth"),
                       weights_only=False)
    assert len(preds) == len(dataset["val"]) == 7
    assert all(len(p["instances"]) == 4 for p in preds)

    # JAX's evaluator on the port's own predictions
    jev = JaxArtiEvaluator("ttd_val", output_dir=str(tmp_path / "jax_eval"))
    jev._predictions = preds
    jres = jev.evaluate()
    assert list(jres) == list(res)
    for k in res:
        assert (np.isnan(res[k]) and np.isnan(jres[k])) or res[k] == jres[k], k

    # JAX's pipeline on the same weights, at the golden gates
    jc = _cfg("config", cfg.output_dir, m=jcfg, model={"roi_pooler_impl": "xla"})
    jpipe = JaxPipeline(jc, JaxPlaneRCNN(jc), _jax_variables(trainer.model), batch_size=2,
                        conf_threshold=0.0)
    mapper = JaxMapper(jc, is_train=False)
    jpreds = jpipe.run([mapper(r)["images"] for r in dataset["val"]])
    for p, j in zip(preds, jpreds):
        boxes = np.asarray([[b[0], b[1], b[0] + b[2], b[1] + b[3]]
                            for b in (i["bbox"] for i in p["instances"])])
        pairs = _match(j.boxes, boxes)
        assert len(pairs) == len(j) == len(boxes)
        for ji, pi in pairs:
            ins = p["instances"][pi]
            assert np.abs(boxes[pi] - j.boxes[ji]).max() < 0.05
            assert ins["category_id"] == int(j.classes[ji])
            assert abs(ins["score"] - float(j.scores[ji])) < 0.05
            for key, ref in (("pred_plane", j.planes), ("pred_rot_axis", j.rot_axis),
                             ("pred_tran_axis", j.tran_axis)):
                tol = 0.05 * max(1.0, float(np.abs(ref[ji]).max()))
                assert np.abs(np.asarray(p[key])[pi] - ref[ji]).max() < tol, key
            assert np.mean(rle_decode(ins["segmentation"]).astype(bool) != j.masks[ji]) < 0.05

def test_periodic_eval_and_vis_hooks_leave_training_unchanged(dataset, tmp_path):
    """Evaluation and visualisation after step 1 (the model back in train
    mode, the sampling generator and the loader untouched): step 2's
    losses are those of a trainer without the hooks."""
    cfg = _cfg("step1_bbox", tmp_path / "h", test={"eval_period": 1, "vis_period": 1})
    trainer = Trainer(cfg, device="cpu", max_instances=4)
    hooked = trainer.train(2)
    assert trainer.model.training
    rows = [json.loads(x) for x in open(os.path.join(cfg.output_dir, "metrics.json"))]
    evals = [r for r in rows if r.get("eval_dataset") == "ttd_val"]
    assert [r["iteration"] for r in evals] == [1, 2] and "bbox - arti_rot" in evals[0]
    img = cv2.imread(os.path.join(cfg.output_dir, "vis", "iter_0000001.png"))
    assert img is not None and img.shape == (H, 2 * W, 3)
    assert os.path.exists(os.path.join(cfg.output_dir, "vis", "iter_0000002.png"))
    del trainer
    plain = Trainer(cfg.replace(output_dir=str(tmp_path / "p"), test=dataclasses.replace(
        cfg.test, eval_period=0, vis_period=0)), device="cpu", max_instances=4)
    ref = plain.train(2)
    # two trainers on the CPU differ by float32 reduction order alone
    # (about 5e-7 relative on the second step)
    for a, b in zip(hooked, ref):
        assert set(a) == set(b)
        for k, v in b.items():
            if k not in ("data_s", "wall_s"):
                np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)


def test_train_net_trains_then_evaluates(dataset, tmp_path):
    out = tmp_path / "cli"
    cfg_file = tmp_path / "tiny.yaml"
    over = _overrides(out)
    over.pop("output_dir")
    cfg_file.write_text(json.dumps(over))                # JSON is YAML
    base = ["--config-file", str(cfg_file), "--device", "cpu"]
    opts = ["output_dir", str(out), "solver.base_lr", "0.0002"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_net.main(base[:2] + ["--max-iter", "1"] + opts)
    with pytest.raises(SystemExit):
        train_net.main(base + ["--dist-url", "tcp://localhost:1"] + opts)
    trainer, records = train_net.main(base + ["--max-iter", "2"] + opts)
    assert len(records) == 2 and trainer.cfg.solver.base_lr == 0.0002
    assert latest_checkpoint(str(out)).endswith("model_0000001.pth")
    trainer, results = train_net.main(base + ["--eval-only", "--resume"] + opts)
    assert trainer.iter == 2 and "bbox - arti_rot" in results["ttd_val"]
    assert train_net.parse_opts(["a.b", "3", "c", "x"]) == {"a": {"b": 3}, "c": "x"}


def _load_jax_opt_arti():
    spec = importlib.util.spec_from_file_location("jax_opt_arti",
                                                  os.path.join(ROOT, "tools", "opt_arti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_opt_arti_merge_matches_tools(dataset, tmp_path, monkeypatch, capsys):
    """Two shard files built as `tests/test_recipe.py` builds them (one of
    them empty): the merged evaluation equals `tools/opt_arti.py`'s."""
    monkeypatch.setenv("ARTI3D_JAX_CACHE", str(tmp_path / "jax_cache"))
    out = tmp_path / "opt"
    out.mkdir()
    cfg_yaml = tmp_path / "opt.yaml"
    cfg_yaml.write_text(json.dumps({"input": {"height": H, "width": W}}))
    shard = []
    for k, rec in enumerate(r for r in dataset["val"] if r["annotations"]):
        ann = rec["annotations"][0]
        x0, y0, x1, y1 = ann["bbox"]
        enc = axis_to_angle_offset(np.asarray([ann["tran_axis"] or ann["rot_axis"]]),
                                   np.asarray([[(x0 + x1) / 2, (y0 + y1) / 2]]))[0]
        shard.append({"image_id": rec["image_id"], "file_name": rec["file_name"],
                      "instances": [{"image_id": rec["image_id"],
                                     "category_id": int(ann["category_id"]),
                                     "bbox": [x0, y0, x1 - x0, y1 - y0],
                                     "score": 0.9 - 0.01 * k}],
                      "pred_rot_axis": np.asarray([enc[:3]], np.float64),
                      "pred_tran_axis": np.asarray([enc[:2]], np.float64),
                      "pred_plane": np.asarray([[0.0, 0.0, 1.0]])})
    torch.save({"predictions": shard, "corrs": [0.5, np.nan], "corrs_opt": [0.9]},
               str(out / "predictions_0000.pth"))
    torch.save({"predictions": [], "corrs": [], "corrs_opt": []},
               str(out / "predictions_0001.pth"))
    args = ["--config", str(cfg_yaml), "--load-results", "--input", str(out / "x.pth"),
            "--output", str(out), "--dataset", "ttd_val"]
    port = opt_arti.main(args)
    printed = capsys.readouterr().out
    assert f"[number of predictions]: {len(shard)}" in printed

    captured = {}
    evaluate = JaxArtiEvaluator.evaluate

    def recording(self):
        captured["res"] = evaluate(self)
        return captured["res"]

    monkeypatch.setattr(JaxArtiEvaluator, "evaluate", recording)
    monkeypatch.setattr("sys.argv", ["opt_arti.py"] + args)
    _load_jax_opt_arti().main()
    assert list(port) == list(captured["res"])
    for k in port:
        assert (np.isnan(port[k]) and np.isnan(captured["res"][k])) or \
            port[k] == captured["res"][k], k
    assert port["bbox - arti_tran"] > 0


def test_opt_arti_shards_on_cpu(dataset, evaluated, tmp_path, monkeypatch):
    """The whole flow on the CPU: an evaluation's predictions, two SLURM
    shards that re-run the detector on the clips, track and optimise, then
    the merge.  The negative video has no clip and is skipped."""
    pth = os.path.join(evaluated[0].cfg.output_dir, "instances_predictions.pth")
    cfg_yaml = tmp_path / "opt.yaml"
    over = _overrides(tmp_path / "unused")
    cfg_yaml.write_text(json.dumps(over))
    out = tmp_path / "opt"
    args = ["--config", str(cfg_yaml), "--input", pth, "--output", str(out),
            "--dataset", "ttd_val", "--video-root", str(dataset["clips"]),
            "--conf-threshold", "0", "--batch-size", "4", "--device", "cpu"]
    monkeypatch.setenv("SLURM_ARRAY_TASK_MAX", "1")
    for task in ("0", "1"):
        monkeypatch.setenv("SLURM_ARRAY_TASK_ID", task)
        assert opt_arti.main(args) is None
    shards = sorted(os.listdir(out))
    assert shards == ["predictions_0000.pth", "predictions_0001.pth"]
    merged = sum((torch.load(out / s, weights_only=False)["predictions"] for s in shards), [])
    assert len(merged) == 6                      # 2 clips x 3 annotated frames
    assert all(len(p["instances"]) == 4 for p in merged)
    monkeypatch.delenv("SLURM_ARRAY_TASK_ID")
    res = opt_arti.main(args + ["--load-results"])
    assert "bbox - arti_rot" in res and "auroc" in res
    assert opt_arti.parse_frame_name("/x/ABCDEFGHIJK_001_5_12.png") == ("ABCDEFGHIJK_1_5", 12)


def test_draw_gt_matches_jax(dataset):
    meta_j, meta_p = j_catalog.get_metadata("ttd_val"), p_catalog.get_metadata("ttd_val")
    rec = dict(dataset["val"][0])
    rec["annotations"] = rec["annotations"] + [
        {"bbox": [5, 6, 30, 20], "bbox_mode": 1, "category_id": 0, "rot_axis": [6, 7, 20, 30]},
        {"bbox": [40, 30, 60, 50], "bbox_mode": 0, "category_id": 1, "tran_axis": None}]
    img = cv2.imread(rec["file_name"])[..., ::-1]
    names = ["R", "T"]
    a = j_vis.draw_gt(j_vis.ArtiVisualizer(img), rec, meta_j, names)
    b = p_vis.draw_gt(p_vis.ArtiVisualizer(img), rec, meta_p, names)
    np.testing.assert_array_equal(a, b)
    assert (b != img).any()
    empty = dict(rec, annotations=[])
    np.testing.assert_array_equal(p_vis.draw_gt(p_vis.ArtiVisualizer(img), empty, meta_p,
                                                names), img)
