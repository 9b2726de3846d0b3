"""The port stands alone: no JAX, no JAX package, and no silent CPU fallback.

  * a fresh interpreter imports every module of `articulation3d_tpu_torch`
    (the training slice's `train.*`, the CLI's temporal, export and vis
    modules, the data path, evaluators, `train_net` and `opt_arti`, and
    the data parallelism, the rest of export and vis and the goldens
    harness among them) and `chip_smoke.py` and finds neither `jax`,
    `flax`, `optax` nor `articulation3d_tpu` in `sys.modules`, nor
    `matplotlib`, which the card's machine does not have;
  * no import statement in the port or in `chip_smoke.py` names them;
  * entry points called without a device run on the card, and raise where
    there is none;
  * the CLI runs end to end on the CPU when asked to, `--save-obj`
    included, and refuses to run without a card otherwise.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "articulation3d_tpu_torch"

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import articulation3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "articulation3d_tpu",
                                    "matplotlib"))
print("IMPORTED=" + ",".join(names))
print("BAD=" + ",".join(bad))
"""

_TRAIN_MODULES = ("checkpoint", "optimizer", "targets", "train_step", "trainer")
_CLI_MODULES = ("temporal.tracker", "temporal.kernels", "temporal.optimizer",
                "export.mesh", "export.obj_writer", "export.save_model",
                "vis.visualizer", "video.io", "data.axis_codec", "data.catalog",
                "utils.metrics", "native")
_DATA_EVAL_MODULES = ("utils.rle", "utils.vocap", "utils.tables", "data.mapper",
                      "evaluation.coco_index", "evaluation.detectron2coco",
                      "evaluation.coco_eval", "evaluation.arti_evaluation",
                      "evaluation.scannet_evaluation", "train.vis_hook", "train_net",
                      "opt_arti")
_SLICE7_MODULES = ("export.primitives", "export.transforms", "vis.render", "vis.misc",
                   "parallel.dist", "parallel.mesh", "evaluation.goldens",
                   "compare_goldens")


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(ROOT), env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout
    imported = out.stdout.split("IMPORTED=")[1].split("\n")[0].split(",")
    for m in _TRAIN_MODULES:
        assert f"articulation3d_tpu_torch.train.{m}" in imported, m
    for m in _CLI_MODULES + _DATA_EVAL_MODULES + _SLICE7_MODULES:
        assert f"articulation3d_tpu_torch.{m}" in imported, m


def test_no_import_statement_names_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|articulation3d_tpu)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {f"{m}.py" for m in _TRAIN_MODULES} <= {f.name for f in files
                                                   if f.parent.name == "train"}
    names = {str(f.relative_to(PORT))[:-3].replace("/", ".") for f in files if PORT in f.parents}
    assert set(_DATA_EVAL_MODULES + _SLICE7_MODULES) <= names
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_default_to_the_card():
    from articulation3d_tpu_torch.config import Config
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.structures import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_model(Config())
    assert resolve_device("cpu").type == "cpu"


def test_cli_runs_on_cpu_and_refuses_save_obj(tmp_path):
    """`--save-obj` is accepted: on the CPU the CLI writes the detector's
    predictions, the visualisation and the frame-0 mesh; without
    `--device` and without a card it refuses to run."""
    import cv2

    from articulation3d_tpu_torch import infer

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "model:\n  dtype: float32\n"
        "  rpn: {pre_nms_topk_test: 16, post_nms_topk_test: 16}\n"
        "  roi_heads: {detections_per_image: 4, score_thresh_test: 0.0}\n"
        "  depth_head: {output_height: 64, output_width: 96}\n"
        "input: {height: 64, width: 96}\nweights: ''\n")
    img = np.random.RandomState(0).randint(0, 255, (64, 96, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "frame.png"), img)
    out = tmp_path / "out"
    args = ["--config", str(cfg), "--input", str(tmp_path / "frame.png"),
            "--output", str(out), "--conf-threshold", "0.0", "--save-obj"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            infer.main(args)
    infer.main(args + ["--device", "cpu", "--batch-size", "2"])
    with np.load(out / "predictions.npz") as z:
        assert z["counts"].tolist() == [4]
        assert z["boxes"].shape == (4, 4) and np.isfinite(z["boxes"]).all()
        masks = np.unpackbits(z["masks_packed"], axis=-1, count=int(z["width"]))
        assert masks.shape == (4, 64, 96)
    vis = cv2.imread(str(out / "output.png"))
    assert vis.shape == (64, 96 * 4, 3)           # fit, its normals, before the fit
    obj = (out / "frame_0000" / "arti_pred.obj").read_text()
    assert obj.startswith("mtllib arti_pred.mtl") and obj.count("# mesh") >= 8
    assert (out / "frame_0000" / "arti_pred.mtl").stat().st_size > 0
    assert (out / "frame_0000" / "uv_maps" / "arti_pred_uv_plane_0.png").exists()
