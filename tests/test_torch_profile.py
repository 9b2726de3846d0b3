"""The stage profilers of the port against the JAX tools' stages, on the CPU.

`articulation3d_tpu_torch.profile_inference`, `profile_depth` and
`profile_train` are the counterparts of `tools/profile_inference.py`,
`tools/drive_depth.py` and `tools/profile_train.py`.  Each builds its
rows as `stages(...) -> [(name, fn)]`; here every row runs once and its
outputs are held against JAX's stage on the same inputs, at the tiny
config of `tests/test_goldens.py::_tiny_cfg` (64x80, 32 proposals, 8
detections, score threshold 0, 8 ROIs per image) applied to the tools'
presets, in float32.

Both packages take one set of weights: the profilers' own,
`bias_for_detections(random_state_dict(0))` (drawn once per process, and
shared with the CLI runs below), placed into JAX's tree by the d2 key map
(`test_torch_trainer_data._jax_variables`).  JAX's stages come from one
jitted `inference_probe` (JAX's `features`, then its RPN, then its
`inference`, whose box stage is the det-only model's: the cascade reads the
final boxes and changes none) and one jitted program of the decoder pieces
of `tools/drive_depth.py`, on JAX's pooler "xla", the plain reference of
its Pallas pooler.  Tracing each of the tools' JAX stages on its own
costs about 8 s of Python per inference-sized program; these two hold
every row's outputs.

  * "backbone+fpn", the depth rows: within 1e-4 x max |JAX| per map;
  * "+rpn (proposals)" and the detection rows: matched by IoU
    (`match_detections`, as `tests/test_torch_model.py` matches them),
    every JAX proposal and detection found, boxes within 1e-2 px, classes
    equal, scores and head outputs within 1e-3 x (1 + max |JAX|) and mask
    probabilities within 1e-2 (that file's gates and reasons); the
    kernel row (its plain version on the CPU) and the gather row both;
  * the training pool rows, forward and feature gradients, against JAX
    `multilevel_roi_align_train(use_pallas=False)` within 1e-4 x max
    |JAX|, on boxes under JAX's sample cap of 4;
  * "loss fwd" equals `compute_losses`' total, and stage 3 has the
    depth rows in the tool's order;
  * "features fwd+bwd" and "depth head fwd+bwd" return JAX's gradients
    (`jax.grad` of the sum of JAX's features over every parameter; of
    JAX's decoder on the same features), leaf by leaf within 1e-4 x
    max |JAX leaf|, and the features row takes exactly the leaves JAX's
    `stop_gradient` leaves live;
  * `train_config` and `train_batch` equal `tools/train_on_chip.py`'s
    `_config` and `_batch` (read from that file's source: importing the
    tool would point JAX's compile cache at the repository);
  * each CLI runs end to end with `--device cpu` (the training one at
    stage 1), prints its rows in the tool's order and, without a card and
    without `--device`, refuses to run; `--output` rewrites only the
    marked section of a file.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.evaluation.goldens import match_detections
from articulation3d_tpu.models.depth_head import ConvBNAct
from articulation3d_tpu.models.depth_head import DepthHead as JaxDepthHead
from articulation3d_tpu.models.planercnn import PlaneRCNN as JaxPlaneRCNN
from articulation3d_tpu.ops.roi_align_pallas import (
    multilevel_roi_align_train as jax_train_pool)

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch import profile_depth, profile_inference, profile_train
from articulation3d_tpu_torch.profiling import reduce_sum
from articulation3d_tpu_torch.train.train_step import compute_losses, to_device
from articulation3d_tpu_torch.weights import state_dict_from_jax
from test_torch_trainer_data import _jax_variables

H, W = 64, 80
TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

INFERENCE_ROWS = ["backbone+fpn", "+rpn (proposals)", "+box stage (pool+head+NMS)",
                  "full inference (kernel)", "full inference (gather pool)",
                  "inference w/o depth head"]
DEPTH_ROWS = ["lanes only (5x conv-bn)", "decoder w/o final resize", "full decoder",
              "backbone+fpn+decoder"]
TRAIN_ROWS = ["features fwd", "features fwd+bwd", "depth head fwd", "depth head fwd+bwd",
              "loss fwd (full train forward)", "loss fwd+bwd (value_and_grad)",
              "full step (grad+optimizer)", "train pool fwd (kernel, 8 rois/im)",
              "train pool fwd+bwd (kernel)", "train pool fwd (gather, 8 rois/im)",
              "train pool fwd+bwd (gather)"]
STAGE1_ROWS = [r for r in TRAIN_ROWS if not r.startswith("depth")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: at 64x80 it is about as fast as many, and the
    parallel test workers then do not oversubscribe the cores (each op's
    thread pool waits on threads descheduled by the other workers).  The
    setting is restored for the worker's next file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(m, cfg, **model_kw):
    """`tests/test_goldens.py::_tiny_cfg`'s sizes on a preset of either
    package (`m` is its config module)."""
    mc = cfg.model
    model = dataclasses.replace(
        mc, dtype="float32",
        rpn=dataclasses.replace(mc.rpn, pre_nms_topk_test=32, post_nms_topk_test=32,
                                pre_nms_topk_train=32, post_nms_topk_train=32),
        roi_heads=dataclasses.replace(mc.roi_heads, detections_per_image=8,
                                      batch_size_per_image=8, score_thresh_test=0.0),
        depth_head=m.DepthHeadConfig(output_height=H, output_width=W), **model_kw)
    return cfg.replace(model=model,
                       input=dataclasses.replace(cfg.input, height=H, width=W))


def _near(got, ref, rel=1e-4, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


def _scale_atol(ref, scale):
    return scale * (1.0 + float(np.abs(ref).max()))


# --------------------------------------------------------------------------- #
# inference and depth rows
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def inference_case():
    pc = _tiny(pcfg, profile_inference.profile_config("parity"))
    jc = _tiny(jcfg, jcfg.inference_config(), roi_pooler_impl="xla")
    model = profile_inference.profile_model(pc, "cpu")
    images = profile_inference.profile_images(pc, 2, "cpu")
    port = {name: fn() for name, fn in profile_inference.stages(model, images)}
    port.update({name: fn() for name, fn in profile_depth.stages(model, images)})

    variables = _jax_variables(model)
    jm = JaxPlaneRCNN(jc)
    probe = jax.jit(lambda v, im: jm.apply(v, im, method=JaxPlaneRCNN.inference_probe))(
        variables, images.numpy())
    dv = {"params": variables["params"]["depth_head"],
          "batch_stats": variables["batch_stats"]["depth_head"]}
    ph, pw = probe["features"]["p2"].shape[1:3]
    small = JaxDepthHead(dataclasses.replace(jc.model.depth_head, output_height=2 * ph,
                                             output_width=2 * pw))

    def decoder_pieces(v, f):
        lanes = [ConvBNAct(128, "leaky_relu", name=f"conv{i + 1}").apply(
            {"params": v["params"][f"conv{i + 1}"],
             "batch_stats": v["batch_stats"][f"conv{i + 1}"]}, f[name])
            for i, name in enumerate(profile_depth.LANES)]
        return lanes, small.apply(v, f)

    lanes, no_resize = jax.jit(decoder_pieces)(dv, probe["features"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(port=port, jax=to_np(probe), lanes=to_np(lanes), no_resize=np.asarray(no_resize))


def _check_detections(dets, ref, keys):
    for i in range(ref.boxes.shape[0]):
        jv, pv = ref.valid[i], dets.valid[i].numpy()
        assert pv.sum() == jv.sum() > 0
        ri, oi = match_detections(ref.boxes[i][jv], dets.boxes[i].numpy()[pv])
        assert len(ri) == jv.sum()
        sel = lambda t: t[i].numpy()[pv][oi]
        np.testing.assert_allclose(sel(dets.boxes), ref.boxes[i][jv][ri], rtol=0, atol=1e-2)
        np.testing.assert_array_equal(sel(dets.classes), ref.classes[i][jv][ri])
        for key in keys:
            want = getattr(ref, key)[i][jv][ri]
            atol = 1e-2 if key == "masks" else _scale_atol(want, 1e-3)
            np.testing.assert_allclose(sel(getattr(dets, key)), want, rtol=0, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("row", INFERENCE_ROWS)
def test_inference_row_matches_jax(inference_case, row):
    got, j = inference_case["port"][row], inference_case["jax"]
    if row == "backbone+fpn":
        for k in ("p2", "p3", "p4", "p5", "p6"):
            _near(got[k].permute(0, 2, 3, 1), j["features"][k], what=k)
        return
    if row == "+rpn (proposals)":
        for i in range(2):
            jv, pv = j["proposal_valid"][i], got["valid"][i].numpy()
            assert pv.sum() == jv.sum() > 0
            ref = j["proposal_boxes"][i][jv]
            ri, oi = match_detections(ref, got["boxes"][i].numpy()[pv], iou_thresh=0.9)
            assert len(ri) == len(ref)
            np.testing.assert_allclose(got["boxes"][i].numpy()[pv][oi], ref[ri], rtol=0,
                                       atol=1e-2)
            scores = j["proposal_logits"][i][jv]
            np.testing.assert_allclose(got["scores"][i].numpy()[pv][oi], scores[ri], rtol=0,
                                       atol=_scale_atol(scores, 1e-3))
        return
    dets, depth = got
    heads = row.startswith("full") or row.startswith("inference")
    _check_detections(dets, j["detections"], ("scores", "masks", "planes", "rot_axis",
                                              "tran_axis") if heads else ("scores",))
    if row.startswith("full"):
        _near(depth, j["depth"], what="depth")
    else:
        assert depth is None and (heads or dets.masks is None)


@pytest.mark.parametrize("row", DEPTH_ROWS)
def test_depth_row_matches_jax(inference_case, row):
    got = inference_case["port"][row]
    if row.startswith("lanes"):
        assert len(got) == 5
        for lane, ref, name in zip(got, inference_case["lanes"], profile_depth.LANES):
            _near(lane.permute(0, 2, 3, 1), ref, what=name)
    elif row.startswith("decoder w/o"):
        _near(got, inference_case["no_resize"])
    else:
        _near(got, inference_case["jax"]["depth"])


# --------------------------------------------------------------------------- #
# training rows
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pool_case():
    rs = np.random.RandomState(3)
    feats = [rs.randn(2, h, w, 8).astype(np.float32)
             for h, w in ((16, 20), (8, 10), (4, 5), (2, 3))]
    boxes = profile_train.pool_boxes(2, 16, H, W)
    pool = lambda fs: jax_train_pool(list(fs), jnp.asarray(boxes), strides=(4, 8, 16, 32),
                                     output_size=7, sampling_ratio=0, aligned=True,
                                     use_pallas=False)
    ref = jax.jit(lambda fs: (pool(fs), jax.grad(lambda f: pool(f).sum())(fs)))(feats)
    return feats, boxes, jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_train_pool_rows_match_jax(pool_case, impl):
    """Both routes' forward and feature gradient against JAX's XLA training
    pooler on the tools' random boxes, all under the sample cap of 4 at
    this size (16 ROIs per image, up to 24 px: at most 6 cells per axis
    over 7 bins)."""
    feats, boxes, (ref_out, ref_grads) = pool_case
    rows = profile_train.pool_stages([torch.from_numpy(f) for f in feats],
                                     torch.from_numpy(boxes), impl=impl, output_size=7,
                                     sampling_ratio=0)
    _near(rows[0][1](), ref_out, what="forward")
    for g, ref in zip(rows[1][1](), ref_grads):
        _near(g, ref, what="gradient")


@pytest.fixture(scope="module")
def stage3_case():
    """Stage 3's rows at the tiny config, 2 images (the rows that update
    the model, "full step", are not run)."""
    cfg = _tiny(pcfg, profile_train.train_config(3, 2, H, W))
    model, opt, sched = profile_train.train_model(cfg, "cpu")
    batch = to_device(profile_train.train_batch(cfg, 2), "cpu")
    return model, batch, profile_train.stages(model, opt, sched, batch)


def test_stage3_rows_and_loss_row_equals_compute_losses(stage3_case):
    model, batch, rows = stage3_case
    assert [name for name, _ in rows] == TRAIN_ROWS
    got = reduce_sum(dict(rows)["loss fwd (full train forward)"]()).item()
    losses = compute_losses(model, batch, torch.Generator().manual_seed(42))
    want = sum(v.to(torch.float32) for v in losses.values()).item()
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("row", ["features fwd+bwd", "depth head fwd+bwd"])
def test_train_grad_row_matches_jax(stage3_case, row):
    """The backward rows take JAX's gradients: "features fwd+bwd" is
    `jax.grad` of the sum of JAX's `features` over every parameter (the
    stem's and res2's are zero there, stopped by `freeze_at`, and absent
    from the row; the frozen BatchNorms' scale, shift and statistics are
    parameters in JAX and take gradients in both), "depth head fwd+bwd"
    that of JAX's decoder, eval-mode BatchNorm, on the same features.
    Every leaf within 1e-4 x max |JAX leaf|, placed by the d2 key map."""
    model, batch, rows = stage3_case
    got = {k: v.detach().numpy() for k, v in dict(rows)[row]().items()}
    variables = _jax_variables(model)
    cfg = model.config
    images = batch["images"].to(torch.float32)
    imgs_f = ((images - torch.tensor(cfg.input.pixel_mean))
              / torch.tensor(cfg.input.pixel_std)).numpy()
    if row.startswith("features"):
        jc = _tiny(jcfg, _tool_function("_config")(3, 2, H, W))
        jm = JaxPlaneRCNN(jc)
        total = lambda p: sum(jnp.sum(f) for f in jm.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, imgs_f,
            method=JaxPlaneRCNN.features).values())
        grads, scope = jax.jit(jax.grad(total))(variables["params"]), "backbone."
    else:
        with torch.no_grad():
            feats = {k: v.permute(0, 2, 3, 1).numpy()
                     for k, v in model.features(torch.from_numpy(imgs_f)).items()}
        head = JaxDepthHead(cfg.model.depth_head)
        bs = variables["batch_stats"]["depth_head"]
        total = lambda p: jnp.sum(head.apply({"params": p, "batch_stats": bs}, feats,
                                             train=False))
        grads = {"depth_head": jax.jit(jax.grad(total))(variables["params"]["depth_head"])}
        scope = "depth_head."
    want = {k: v for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), num_classes=1).items()
        if k.startswith(scope)}
    live = {k for k, v in want.items() if np.abs(v).max() > 0}
    assert set(got) == live, (sorted(set(got) ^ live))
    if row.startswith("features"):
        stopped = set(want) - live
        assert stopped and all(".stem." in k or ".res2." in k for k in stopped), stopped
        assert any(k.endswith("norm.running_var") for k in got)
    for k in sorted(got):
        _near(got[k], want[k], what=k)


def _tool_function(name: str):
    """`tools/train_on_chip.py::<name>` compiled from the file's source."""
    path = os.path.join(TOOLS, "train_on_chip.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np, "dataclasses": dataclasses}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


@pytest.mark.parametrize("stage", [1, 3])
def test_train_config_and_batch_equal_the_tool(stage):
    got = profile_train.train_config(stage, 2, H, W)
    want = _tool_function("_config")(stage, 2, H, W)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ours, theirs = profile_train.train_batch(got, 2), _tool_function("_batch")(want, 2)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("tool", ["inference", "depth", "train"])
def test_cli_prints_the_tools_rows(tool, tmp_path, capsys):
    if tool == "inference":
        mod, cfg, want = profile_inference, _tiny(
            pcfg, profile_inference.profile_config("serving")), INFERENCE_ROWS
        out = tmp_path / "profile.md"
        out.write_text("# notes\nkept above\n<!-- profile:begin -->\nold table\n"
                       "<!-- profile:end -->\nkept below\n")
        argv = ["--batch", "1", "--steps", "1", "--preset", "serving",
                "--output", str(out)]
    elif tool == "depth":
        mod, cfg, want = profile_depth, _tiny(pcfg, pcfg.serving_config()), DEPTH_ROWS
        argv = ["--batch", "1", "--steps", "1"]
    else:
        mod, cfg, want = profile_train, _tiny(
            pcfg, profile_train.train_config(1, 1, H, W)), STAGE1_ROWS
        argv = ["--stage", "1", "--ims", "1", "--steps", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(argv, cfg=cfg)
    rows = mod.main(argv + ["--device", "cpu"], cfg=cfg)
    assert [r[0] for r in rows] == want
    assert all(dt is not None and dt > 0 for _, dt, _ in rows)
    printed = capsys.readouterr().out
    for name in want:
        assert f"| {name} | " in printed, name
    if tool == "inference":
        text = out.read_text()
        assert text.startswith("# notes\nkept above\n<!-- profile:begin -->\n## ")
        assert text.endswith("<!-- profile:end -->\nkept below\n")
        assert "old table" not in text and "serving preset" in text
        assert all(f"| {name} | " in text for name in want)
