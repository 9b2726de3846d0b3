"""The port's inference paths at full width on the card: what each path
must compute, not how fast (`portbench/` times the paths).

Imports neither JAX nor the JAX package; run on the card from the
repository root:

    python -m pytest tests/test_torch_card_infer.py --noconftest -m cuda -q

Elsewhere every test skips.  The model is configs/config.yaml (R50-FPN,
1000 proposals, 100 detections, mask, plane, axis and depth heads, bf16
trunk, the kernel pooler) at score threshold 0 with `serving_weights`, on
480x640 noise frames; TF32 is off throughout.  Cases:

  * the main path through `VideoPipeline` at batch 8 without one call of
    the torch prologue `_prepare`, and K1's record and output on its own
    pool inputs; the kernel route against the gather route, float32;
  * the temporal stage on the card: the door clip of
    tests/test_temporal_truth.py, the sweeps and the IoU product against
    the CPU's, the detector then track and optimise on a shifted clip;
  * the CLI's body with --save-obj, and the rest of export and vis on its
    detections;
  * the refine head and the DRPN head, each route against the other;
  * the goldens harness on the card: a CPU-written fixture and the
    reference oracle's, through both poolers, and where the card's float32
    model departs from the CPU's;
  * the deployment preset `serving_config()` beside the parity caps: its
    pools, and its equivalence contract;
  * the stage profilers' rows: which rows call K1 and K2, K1 on each row's
    pool inputs, the training pool's kernel rows against its gather rows.
"""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from torch_checks import (ROOT, calibrate_depth_bn, check_record, main_path_err,
                          parity_config, record_pools, route_agreement, serving_weights)

pytestmark = pytest.mark.cuda
ORACLE = ("golden_oracle_biased_480x640.npz", "golden_oracle_biased_128x160.npz")


@pytest.fixture(autouse=True, scope="module")
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _noise(n: int, seed: int):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(n)]


def _shifted_clip(n: int = 32, h: int = 480, w: int = 640):
    """n frames cut from one seeded noise image, each shifted by one pixel,
    so that a detector's boxes persist from frame to frame."""
    base = np.random.RandomState(1).randint(0, 256, (h, w + n, 3)).astype(np.uint8)
    return [np.ascontiguousarray(base[:, t:t + w]) for t in range(n)]


def _images(frames):
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    return preprocess_images(torch.from_numpy(np.stack(frames)).cuda())


def _with_model(cfg, **model_kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))


@pytest.fixture(scope="module")
def serving():
    """(config, weights, model) of the main path."""
    from articulation3d_tpu_torch.models.planercnn import build_model
    cfg = parity_config()
    sd = serving_weights(cfg)
    yield cfg, sd, build_model(cfg, state_dict=sd)
    torch.cuda.empty_cache()


def _pipeline(cfg, model):
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    return VideoPipeline(cfg, model, batch_size=8, conf_threshold=0.0)


# --------------------------------------------------------------------------- #
# the main path
# --------------------------------------------------------------------------- #

def test_main_path_runs_the_kernel_without_the_torch_prologue(serving, monkeypatch):
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    cfg, _, model = serving
    pipe = _pipeline(cfg, model)
    frames = _noise(16, 0)
    prologue = []
    prepare = rac._prepare
    monkeypatch.setattr(rac, "_prepare", lambda *a, **k: prologue.append(1) or prepare(*a, **k))
    with tracing.recording() as rec:
        preds = pipe.run(frames)
    monkeypatch.undo()
    assert not prologue, len(prologue)
    assert len(preds) == 16 and len(pipe.depths) == 16
    for pr in preds:
        n = len(pr)
        assert n > 0
        assert pr.boxes.shape == (n, 4) and pr.scores.shape == (n,)
        assert pr.masks.shape == (n, 480, 640) and pr.masks.dtype == bool
        assert pr.planes.shape == (n, 3) and pr.rot_axis.shape == (n, 3)
        assert pr.tran_axis.shape == (n, 2)
        for a in (pr.boxes, pr.scores, pr.planes, pr.rot_axis, pr.tran_axis):
            assert np.isfinite(a).all()
    for d in pipe.depths:
        assert d.shape == (480, 640) and np.isfinite(d).all()
    assert rec.counter("k1.launches") >= 3 * 2
    for stage in ("box", "mask", "plane"):
        assert pipe.pool_valid.get(stage, 0) > 0, (stage, pipe.pool_valid)
    # K1 at the main path's own pool inputs (the second batch)
    pools = record_pools(3)
    try:
        model.inference(_images(frames[8:]))
    finally:
        pools.restore()
    for roi_feats, boxes, kw in pools.calls:
        check_record(rac, roi_feats, boxes, kw["valid"], kw["resolution"],
                     kw["sampling_ratio"], kw["aligned"])
    main_path_err(rac, pools.calls)


def test_kernel_route_matches_the_gather_route(serving):
    from articulation3d_tpu_torch.models.planercnn import build_model
    cfg, sd, _ = serving
    cfg32 = _with_model(cfg, dtype="float32", roi_pooler_impl="cuda")
    model32 = build_model(cfg32, state_dict=sd)
    images = _images(_noise(8, 0))
    outs = {}
    for impl in ("cuda", "torch"):
        model32.config = _with_model(cfg32, roi_pooler_impl=impl)
        outs[impl] = model32.inference(images)["detections"]
    agree = route_agreement(outs["cuda"], outs["torch"],
                            heads=("masks", "planes", "rot_axis", "tran_axis"))
    assert agree["n_ref"] > 0 and agree["matched"] >= 0.9, agree
    assert agree["box_err"] < 2.0, agree
    assert all(v < 0.75 for v in agree["head_err"].values()), agree


# --------------------------------------------------------------------------- #
# the temporal stage
# --------------------------------------------------------------------------- #

ROT_ANGLES = np.arange(-np.pi / 2, np.pi, np.pi / 30)     # the optimizer's grids
TRANS_STEPS = np.arange(-1.0, 1.0, 0.1)


def _door_clip(h: int = 480, w: int = 640, n: int = 30):
    """tests/test_temporal_truth.py's clip: a 1.2 m door turning from -0.4 to
    0.4 rad about the vertical hinge x = -0.5, z = 3, y in [-0.8, 0.8],
    drawn with the optimizer's camera.  Returns (predictions, the hinge's
    image segment [x1, y1, x2, y2])."""
    import cv2

    from articulation3d_tpu_torch.data.axis_codec import axis_to_angle_offset
    from articulation3d_tpu_torch.structures import FramePrediction
    from articulation3d_tpu_torch.utils.camera import FOCAL_OPT, intrinsics
    from articulation3d_tpu_torch.utils.coords import camera_to_plane
    k = intrinsics(h, w, FOCAL_OPT)
    proj = lambda p: (p @ k.T)[:, :2] / (p @ k.T)[:, 2:3]
    a, b = np.array([-0.5, -0.8, 3.0]), np.array([-0.5, 0.8, 3.0])
    hinge = proj(np.stack([a, b])).reshape(4)
    preds = []
    for theta in np.linspace(-0.4, 0.4, n):
        d = np.array([np.cos(theta), 0.0, np.sin(theta)])
        quad = proj(np.stack([a, b, b + 1.2 * d, a + 1.2 * d]))
        mask = np.zeros((h, w), np.uint8)
        cv2.fillPoly(mask, [np.round(quad).astype(np.int32)], 1)
        ys, xs = np.nonzero(mask)
        box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)
        nrm = np.array([-np.sin(theta), 0.0, np.cos(theta)])
        enc = axis_to_angle_offset(hinge[None], ((box[:2] + box[2:]) / 2.0)[None])[0]
        preds.append(FramePrediction(
            boxes=box[None], scores=np.array([0.9]), classes=np.array([0]),
            masks=mask[None].astype(bool), planes=camera_to_plane(nrm * float(nrm @ a))[None],
            rot_axis=enc[None, :3], tran_axis=np.zeros((1, 2), np.float32)))
    return preds, hinge


def test_door_clip_articulation_recovered_on_the_card():
    from articulation3d_tpu_torch.temporal import optimizer as topt
    from articulation3d_tpu_torch.temporal import optimize_planes, track_planes
    from articulation3d_tpu_torch.utils.metrics import EA_metric, Line
    preds, hinge = _door_clip()
    random.seed(2020)
    tracks = track_planes(preds)
    opt = optimize_planes(preds, tracks, "3dc", h=480, w=640, device="cuda")
    gt = Line([hinge[1], hinge[0], hinge[3], hinge[2]])
    eas = []
    for p in opt:
        seg = topt._decode_axis(p, "rot", 480, 640)[0].astype(np.float64)
        eas.append(EA_metric(Line([seg[1], seg[0], seg[3], seg[2]]), gt, size=(640, 480)))
    assert len(tracks["rot"]) == 1 and len(tracks["trans"]) == 0, tracks
    assert len(tracks["rot"][0]["ids"]) == 30
    assert tracks["rot"][0]["has_rot"] is True
    assert all(np.allclose(p.scores, 0.9) for p in opt)
    assert min(eas) > 0.8, eas


def _sweep_case(name: str):
    """(kind, mask, normal, offset, p0, dir, hypotheses) at 480x640: the door
    clip's frame-0 seed under both grids; a plane through the camera's
    horizon (rows above it lift behind the camera, rows beside it far
    away); the plane z = 2^-40 moved by -1 x (-0.3, 0, 2^-40 - 2^-63),
    whose points land at z = 2^-63 with px ~ 1e21, beyond int32 and int64."""
    from articulation3d_tpu_torch.temporal import optimizer as topt
    preds, _ = _door_clip()
    normal, offset, p0, dvec = topt._seed_geometry(preds[0], 0, "rot", 480, 640)
    door = preds[0].masks[0].astype(np.float32)
    band = np.zeros((480, 640), np.float32)
    band[190:230, 160:480] = 1.0
    tilt = np.array([0.0, 1.0, 0.05]) / np.linalg.norm([0.0, 1.0, 0.05])
    d = 2.0 ** -40
    return preds, {
        "door_rot": ("rot", door, normal, offset, p0, dvec, ROT_ANGLES),
        "door_trans": ("trans", door, normal, offset, p0, dvec, TRANS_STEPS),
        "behind_camera": ("rot", band, tilt, 1.0, np.array([0.1, 0.0, 2.0]),
                          np.array([0.6, 0.0, 0.8]), ROT_ANGLES),
        "near_zero_depth": ("trans", door, np.array([0.0, 0.0, 1.0]), d, np.zeros(3),
                            np.array([-0.3, 0.0, d - 2.0 ** -63]), np.array([-1.0, 0.0, 0.5])),
    }[name]


@pytest.mark.parametrize("name", ["door_rot", "door_trans", "behind_camera",
                                  "near_zero_depth"])
def test_sweeps_and_iou_on_the_card_match_the_cpu(name):
    """Masks equal up to 1e-4 of the pixels, IoU within 1e-5 with the same
    NaN pattern."""
    from articulation3d_tpu_torch.temporal import kernels as tk
    preds, (kind, mask, normal, offset, p0, dvec, hyp) = _sweep_case(name)
    masks = torch.from_numpy(np.stack([p.masks[0] for p in preds])).float()

    def run(dev):
        f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
        if kind == "rot":
            return tk.rotation_sweep(f32(mask), f32(normal), f32(offset), f32(p0), f32(dvec),
                                     f32(hyp), h=480, w=640)
        return tk.translation_sweep(f32(mask), f32(normal), f32(offset), f32(dvec), f32(hyp),
                                    h=480, w=640)

    cpu, card = run("cpu"), run("cuda")
    diff = int(((card.cpu() > 0.5) != (cpu > 0.5)).sum())
    iou_cpu = tk.iou_matrix(masks, cpu)
    iou_card = tk.iou_matrix(masks.cuda(), cpu.cuda()).cpu()
    ierr = float(np.nanmax(np.abs(iou_card.numpy() - iou_cpu.numpy())))
    assert diff <= 1e-4 * cpu.numel(), diff
    assert ierr <= 1e-5 and bool((torch.isnan(iou_card) == torch.isnan(iou_cpu)).all()), ierr
    if name == "near_zero_depth":
        # saturating-cast semantics: the whole mask lands in column W-1
        hit = torch.nonzero(card[0].cpu() > 0.5)
        assert hit.shape[0] == 3 and bool((hit[:, 1] == 639).all()), hit.tolist()


def test_detector_then_track_and_optimise_on_a_shifted_clip(serving, monkeypatch):
    from articulation3d_tpu_torch.temporal import optimizer as topt
    from articulation3d_tpu_torch.temporal import optimize_planes, track_planes
    cfg, _, model = serving
    pipe = _pipeline(cfg, model)
    frames = _shifted_clip()
    preds = pipe.run(frames)
    sweeps = []
    for name in ("rotation_sweep", "translation_sweep"):
        fn = getattr(topt, name)
        monkeypatch.setattr(topt, name, lambda *a, fn=fn, **k: sweeps.append(1) or fn(*a, **k))
    random.seed(2020)
    tracks = track_planes(preds)
    opt = optimize_planes(preds, tracks, "3dc", h=pipe.output_height, w=pipe.output_width,
                          device=pipe.device)
    assert len(tracks["rot"]) + len(tracks["trans"]) > 0, "no detection persisted over 10 frames"
    assert sweeps and len(opt) == len(frames)
    assert all(np.isfinite(p.scores).all() for p in opt)


# --------------------------------------------------------------------------- #
# the CLI's body, the rest of export and vis
# --------------------------------------------------------------------------- #

def test_cli_body_with_save_obj_writes_its_artefacts(serving, tmp_path, monkeypatch):
    from articulation3d_tpu_torch import infer, tracing
    from articulation3d_tpu_torch.video import io as vio
    cfg, _, model = serving
    frames = _shifted_clip()
    handed = []
    write_video = vio.write_video
    monkeypatch.setattr(vio, "write_video", lambda path, fr, **kw: handed.append(
        [f.shape for f in fr]) or write_video(path, fr, **kw))
    with tracing.recording() as rec:
        infer.run_video(_pipeline(cfg, model), frames, 30.0, str(tmp_path), conf_threshold=0.0,
                        save_obj=True)
    sizes = {n: os.path.getsize(tmp_path / "frame_0000" / n)
             for n in ("arti_pred.obj", "arti_pred.mtl")
             if os.path.exists(tmp_path / "frame_0000" / n)}
    assert rec.counter("k1.launches") > 0
    # without an mp4 encoder in OpenCV the frames handed to the writer stand in
    assert handed and len(handed[0]) == len(frames) and handed[0][0] == (480, 4 * 640, 3)
    assert sizes.get("arti_pred.obj", 0) > 0 and sizes.get("arti_pred.mtl", 0) > 0, sizes


def test_export_and_vis_on_the_cli_detections(serving, tmp_path):
    """The RLE-input plane meshes, world transforms, camera and axis
    primitives, the .ply/.obj writers, the webview tilt, `render_img`, the
    normal sphere, the affinity heatmap, the match and box drawing and the
    labelled overlays, on the detections of two shifted frames (at most 10
    each)."""
    from PIL import Image

    from articulation3d_tpu_torch import export, vis
    from articulation3d_tpu_torch.utils.rle import rle_encode
    cfg, _, model = serving
    frames = _shifted_clip()[:2]
    dets = _pipeline(cfg, model).run(frames)
    top = [np.arange(min(10, len(p))) for p in dets]
    out = str(tmp_path)
    p0 = dets[0]
    segs = [rle_encode(m.astype(np.uint8)) for m in p0.masks[top[0]]]
    meshes, uv_maps = export.get_single_image_mesh_plane(p0.planes[top[0]], segs, frames[0])
    cam = {"position": np.array([0.2, 1.5, -0.3]),
           "rotation": np.array([np.cos(0.35), 0.0, np.sin(0.35), 0.0])}
    world = export.transform_meshes(meshes, cam)
    back = export.get_plane_params_in_local(
        export.get_plane_params_in_global(p0.planes[top[0]], cam), cam)
    tilted = export.rotate_mesh_for_webview(world)
    cams = export.get_camera_meshes(
        [{"position": cam["position"], "lookat": [0.0, 0.0, 1.0], "vertical": [0, 1, 0]}])
    axis = export.primitives.get_axis_mesh(0.02, [0, 0, 1], [0.3, 0.2, 2.0])
    verts = np.concatenate([m.verts for m in tilted] + [cams[0][0].verts, axis.verts])
    offsets = np.cumsum([0] + [len(m.verts) for m in tilted] + [len(cams[0][0].verts)])
    faces = np.concatenate([m.faces + o for m, o in zip(tilted + [cams[0][0], axis], offsets)])
    export.write_ply(verts, np.full((len(verts), 3), 128), faces,
                     os.path.join(out, "scene.ply"))
    export.write_obj(verts, None, faces, os.path.join(out, "scene.obj"))
    rendered = vis.render_img(out, meshes, uv_maps)
    unit = lambda v: v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    sphere = vis.get_normal_figure(unit(p0.planes[top[0][0]]), [unit(p0.planes[top[0][1:]])])
    b0, b1 = dets[0].boxes[top[0]], dets[1].boxes[top[1]]
    lt = np.maximum(b0[:, None, :2], b1[None, :, :2])
    rb = np.minimum(b0[:, None, 2:], b1[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.maximum(area(b0)[:, None] + area(b1)[None] - inter, 1e-9)
    matching = [int(np.argmax(r)) if r.max() > 0.5 else -1 for r in iou]
    aff = vis.save_affinity_after_stitch(iou, len(b0), len(b1), matching, out)
    pairs = np.asarray([[i, j] for i, j in enumerate(matching) if j >= 0]).reshape(-1, 2)
    bgr = [f[:, :, ::-1].copy() for f in frames]
    match_img = vis.draw_match(bgr[0], bgr[1], dets[0].box_centers[top[0]],
                               dets[1].box_centers[top[1]], pairs, [1] * len(pairs), factor=1)
    im1, _ = vis.draw_bbox(Image.fromarray(bgr[0]), Image.fromarray(bgr[1]), b0.tolist(),
                           b1.tolist(), matching)
    seg = vis.get_labeled_seg(p0, 0.0, vis.ArtiVisualizer(bgr[0]))
    gt = {"annotations": [{"bbox": b.tolist(), "bbox_mode": 0, "category_id": 0}
                          for b in b0[:3]]}
    gt_seg = vis.get_gt_labeled_seg(gt, vis.ArtiVisualizer(bgr[0]))
    assert len(meshes) == len(top[0]) and all(len(m.faces) > 0 for m in meshes)
    assert os.path.getsize(os.path.join(out, "scene.ply")) > 0
    assert os.path.getsize(os.path.join(out, "scene.obj")) > 0
    assert os.path.exists(os.path.join(out, "render_0.png")) and os.path.exists(aff)
    assert rendered.shape == (480, 640, 3) and (rendered < 255).any()
    assert sphere.shape == (480, 640, 3) and (sphere < 250).any()
    assert np.abs(back - p0.planes[top[0]]).max() <= 1e-3 * np.abs(p0.planes[top[0]]).max()
    assert match_img.height == 2 * 480 + 45 and im1.size == (640, 480)
    assert seg.shape == gt_seg.shape == (480, 640, 3)


# --------------------------------------------------------------------------- #
# the refine head and the DRPN head
# --------------------------------------------------------------------------- #

def test_refine_head_serving_and_its_routes():
    """`model.refine_on true` through `VideoPipeline` (the refine U-Net over
    100 instances per image), then the kernel route against the plain
    route in float32: refined masks by the IoU of their foreground over
    the matched detections (at least 0.95), planes by max error (at most
    1e-4 m)."""
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.video.pipeline import make_inference_step
    cfg = parity_config(refine_on=True)
    sd = serving_weights(cfg)
    model = build_model(cfg, state_dict=sd)
    frames = _noise(16, 0)
    calibrate_depth_bn(model, frames[:8])
    sd.update({f"depth_head.{k}": v.cpu().numpy()
               for k, v in model.depth_head.state_dict().items()})
    with tracing.recording() as rec:
        preds = _pipeline(cfg, model).run(frames)
    assert len(preds) == 16 and rec.counter("k1.launches") == 3 * 2
    for pr in preds:
        assert pr.masks.shape == (len(pr), 480, 640) and np.isfinite(pr.planes).all()
    assert float(np.mean([pr.masks.mean() for pr in preds])) > 0, "refined masks all background"
    del model
    torch.cuda.empty_cache()
    cfg32 = _with_model(cfg, dtype="float32")
    model32 = build_model(cfg32, state_dict=sd)
    batch = torch.from_numpy(np.stack(frames[:8])).cuda()
    outs = {}
    for impl in ("cuda", "torch"):
        model32.config = _with_model(cfg32, roi_pooler_impl=impl)
        step = make_inference_step(model32.config, model32)
        with torch.no_grad():
            res = model32.inference(_images(frames[:8]))
            wire = step(batch)
        masks = np.unpackbits(wire["full_masks_packed"].cpu().numpy(), axis=-1,
                              count=640).astype(bool)
        outs[impl] = (res["detections"], masks)
    agree = route_agreement(outs["cuda"][0], outs["torch"][0], outs["cuda"][1],
                            outs["torch"][1])
    assert agree["matched"] >= 0.9 and agree["fg_iou"] >= 0.95, agree
    assert agree["head_err"]["planes"] <= 1e-4, agree


def test_drpn_head_and_its_routes():
    """`model.rpn.head_convs 5`: one batch through `VideoPipeline`, K1 on its
    three pools, then the kernel route against the plain route in float32:
    the same proposals, and the detections matched."""
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    cfg = parity_config()
    cfg = _with_model(cfg, rpn=dataclasses.replace(cfg.model.rpn, head_convs=5))
    sd = serving_weights(cfg)
    model = build_model(cfg, state_dict=sd)
    frames = _noise(8, 3)
    pools = record_pools(3)
    try:
        with tracing.recording() as rec:
            preds = _pipeline(cfg, model).run(frames)
    finally:
        pools.restore()
    assert len(preds) == 8 and all(len(p) > 0 for p in preds)
    assert rec.counter("k1.launches") == 3
    main_path_err(rac, pools.calls)
    del model, pools
    torch.cuda.empty_cache()
    cfg32 = _with_model(cfg, dtype="float32")
    model32 = build_model(cfg32, state_dict=sd)
    images = _images(frames)
    outs = {}
    for impl in ("cuda", "torch"):
        model32.config = _with_model(cfg32, roi_pooler_impl=impl)
        outs[impl] = model32.inference(images)
    pa, pb = outs["cuda"]["proposals"], outs["torch"]["proposals"]
    assert bool((pa["valid"] == pb["valid"]).all())
    assert float((pa["boxes"] - pb["boxes"]).abs()[pa["valid"]].max()) <= 1e-3
    agree = route_agreement(outs["cuda"]["detections"], outs["torch"]["detections"])
    assert agree["matched"] >= 0.9 and agree["box_err"] < 2.0, agree


# --------------------------------------------------------------------------- #
# the goldens harness on the card
# --------------------------------------------------------------------------- #

def _save_weights(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def test_cpu_written_goldens_through_both_poolers_on_the_card(serving, tmp_path):
    """A fixture from the port's probe on the CPU (the model at full width,
    float32, 200 proposals, 20 detections), then the `compare_goldens` CLI
    on the card with the gather pooler (the CPU's route) and the kernel."""
    from articulation3d_tpu_torch import compare_goldens as cli
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.evaluation import goldens
    from articulation3d_tpu_torch.models.planercnn import build_model
    _, sd, _ = serving
    image = np.random.RandomState(11).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    meta = {"topk": 200, "dets": 20, "score_thresh": 0.0}
    cfg = cli._config_for({"image": image, **{f"meta_{k}": np.asarray(v)
                                              for k, v in meta.items()}}, "torch")
    fixture = goldens.goldens_from_probe(build_model(cfg, device="cpu", state_dict=sd), image,
                                         meta)
    path, weights = str(tmp_path / "port_480x640.npz"), str(tmp_path / "weights.pth")
    goldens.save_goldens(path, fixture)
    _save_weights(sd, weights)
    reports = {}
    for pooler in ("torch", "cuda"):
        with tracing.recording() as rec:
            reports[pooler] = cli.main(["--goldens", path, "--weights", weights,
                                        "--pooler", pooler])
        reports[pooler]["k1"] = rec.counter("k1.launches")
    os.remove(weights)
    r, k = reports["torch"], reports["cuda"]
    depth_rel = r["depth_max_err"] / max(float(np.abs(fixture["depth"]).max()), 1e-30)
    assert r["k1"] == 0 and k["k1"] >= 2, (r["k1"], k["k1"])
    assert r["proposal_top100_match_frac"] == 1.0 and r["det_match_frac"] >= 0.99, r
    assert r["det_box_max_err"] < 0.01 and r["det_score_max_err"] < 1e-3, r
    assert r["masks_max_err"] < 1e-2 and r["planes_max_err"] < 1e-2 and depth_rel < 1e-4, r
    assert k["det_match_frac"] >= 0.9 and k["det_box_max_err"] < 2.0, k


@pytest.fixture(scope="module")
def oracle_weights(tmp_path_factory):
    """The oracle fixtures' weights, which the port builds bit for bit as
    `bias_for_detections(random_state_dict(0))`, and their .pth file."""
    from articulation3d_tpu_torch.weights import bias_for_detections, random_state_dict
    sd = bias_for_detections(random_state_dict(0))
    path = str(tmp_path_factory.mktemp("oracle") / "oracle_biased.pth")
    _save_weights(sd, path)
    yield sd, path
    os.remove(path)


@pytest.mark.parametrize("pooler", ["cuda", "torch"])
@pytest.mark.parametrize("name", ORACLE)
def test_oracle_fixture_through_each_route_on_the_card(oracle_weights, name, pooler):
    """At the gates of tests/test_torch_goldens.py::test_fixture_at_tight_gates:
    every top-100 proposal matched, at least 99 % of the detections, boxes
    within 0.01 px, scores within 1e-3, masks and planes within 1e-2."""
    from articulation3d_tpu_torch import compare_goldens as cli
    from articulation3d_tpu_torch import tracing
    with tracing.recording() as rec:
        r = cli.main(["--goldens", os.path.join(ROOT, "tests", "fixtures", name),
                      "--weights", oracle_weights[1], "--pooler", pooler])
    k1 = rec.counter("k1.launches")
    assert (k1 >= 2) if pooler == "cuda" else (k1 == 0), (pooler, k1)
    assert r["proposal_top100_match_frac"] == 1.0 and r["det_ref_count"] >= 10, r
    assert r["det_match_frac"] >= 0.99 and r["det_box_max_err"] < 0.01, r
    assert r["det_score_max_err"] < 1e-3, r
    assert r["masks_max_err"] < 1e-2 and r["planes_max_err"] < 1e-2, r


@pytest.fixture(scope="module")
def cpu_probe(oracle_weights):
    """The CPU's float32 probe on the 480x640 oracle fixture."""
    from articulation3d_tpu_torch import compare_goldens as cli
    from articulation3d_tpu_torch.evaluation.goldens import load_goldens, run_probe
    from articulation3d_tpu_torch.models.planercnn import build_model
    g = load_goldens(os.path.join(ROOT, "tests", "fixtures", ORACLE[0]))
    cfg = cli._config_for(g, "cuda")
    return g, cfg, run_probe(build_model(cfg, device="cpu", state_dict=oracle_weights[0]),
                             g["image"])


@pytest.mark.parametrize("setting", ["cudnn default", "cudnn deterministic", "cudnn off"])
def test_card_features_depart_from_the_cpu_within_float32_sums(oracle_weights, cpu_probe,
                                                               setting):
    """The card's float32 model (kernel route) against the CPU's on the
    fixture: each FPN level within 1e-5 of its largest value (float32 sums
    in another order), with cuDNN's default algorithms, deterministic ones,
    and cuDNN off (PyTorch's own convolutions)."""
    from articulation3d_tpu_torch.evaluation.goldens import FEATURE_KEYS, run_probe
    from articulation3d_tpu_torch.models.planercnn import build_model
    g, cfg, cpu = cpu_probe
    model = build_model(cfg, device="cuda", state_dict=oracle_weights[0])
    torch.backends.cudnn.deterministic = setting == "cudnn deterministic"
    torch.backends.cudnn.enabled = setting != "cudnn off"
    try:
        probe = run_probe(model, g["image"])
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.enabled = True
    feat = {k: float(np.abs(probe["features"][k] - cpu["features"][k]).max()
                     / np.abs(cpu["features"][k]).max()) for k in FEATURE_KEYS}
    assert all(v <= 1e-5 for v in feat.values()), (setting, feat)


# --------------------------------------------------------------------------- #
# the deployment preset beside the parity caps
# --------------------------------------------------------------------------- #

def _preset_config():
    """`serving_config()` (500 post-NMS proposals, 30 detections per image)
    at score threshold 0, as `parity_config` sets it."""
    from articulation3d_tpu_torch.config import serving_config
    cfg = serving_config()
    return _with_model(cfg, roi_heads=dataclasses.replace(cfg.model.roi_heads,
                                                          score_thresh_test=0.0))


@pytest.fixture(scope="module")
def preset(serving):
    from articulation3d_tpu_torch.models.planercnn import build_model
    cfg = _preset_config()
    yield cfg, build_model(cfg, state_dict=serving[1])
    torch.cuda.empty_cache()


def test_serving_preset_pipeline_and_its_pools(serving, preset):
    """Both caps through `VideoPipeline` at batch 8 (K1 three times a
    batch, at most the cap's detections, finite outputs), then K1's record
    and output on each one's own pool inputs (the preset's box pool of 500
    ROIs per image, mask and plane 30; parity's 1000 and 100)."""
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    frames = _noise(16, 0)
    for cfg, model in ((serving[0], serving[2]), preset):
        with tracing.recording() as rec:
            preds = _pipeline(cfg, model).run(frames)
        assert rec.counter("k1.launches") == 3 * 2
        assert len(preds) == len(frames) and all(len(p) > 0 for p in preds)
        assert all(len(p) <= cfg.model.roi_heads.detections_per_image for p in preds)
        for pr in preds:
            for a in (pr.boxes, pr.scores, pr.planes, pr.rot_axis, pr.tran_axis):
                assert np.isfinite(a).all()
        pools = record_pools(3)
        try:
            model.inference(_images(frames[8:]))
        finally:
            pools.restore()
        for roi_feats, boxes, kw in pools.calls:
            check_record(rac, roi_feats, boxes, kw["valid"], kw["resolution"],
                         kw["sampling_ratio"], kw["aligned"])
        main_path_err(rac, pools.calls)


def _contract(parity, preset, frames) -> list:
    """The `serving_config` contract on the card: both models on the same
    frames (batches of 8); the RPN survivors per frame and the regime they
    put it in (<= 500: both caps see the same proposals, so the preset's
    detections must be parity's top 30; 501-999: the preset's cap bites;
    >= 1000: both do); the preset's detections matched against parity's at
    bench.py's on-chip gates (box 0.5 px, score 1e-3, mask 5e-2): every one
    in a frame under 500, at least 90 % over the frames above it; the depth
    maps of the two equal within 1e-5.  Returns the regimes."""
    from articulation3d_tpu_torch.evaluation.serving_contract import match_detections
    keys = ("boxes", "scores", "classes", "valid", "masks")
    got = {"parity": [], "preset": []}
    surv = []
    for i in range(0, len(frames), 8):
        images = _images(frames[i:i + 8])
        outs = {}
        for name, model in (("parity", parity), ("preset", preset)):
            out = model.inference(images)
            d = out["detections"]
            got[name].append({k: (getattr(d, k).float() if k == "masks" else getattr(d, k))
                              .cpu().numpy() for k in keys})
            outs[name] = out
        surv += outs["parity"]["proposals"]["valid"].sum(1).tolist()
        s_surv = outs["preset"]["proposals"]["valid"].sum(1).tolist()
        assert s_surv == [min(n, 500) for n in surv[-len(s_surv):]]
        a, b = outs["preset"]["depth"], outs["parity"]["depth"]
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    cat = {n: {k: np.concatenate([c[k] for c in got[n]]) for k in keys} for n in got}
    regimes = ["fits" if n <= 500 else "preset-saturated" if n < 1000 else "both-saturated"
               for n in surv]
    fits = [f for f, r in enumerate(regimes) if r == "fits"]
    over = [f for f, r in enumerate(regimes) if r != "fits"]
    sel = lambda d, fs: {k: v[fs] for k, v in d.items()}
    gates = dict(box_tol=0.5, score_tol=1e-3, mask_tol=5e-2)
    assert match_detections(cat["preset"], cat["parity"], **gates)["n_serving"] > 0
    for f in fits:
        r = match_detections(sel(cat["preset"], [f]), sel(cat["parity"], [f]), **gates)
        assert r["n_matched"] == r["n_serving"] and r["n_parity_extra"] == 0, (f, r)
    if over:
        m = match_detections(sel(cat["preset"], over), sel(cat["parity"], over), **gates)
        assert m["n_matched"] >= 0.9 * m["n_serving"], m
    return regimes


def test_serving_preset_contract_on_the_card(serving, preset):
    _contract(serving[2], preset[1], _noise(16, 0))


def test_serving_preset_contract_where_every_frame_fits(serving, preset):
    """At 100 proposals per level before NMS no frame can keep more than
    500, so every frame is in the regime where the preset's detections are
    parity's top 30."""
    from articulation3d_tpu_torch.models.planercnn import build_model
    small = [build_model(_with_model(c, rpn=dataclasses.replace(c.model.rpn,
                                                                pre_nms_topk_test=100)),
                         state_dict=serving[1]) for c in (serving[0], preset[0])]
    assert set(_contract(*small, _noise(16, 0))) == {"fits"}


# --------------------------------------------------------------------------- #
# the stage profilers
# --------------------------------------------------------------------------- #

def _expected_calls(table: str, name: str) -> tuple:
    """(K1 called, K2 called) in a run of the row `name` of a profiler's
    table: K1 in every pool of the kernel route, K2 in its backward where
    gradient reaches the features (stage 3 freezes the trunk, so its loss
    and step rows send none)."""
    if "gather" in name or table == "depth":
        return (False, False)
    if table.startswith("inference"):
        return (name not in ("backbone+fpn", "+rpn (proposals)"), False)
    k1 = "kernel" in name or name.startswith(("loss", "full step"))
    k2 = "fwd+bwd (kernel)" in name or (
        table == "train-1" and name.startswith(("loss fwd+bwd", "full step")))
    return (k1, k2)


class _StageProbe:
    """The `around` hook handed to a profiler's `main()`
    (`profiling.time_rows`).  For each row: K1's and K2's calls per timed
    run (the recorder's counters), then one more run that keeps the row's
    pool inputs (`record_pools`): K1 is held against its plain version on
    them (once more with every slot valid where some are not: at the
    profilers' weights no detection may pass the score threshold), and
    the training pool rows' kernel route against their gather route, the
    pooled ROIs within 1e-5 x max|gather| (K1's float32 tolerance), the
    gradients to p2..p5 within 1e-4 x max|gather| per level (K2's)."""

    def __init__(self, rac, runs: int):
        self.rac, self.runs = rac, runs
        self.rows, self.kernel_pool = {}, {}

    def __call__(self, name, fn, timed) -> float:
        from articulation3d_tpu_torch import tracing
        from articulation3d_tpu_torch.profiling import reduce_sum
        with tracing.recording() as rec:
            dt = timed()
        d1, d2 = rec.counter("k1.launches"), rec.counter("k2.launches")
        assert d1 % self.runs == 0 and d2 % self.runs == 0, (name, d1, d2)
        pools = record_pools(16)
        try:
            out = fn()
            reduce_sum(out).item()
        finally:
            pools.restore()
        if d1 and pools.calls:
            main_path_err(self.rac, pools.calls)
            partial = [(f, b, dict(kw, valid=None)) for f, b, kw in pools.calls
                       if kw.get("valid") is not None and not bool(kw["valid"].all())]
            main_path_err(self.rac, partial)
        if name.startswith("train pool"):
            self._pool_routes(name, out)
        self.rows[name] = (d1 // self.runs, d2 // self.runs)
        return dt

    def _pool_routes(self, name: str, out) -> None:
        key = "fwd+bwd" if "fwd+bwd" in name else "fwd"
        if "(kernel" in name:
            self.kernel_pool[key] = out
            return
        got = self.kernel_pool.pop(key)
        tol = 1e-5 if key == "fwd" else 1e-4
        for a, b in ([(got, out)] if key == "fwd" else list(zip(got, out))):
            assert float((a - b).abs().max()) <= tol * float(b.abs().max()), name


PROFILES = {
    "inference-parity": ["profile_inference", "--preset", "parity", "--batch", "8"],
    "inference-serving": ["profile_inference", "--preset", "serving", "--batch", "8"],
    "depth": ["profile_depth", "--batch", "8"],
    "train-1": ["profile_train", "--stage", "1", "--ims", "16"],
    "train-3": ["profile_train", "--stage", "3", "--ims", "8"]}


@pytest.mark.parametrize("table", list(PROFILES))
def test_stage_profiler_rows_call_the_right_kernels(table):
    """Each profiler through its CLI's `main()` with no `--device` (the
    card), one timed run a row after two warm ones: every row has a time,
    K1 and K2 are called by exactly the rows that should call them, and
    each kernel agrees with its plain version on the row's inputs."""
    import importlib

    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    argv = PROFILES[table]
    cli = importlib.import_module(f"articulation3d_tpu_torch.{argv[0]}")
    probe = _StageProbe(rac, runs=1 + 2)
    rows = cli.main(argv[1:] + ["--steps", "1"], around=probe)
    torch.cuda.empty_cache()
    assert not [(name, why) for name, dt, why in rows if dt is None]
    assert [r[0] for r in rows] == list(probe.rows)
    for name, (k1, k2) in probe.rows.items():
        assert (k1 > 0, k2 > 0) == _expected_calls(table, name), (name, k1, k2)
    assert not probe.kernel_pool, list(probe.kernel_pool)
