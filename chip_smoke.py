#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`articulation3d_tpu_torch`) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure is an exception and a
non-zero exit):

  1. device and build: the card's name and power limit, and the build of
     both ROIAlign kernels (csrc/roi_align_fwd.cu, K1, and
     csrc/roi_align_adj.cu, K2; one nvcc each, started together) with their
     ptxas reports;
  2. each kernel against its plain torch version on the card, on a 480x640
     pyramid (C = 256, B = 2) for the box (N = 1000, 7x7, V2, ratio 0),
     mask (N = 100, 14x14, V1, ratio 2) and plane (N = 100, 14x14, V1,
     ratio 0) pools, with invalid rows, plus the 5:1 and bumped-level 9:1
     box sets: K1 in float32 and bfloat16, with the record (level, y0, x0,
     nty, ntx) its fused prologue writes held integer-exactly against
     torch `_prepare` and `_roi_record` on the card; K2 in float32 from
     that record, with the transpose identity <K1(F), G> = <F, K2(G)>
     summed in float64;
  3. the main path: `VideoPipeline` at full width (R50-FPN, 1000
     proposals, 100 detections, mask/plane/axis/depth heads, the shipped
     configs/config.yaml with seeded random weights and score threshold 0)
     on 16 synthetic 480x640 frames in two chunks of 8, with the kernel's
     launch count, per-chunk wall times and peak memory, and no call of
     the torch prologue `_prepare` on the way; then, at the main path's own
     pool inputs, K1's record against `_prepare` and its time (wrapper and
     kernel alone) beside its plain version and its bound;
  4. the kernel path against the plain gather path, whole model, float32;
  5. the training path: `Trainer` on the shipped configs/step1_bbox.yaml at
     full width (R50-FPN, RPN 2000/1000, 512 ROIs per image, ims 16,
     480x640, bf16 trunk) for 2 warm and 20 timed steps on one synthetic
     batch, with K1 and K2 launches per step, the loss curve, peak memory
     and a profile of one warm step; then, at the path's own box pool
     inputs, K1's record against `_prepare`, and K1's and K2's times beside
     their plain versions and their bounds;
  6. training-path parity: one float32 step with the kernel pooler and one
     with the gather pooler under autograd, losses and the p2 convs'
     gradients compared; then the two poolers' gradients to p2..p5 on the
     kernel run's own features, boxes and cotangent;
  7. the temporal stage at full width (480x640, FOCAL_OPT): (a) the
     known-answer clip of tests/test_temporal_truth.py (30 frames of a
     door rotating about a vertical hinge) through `track_planes` and
     `optimize_planes(..., "3dc")` with the sweeps on the card: one track,
     `has_rot`, no score down-weighted, EA > 0.8 on every frame, and the
     stage once more under torch.profiler (the card's busy share); (b) the
     card's `rotation_sweep`, `translation_sweep` and `iou_matrix` against
     the same torch functions on the CPU, on that clip's seed and on seeds
     whose planes put pixels behind the camera and at z ~ 0 (masks equal
     up to 1e-4 of the pixels, IoU within 1e-5), with their card times;
     (c) `VideoPipeline` (phase 3's config) on 32 frames of one noise image
     shifted by a pixel per frame, then track and optimise: tracks, how
     many have `has_rot`, sweeps per second, and the walls;
  8. the CLI's body, `infer.run_video`, on those 32 frames with
     `--save-obj` into `.chip_smoke/cli/`: `output.mp4` (or, without an
     encoder, the frames handed to the writer) and
     `frame_0000/arti_pred.{obj,mtl}` exist and are non-empty; K1's launches
     on this path, and the walls of its stages;
  9. a JSON line of kernel measurements, then the device JSON as the last
     line.

Exits non-zero without a result when there is no CUDA device or the
package is not beside this script.  TF32 is off for every phase.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
STRIDES = (4, 8, 16, 32)
POOLS = {"box": (7, 0, True), "mask": (14, 2, False), "plane": (14, 0, False)}


def _log(*a):
    print(*a, flush=True)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pyramid(gen, b, dtype):
    import torch
    return [torch.randn((b, h, w, 256), generator=gen, device="cuda").to(dtype)
            for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]


def _random_boxes(rs, b, n):
    sizes = rs.uniform(20, 480, (b, n, 1))
    x1 = rs.uniform(0, 600, (b, n, 1))
    y1 = rs.uniform(0, 440, (b, n, 1))
    return np.concatenate([x1, y1, np.minimum(x1 + sizes, 640),
                           np.minimum(y1 + sizes * 0.7, 480)], 2).astype(np.float32)


def _adversarial_boxes():
    """bench.py's aspect5 (in-contract 5:1) and aspect9_bumped_level sets."""
    adv = []
    for max_sqrt_area in (112.0, 224.0, 448.0):
        s = max_sqrt_area * 0.99
        for aspect in (5.0, 1.0 / 5.0):
            w, h = s * np.sqrt(aspect), s / np.sqrt(aspect)
            for cx, cy in ((w / 2 + 1, h / 2 + 1), (320, 240)):
                adv.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    adv = np.asarray(adv, np.float32)[None]
    adv[..., 0::2] = adv[..., 0::2].clip(0, 640)
    adv[..., 1::2] = adv[..., 1::2].clip(0, 480)
    nine = np.asarray([[[10.0, 200.0, 344.0, 237.0],
                        [200.0, 10.0, 237.0, 444.0]]], np.float32)
    return {"aspect5": adv, "aspect9_bumped_level": nine}


def phase_kernel_parity(rac):
    """Kernel vs plain version; f32 within 1e-5 x max|out| (the same float32
    sums in another order), bf16 within 1e-2 x max|out| (the stated bf16
    budget; both read the same bf16 features with float32 weights)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    rs = np.random.RandomState(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        feats2 = _pyramid(gen, 2, dtype)
        cases = []
        for name, (p, sr, aligned) in POOLS.items():
            n = 1000 if name == "box" else 100
            boxes = torch.from_numpy(_random_boxes(rs, 2, n)).cuda()
            valid = torch.from_numpy(rs.rand(2, n) > 0.2).cuda()
            cases.append((name, feats2, boxes, valid, p, sr, aligned))
        for name, bx in _adversarial_boxes().items():
            cases.append((name, [f[:1].contiguous() for f in feats2],
                          torch.from_numpy(bx).cuda(), None, 7, 0, True))
        for name, feats, boxes, valid, p, sr, aligned in cases:
            kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr,
                      aligned=aligned, valid=valid)
            got = rac.multilevel_roi_align_cuda(feats, boxes, **kw)
            want = rac.multilevel_roi_align_separable(feats, boxes, **kw)
            bumped, n_rec = _check_record(rac, feats, boxes, valid, p, sr, aligned)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            zero_ok = valid is None or bool((got[~valid] == 0).all())
            _log(f"[kernel-parity] {name:22s} {str(dtype)[6:]:8s} P={p:2d} sr={sr} "
                 f"aligned={int(aligned)} rois={boxes.shape[0] * boxes.shape[1]:5d} "
                 f"max_abs_err={err:.3e} max|out|={scale:.3e} tol={tol * scale:.3e} "
                 f"invalid_rows_zero={zero_ok}; record == _prepare == _roi_record on "
                 f"{n_rec} ROIs ({bumped} from a bumped level)")
            assert np.isfinite(err) and err <= tol * scale, (name, dtype, err)
            assert zero_ok, (name, dtype)


def _check_record(rac, feats, boxes, valid, p, sr, aligned):
    """K1's record (its fused prologue, on the card) against torch
    `_prepare` and `_roi_record` on the card, integer-exactly; returns
    (ROIs pooled from a bumped level, ROIs checked)."""
    import torch
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(opts, min_level=2))
    shapes = [f.shape for f in feats]
    want = rac._record_of(rac._prepare(shapes, boxes, valid=valid, **opts))
    twin = rac._roi_record(shapes, boxes, valid=valid, **opts)
    torch.cuda.synchronize()
    bad = (record != want).any(1) | (twin != want).any(1)
    assert not bool(bad.any()), (int(bad.sum()), record[bad][:4].tolist(),
                                 want[bad][:4].tolist(), twin[bad][:4].tolist())
    base = rac.assign_boxes_to_levels(boxes.reshape(-1, 4).float()) - 2
    return int((record[:, 0].long() != base).sum()), int(record.shape[0])


def phase_adjoint_parity(rac):
    """K2 vs its plain version within 1e-4 x max|plain| (float32 atomics
    add in a varying order), and the transpose identity <K1(F), G> =
    <F, K2(G)> in float64 within 1e-5 relative."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    rs = np.random.RandomState(1)
    feats2 = _pyramid(gen, 2, torch.float32)
    cases = []
    for name, (p, sr, aligned) in POOLS.items():
        n = 1000 if name == "box" else 100
        boxes = torch.from_numpy(_random_boxes(rs, 2, n)).cuda()
        valid = torch.from_numpy(rs.rand(2, n) > 0.2).cuda()
        cases.append((name, feats2, boxes, valid, p, sr, aligned))
    for name, bx in _adversarial_boxes().items():
        cases.append((name, [f[:1].contiguous() for f in feats2],
                      torch.from_numpy(bx).cuda(), None, 7, 0, True))
    for name, feats, boxes, valid, p, sr, aligned in cases:
        shapes = [f.shape for f in feats]
        opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
        pr = rac._prepare(shapes, boxes, valid=valid, **opts)
        g = torch.randn((boxes.shape[0] * boxes.shape[1], p, p, 256), generator=gen,
                        device="cuda")
        fwd, record = rac._forward_kernel(feats, boxes, valid, dict(opts, min_level=2))
        got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **opts)
        want = rac.multilevel_roi_align_adjoint_separable(g, shapes, pr)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        lhs = float((fwd.double() * g.double()).sum())
        rhs = float(sum((f.double() * d.double()).sum() for f, d in zip(feats, got)))
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        _log(f"[adjoint-parity] {name:22s} float32  P={p:2d} sr={sr} aligned={int(aligned)} "
             f"rois={boxes.shape[0] * boxes.shape[1]:5d} max_abs_err={err:.3e} "
             f"max|plain|={scale:.3e} tol={1e-4 * scale:.3e}; transpose identity "
             f"<K1(F),G>={lhs:.9e} <F,K2(G)>={rhs:.9e} rel_err={rel:.3e} (tol 1e-5)")
        assert np.isfinite(err) and err <= 1e-4 * scale, (name, err)
        assert rel <= 1e-5, (name, rel)


def _match(ref_boxes, out_boxes, iou_thresh=0.7):
    """Greedy IoU matching in ref order -> (ref_idx, out_idx)."""
    if len(ref_boxes) == 0 or len(out_boxes) == 0:
        return np.zeros(0, int), np.zeros(0, int)
    lt = np.maximum(ref_boxes[:, None, :2], out_boxes[None, :, :2])
    rb = np.minimum(ref_boxes[:, None, 2:], out_boxes[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.clip(area(ref_boxes)[:, None] + area(out_boxes)[None] - inter,
                          1e-9, None)
    used = np.zeros(len(out_boxes), bool)
    ri, oi = [], []
    for i in range(len(ref_boxes)):
        j = int(np.argmax(np.where(used, -1.0, iou[i])))
        if iou[i, j] >= iou_thresh and not used[j]:
            used[j] = True
            ri.append(i)
            oi.append(j)
    return np.asarray(ri, int), np.asarray(oi, int)


def _bound(rac, features, boxes, valid, p, sr, aligned):
    """Least time on an H100 SXM for one pool call: each input cell the
    ROIs need read once (the union of their supports), boxes and valid read
    once, the (B, N, P, P, C) float32 output written once, over 3.35 TB/s;
    and the multiply-adds over the support at the fp32 rate.  Returns
    (ms, "bytes" | "operations")."""
    import torch
    pr = rac._prepare([f.shape for f in features], boxes, strides=STRIDES,
                      output_size=p, sampling_ratio=sr, aligned=aligned, valid=valid)
    ry, rx = rac._predicated_weights(pr)
    lv, b, y0, x0 = (pr[k].long().cpu().numpy() for k in ("levels", "batch_ids", "y0", "x0"))
    ry_nz, rx_nz = (ry != 0).cpu().numpy(), (rx != 0).cpu().numpy()     # (T, P, span)
    c = features[0].shape[-1]
    grids = [np.zeros(f.shape[:3], bool) for f in features]
    flops = 0
    for r in np.nonzero(pr["nty"].cpu().numpy() > 0)[0]:
        h, w = features[lv[r]].shape[1:3]
        ys = np.nonzero(ry_nz[r].any(0))[0]
        xs = np.nonzero(rx_nz[r].any(0))[0]
        ys, xs = ys[y0[r] + ys < h], xs[x0[r] + xs < w]
        if len(ys) and len(xs):
            grids[lv[r]][b[r], y0[r] + ys[0]:y0[r] + ys[-1] + 1,
                         x0[r] + xs[0]:x0[r] + xs[-1] + 1] = True
        sup = lambda nz: sum(int(np.ptp(np.nonzero(row)[0])) + 1 for row in nz if row.any())
        flops += 2 * c * sup(ry_nz[r]) * sup(rx_nz[r])
    cells = sum(int(g.sum()) for g in grids)
    nbytes = (cells * c * features[0].element_size() + boxes.numel() * 4
              + (valid.numel() if valid is not None else 0)
              + boxes.shape[0] * boxes.shape[1] * p * p * c * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "articulation3d_tpu_torch")):
        print("chip_smoke: run from a checkout: articulation3d_tpu_torch/ is "
              "not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from articulation3d_tpu_torch.config import load_config
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    from articulation3d_tpu_torch.weights import random_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _smi()
    kind = torch.cuda.get_device_name(0)

    # 1. device and build -------------------------------------------------
    _log(f"[device] {card}")
    _log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = rac.build_kernels(verbose=True)
    _log(f"[build] {[os.path.relpath(v, ROOT) for v in libs.values()]} in "
         f"{time.perf_counter() - t0:.1f}s")

    # 2. kernels vs plain versions ---------------------------------------
    phase_kernel_parity(rac)
    phase_adjoint_parity(rac)

    # 3. main path -------------------------------------------------------
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    cfg = cfg.replace(weights="", model=dataclasses.replace(
        cfg.model, roi_heads=dataclasses.replace(cfg.model.roi_heads,
                                                 score_thresh_test=0.0)))
    sd = random_state_dict(0)
    # a trained RPN proposes boxes near its anchors; at the random weights'
    # scale the deltas hit the log(1000/16) clamp and most proposals become
    # full-height slivers beyond the kernel's window contract, which it
    # pools from a coarser level by design (roi_align_pallas.py docstring)
    for k in ("weight", "bias"):
        sd[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= 0.01
    model = build_model(cfg, state_dict=sd)
    pipe = VideoPipeline(cfg, model, batch_size=8, conf_threshold=0.0)
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(16)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prologue_calls = _count_calls(rac, "_prepare")
    rac.multilevel_roi_align_cuda.launches = 0
    try:
        preds = pipe.run(frames, verbose=True)
    finally:
        prologue_calls.restore()
    launches = rac.multilevel_roi_align_cuda.launches
    _log(f"[main] model dtype {cfg.model.dtype}, pooler {cfg.model.roi_pooler_impl}, "
         f"batch 8, 16 frames 480x640; kernel launches {launches}; torch prologue "
         f"(_prepare) calls {prologue_calls.n}; valid ROIs per pool stage {pipe.pool_valid}")
    assert prologue_calls.n == 0, prologue_calls.n
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
    assert launches >= 3 * 2, launches
    for stage in ("box", "mask", "plane"):
        assert pipe.pool_valid.get(stage, 0) > 0, (stage, pipe.pool_valid)
    walls = pipe.chunk_walls
    pipe.run(frames)
    _log(f"[main] warm repeat of the 16 frames: chunk walls "
         f"{['%.4f' % w for w in pipe.chunk_walls]} s ({card})")
    _log(f"[main] detections per frame {[len(p) for p in preds][:4]}... "
         f"chunk walls {['%.4f' % w for w in walls]} s; steady-state "
         f"{8 / float(np.mean(walls[1:])):.2f} frames/s ({card}); "
         f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    _profile_step(pipe, frames[:8], card)

    # the kernel at the main path's own pool inputs (last chunk)
    captured = []
    pool = model._pool

    def recording_pool(roi_feats, boxes, **kw):
        captured.append((roi_feats, boxes, kw))
        return pool(roi_feats, boxes, **kw)

    model._pool = recording_pool
    try:
        with torch.no_grad():
            images = preprocess_images(torch.from_numpy(np.stack(frames[8:])).cuda())
            feats = model.features(images)
            t_perm = _time_ms(lambda: model.roi_features(feats))
            model.inference(images)
    finally:
        del model._pool
    _log(f"[timing] per-level NCHW->NHWC permute of p2..p5 (batch 8, "
         f"{cfg.model.dtype}): {t_perm:.4f} ms ({card})")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, kernel_ms=0.0)
    bound_by = set()
    per_pool = {}
    for (roi_feats, boxes, kw), stage in zip(captured, ("box", "mask", "plane")):
        p, sr, al = kw["resolution"], kw["sampling_ratio"], kw["aligned"]
        valid = kw["valid"]
        args = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=al,
                    valid=valid)
        bumped, n_rec = _check_record(rac, roi_feats, boxes, valid, p, sr, al)
        ms = _time_ms(lambda: rac.multilevel_roi_align_cuda(roi_feats, boxes, **args))
        kern = _time_kernel(rac, roi_feats, boxes, valid, p, sr, al)
        plain = _time_ms(lambda: rac.multilevel_roi_align_separable(roi_feats, boxes, **args),
                         iters=3, warmup=1)
        bound, by = _bound(rac, roi_feats, boxes, valid, p, sr, al)
        bound_by.add(by)
        _log(f"[timing] {stage:5s} pool P={p:2d} rois={boxes.shape[0] * boxes.shape[1]} "
             f"valid={int(valid.sum())} {str(roi_feats[0].dtype)[6:]}: wrapper {ms:.4f} ms "
             f"(kernel alone {kern:.4f} ms, wrapper's own {ms - kern:.4f} ms), plain "
             f"{plain:.4f} ms, bound {bound:.4f} ms by {by}; wrapper/bound "
             f"{ms / bound:.2f}x, kernel/bound {kern / bound:.2f}x; record == _prepare on "
             f"{n_rec} ROIs ({bumped} bumped) ({card})")
        per_pool[stage] = dict(ms=ms, kernel_ms=kern, plain_ms=plain, bound_ms=bound)
        for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound), ("kernel_ms", kern)):
            tot[k] += v

    # 4. kernel path vs plain path, whole model, float32 ------------------
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32",
                                                  roi_pooler_impl="cuda"))
    model32 = build_model(cfg32, state_dict=sd)
    images = preprocess_images(torch.from_numpy(np.stack(frames[:8])).cuda())
    outs = {}
    for impl in ("cuda", "torch"):
        model32.config = cfg32.replace(model=dataclasses.replace(
            cfg32.model, roi_pooler_impl=impl))
        rac.multilevel_roi_align_cuda.launches = 0
        res = model32.inference(images)
        outs[impl] = res["detections"]
        props = res["proposals"]["boxes"].reshape(-1, 4)
        bumped = int((rac.pallas_level_idx(props, n_levels=4, strides=STRIDES,
                                           output_size=7, sampling_ratio=0,
                                           aligned=True)
                      != rac.assign_boxes_to_levels(props) - 2).sum())
        _log(f"[path-parity] {impl} pooler: kernel launches "
             f"{rac.multilevel_roi_align_cuda.launches}; proposals pooled from a "
             f"bumped level by the kernel: {bumped}/{props.shape[0]}")
    a, b = outs["cuda"], outs["torch"]
    n_ref = n_match = 0
    box_err, head_err = 0.0, {}
    for i in range(images.shape[0]):
        va, vb = a.valid[i].cpu().numpy(), b.valid[i].cpu().numpy()
        ra, rb = a.boxes[i].cpu().numpy()[va], b.boxes[i].cpu().numpy()[vb]
        ri, oi = _match(rb, ra)
        n_ref += len(rb)
        n_match += len(ri)
        if len(ri):
            box_err = max(box_err, float(np.abs(rb[ri] - ra[oi]).max()))
            for key in ("masks", "planes", "rot_axis", "tran_axis"):
                ga = getattr(a, key)[i].cpu().numpy()[va][oi]
                gb = getattr(b, key)[i].cpu().numpy()[vb][ri]
                head_err[key] = max(head_err.get(key, 0.0), float(np.abs(ga - gb).max()))
    frac = n_match / max(n_ref, 1)
    _log(f"[path-parity] detections matched {n_match}/{n_ref} ({frac:.4f}); "
         f"matched box max err {box_err:.4f} px; head max errs {head_err}")
    assert n_ref > 0 and frac >= 0.9, frac
    assert box_err < 2.0, box_err
    assert all(v < 0.75 for v in head_err.values()), head_err

    k1_inference = launches
    del model, model32, pipe
    torch.cuda.empty_cache()

    # 5. training path ----------------------------------------------------
    train = phase_training(rac, card)

    # 6. training path parity, float32 -------------------------------------
    phase_training_parity(rac, train)

    # 7. temporal stage at full width ----------------------------------------
    phase_temporal(card)
    model = build_model(cfg, state_dict=sd)
    pipe = VideoPipeline(cfg, model, batch_size=8, conf_threshold=0.0)
    clip = _shifted_clip()
    phase_temporal_pipeline(pipe, clip, card)

    # 8. the CLI's body with --save-obj --------------------------------------
    k1_cli = phase_artefacts(rac, pipe, clip, card)
    del model, pipe
    torch.cuda.empty_cache()

    # 9. results ---------------------------------------------------------
    max_err = _main_path_err(rac, captured)
    kernels = [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "articulation3d_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "articulation3d_tpu/ops/roi_align_pallas.py:184",
        "launches": k1_inference + train["k1"] + k1_cli,
        "launches_by_path": {"inference": k1_inference, "training": train["k1"],
                             "cli": k1_cli},
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": None,
        # ms, plain_ms and bound_ms above are the serving pools' per batch of
        # 8; each pool's, and the training box pool's at its own inputs:
        "kernel_ms": tot["kernel_ms"],
        "pools": per_pool,
        "training_box_pool": train["k1_train"],
        "record_exact": True,
    }, {
        "name": "roi_align_adj",
        "route": "cuda",
        "source": "articulation3d_tpu_torch/csrc/roi_align_adj.cu",
        "replaces": "articulation3d_tpu/ops/roi_align_pallas.py:519",
        "launches": train["k2"],
        "launches_by_path": {"inference": 0, "training": train["k2"], "cli": 0},
        "max_abs_err": train["adj_err"],
        "ms": train["adj_ms"],
        "plain_ms": train["adj_plain_ms"],
        "bound_ms": train["adj_bound_ms"],
        "bound_by": train["adj_bound_by"],
        "library_ms": None,
        "kernel_ms": train["adj_kernel_ms"],
        "float4_atomics": train["adj_atomics"],
    }]
    _log(f"[kernels] K1 per inference batch of 8 = box + mask + plane pools; kernel "
         f"alone {tot['kernel_ms']:.4f} ms; K2 per training step (box pool of "
         f"{train['rois']} ROIs); kernel alone {train['adj_kernel_ms']:.4f} ms ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


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


def _sweep_cases(preds):
    """(name, kind, mask, normal, offset, p0, dir, hypotheses) at 480x640:
    the door clip's frame-0 seed under both grids; a plane through the
    camera's horizon (rows above it lift behind the camera, rows beside it
    far away); the plane z = 2^-40 moved by -1 x (-0.3, 0, 2^-40 - 2^-63),
    whose points land at z = 2^-63 with px ~ 1e21, beyond int32 and int64."""
    from articulation3d_tpu_torch.temporal import optimizer as topt
    normal, offset, p0, dvec = topt._seed_geometry(preds[0], 0, "rot", 480, 640)
    door = preds[0].masks[0].astype(np.float32)
    band = np.zeros((480, 640), np.float32)
    band[190:230, 160:480] = 1.0
    tilt = np.array([0.0, 1.0, 0.05]) / np.linalg.norm([0.0, 1.0, 0.05])
    d = 2.0 ** -40
    return [
        ("door", "rot", door, normal, offset, p0, dvec, ROT_ANGLES),
        ("door", "trans", door, normal, offset, p0, dvec, TRANS_STEPS),
        ("behind_camera", "rot", band, tilt, 1.0, np.array([0.1, 0.0, 2.0]),
         np.array([0.6, 0.0, 0.8]), ROT_ANGLES),
        ("near_zero_depth", "trans", door, np.array([0.0, 0.0, 1.0]), d, np.zeros(3),
         np.array([-0.3, 0.0, d - 2.0 ** -63]), np.array([-1.0, 0.0, 0.5])),
    ]


def phase_temporal(card, device: str = "cuda") -> None:
    """(a) the door clip's articulation recovered on the card; (b) the
    card's sweeps and IoU product against the CPU's."""
    import random

    import torch

    from articulation3d_tpu_torch.temporal import kernels as tk
    from articulation3d_tpu_torch.temporal import optimizer as topt
    from articulation3d_tpu_torch.temporal import optimize_planes, track_planes
    from articulation3d_tpu_torch.utils.metrics import EA_metric, Line

    preds, hinge = _door_clip()
    random.seed(2020)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks = track_planes(preds)
    opt = optimize_planes(preds, tracks, "3dc", h=480, w=640, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gt = Line([hinge[1], hinge[0], hinge[3], hinge[2]])
    eas = []
    for p in opt:
        seg = topt._decode_axis(p, "rot", 480, 640)[0].astype(np.float64)
        eas.append(EA_metric(Line([seg[1], seg[0], seg[3], seg[2]]), gt, size=(640, 480)))
    _log(f"[temporal] door clip, 30 frames 480x640, random.seed(2020): tracks rot "
         f"{len(tracks['rot'])} trans {len(tracks['trans'])}, has_rot "
         f"{[t['has_rot'] for t in tracks['rot']]}, std_axis "
         f"{tracks['rot'][0].get('std_axis', np.zeros(4)).tolist()}, EA min {min(eas):.4f} "
         f"mean {float(np.mean(eas)):.4f}; track + optimise wall {wall:.4f} s ({card})")
    assert len(tracks["rot"]) == 1 and len(tracks["trans"]) == 0, tracks
    assert len(tracks["rot"][0]["ids"]) == 30
    assert tracks["rot"][0]["has_rot"] is True
    assert all(np.allclose(p.scores, 0.9) for p in opt)
    assert min(eas) > 0.8, eas

    _profile_optimise(preds, device, card)
    masks = torch.from_numpy(np.stack([p.masks[0] for p in preds])).float()
    masks_dev = masks.to(device)
    for name, kind, mask, normal, offset, p0, dvec, hyp in _sweep_cases(preds):
        args = {}
        for dev in ("cpu", device):
            f32 = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            if kind == "rot":
                args[dev] = (tk.rotation_sweep, (f32(mask), f32(normal), f32(offset), f32(p0),
                                                 f32(dvec), f32(hyp)))
            else:
                args[dev] = (tk.translation_sweep, (f32(mask), f32(normal), f32(offset),
                                                    f32(dvec), f32(hyp)))
        run = lambda dev: args[dev][0](*args[dev][1], h=480, w=640)
        t0 = time.perf_counter()
        cpu = run("cpu")
        cpu_s = time.perf_counter() - t0
        card_out = run(device)
        torch.cuda.synchronize()
        diff = int(((card_out.cpu() > 0.5) != (cpu > 0.5)).sum())
        ms = _time_ms(lambda: run(device))
        iou_cpu = tk.iou_matrix(masks, cpu)
        iou_card = tk.iou_matrix(masks_dev, cpu.to(device))
        ierr = float(np.nanmax(np.abs(iou_card.cpu().numpy() - iou_cpu.numpy())))
        nan_same = bool((torch.isnan(iou_card.cpu()) == torch.isnan(iou_cpu)).all())
        iou_ms = _time_ms(lambda: tk.iou_matrix(masks_dev, card_out))
        _log(f"[temporal] {name:16s} {kind:5s} sweep of {len(hyp)} hypotheses at 480x640: "
             f"card vs CPU {diff}/{cpu.numel()} mask pixels differ (tol "
             f"{int(1e-4 * cpu.numel())}); card {ms:.4f} ms, CPU {1e3 * cpu_s:.1f} ms "
             f"(one call); iou_matrix 30x{len(hyp)} card vs CPU max abs err {ierr:.3e} "
             f"(tol 1e-5), NaN pattern equal {nan_same}, card {iou_ms:.4f} ms ({card})")
        assert diff <= 1e-4 * cpu.numel(), (name, diff)
        assert ierr <= 1e-5 and nan_same, (name, ierr)
        if name == "near_zero_depth":
            # saturating-cast semantics: the whole mask lands in column W-1
            hit = torch.nonzero(card_out[0].cpu() > 0.5)
            assert hit.shape[0] == 3 and bool((hit[:, 1] == 639).all()), hit.tolist()


def _profile_optimise(preds, device, card) -> None:
    """The door clip's track + optimise once more under torch.profiler:
    the card's busy share of the stage's wall and its kernels by time."""
    import random

    import torch
    from torch.profiler import ProfilerActivity, profile

    from articulation3d_tpu_torch.temporal import optimize_planes, track_planes
    random.seed(2020)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimize_planes(preds, track_planes(preds), "3dc", h=480, w=640, device=device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, n = _device_time(prof)
    total = sum(by_name.values())
    _log(f"[profile-temporal] door clip track + optimise: wall {wall_us / 1e3:.3f} ms under "
         f"the profiler, device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {n} "
         f"kernels, kernel time {total / 1e3:.3f} ms ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        _log(f"[profile-temporal]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  "
             f"{name[:110]}")


def _shifted_clip(n: int = 32, h: int = 480, w: int = 640):
    """n frames cut from one seeded noise image, each shifted by one pixel,
    so that a detector's boxes persist from frame to frame."""
    base = np.random.RandomState(1).randint(0, 256, (h, w + n, 3)).astype(np.uint8)
    return [np.ascontiguousarray(base[:, t:t + w]) for t in range(n)]


def phase_temporal_pipeline(pipe, frames, card) -> None:
    """(c) the detector at full width on the shifted clip, then track and
    optimise on the card: tracks, has_rot, sweeps per second, walls."""
    import random

    import torch

    from articulation3d_tpu_torch.temporal import optimizer as topt
    from articulation3d_tpu_torch.temporal import optimize_planes, track_planes

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = pipe.run(frames)
    det_wall = time.perf_counter() - t0
    sweeps = [_count_calls(topt, "rotation_sweep"), _count_calls(topt, "translation_sweep")]
    random.seed(2020)
    try:
        t1 = time.perf_counter()
        tracks = track_planes(preds)
        t2 = time.perf_counter()
        opt = optimize_planes(preds, tracks, "3dc", h=pipe.output_height,
                              w=pipe.output_width, device=pipe.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        for c in sweeps:
            c.restore()
    n_rot, n_trans = len(tracks["rot"]), len(tracks["trans"])
    has = sum(bool(t["has_rot"]) for cat in tracks.values() for t in cat)
    n_sweeps = sweeps[0].n + sweeps[1].n
    _log(f"[temporal-pipeline] detector on {len(frames)} shifted {frames[0].shape[0]}x"
         f"{frames[0].shape[1]} frames (batch {pipe.batch_size}, "
         f"conf 0): {det_wall:.4f} s, {np.mean([len(p) for p in preds]):.1f} detections per "
         f"frame; tracks rot {n_rot} trans {n_trans}, has_rot {has}; track {t2 - t1:.4f} s, "
         f"optimise {t3 - t2:.4f} s ({sweeps[0].n} rotation + {sweeps[1].n} translation "
         f"sweeps, {n_sweeps / max(t3 - t2, 1e-9):.1f} sweeps/s); track + optimise "
         f"{t3 - t1:.4f} s ({card})")
    assert n_rot + n_trans > 0, "no detection persisted over 10 frames"
    assert n_sweeps > 0 and len(opt) == len(frames)
    assert all(np.isfinite(p.scores).all() for p in opt)


def phase_artefacts(rac, pipe, frames, card) -> int:
    """The CLI's body with --save-obj on the shifted clip; returns K1's
    launches on this path."""
    import shutil

    from articulation3d_tpu_torch import infer
    from articulation3d_tpu_torch.video import io as vio

    out = os.path.join(ROOT, ".chip_smoke", "cli")
    shutil.rmtree(out, ignore_errors=True)
    handed = []
    write_video = vio.write_video

    def recording(path, frames, **kw):
        handed.append([f.shape for f in frames])
        return write_video(path, frames, **kw)

    vio.write_video = recording
    rac.multilevel_roi_align_cuda.launches = 0
    try:
        t0 = time.perf_counter()
        walls = infer.run_video(pipe, frames, 30.0, out, conf_threshold=0.0, save_obj=True)
        wall = time.perf_counter() - t0
    finally:
        vio.write_video = write_video
    launches = rac.multilevel_roi_align_cuda.launches
    mp4 = os.path.join(out, "output.mp4")
    mp4_bytes = os.path.getsize(mp4) if os.path.exists(mp4) else 0
    sizes = {name: os.path.getsize(os.path.join(out, "frame_0000", name))
             for name in ("arti_pred.obj", "arti_pred.mtl")
             if os.path.exists(os.path.join(out, "frame_0000", name))}
    objs = sorted(d for d in os.listdir(out) if d.startswith("frame_"))
    walls = ", ".join(f"{k} {v:.4f} s" for k, v in walls.items())
    _log(f"[artefacts] infer.run_video, {len(frames)} frames {frames[0].shape[0]}x"
         f"{frames[0].shape[1]}, --save-obj: {wall:.4f} s "
         f"({walls}); K1 launches {launches}; output.mp4 {mp4_bytes} bytes, "
         f"{len(handed[0]) if handed else 0} frames of {handed[0][0] if handed else None} "
         f"handed to write_video; {objs} with frame_0000 {sizes} bytes ({card})")
    assert launches > 0
    h, w = frames[0].shape[:2]
    assert handed and len(handed[0]) == len(frames) and handed[0][0] == (h, 4 * w, 3)
    if mp4_bytes == 0:
        _log("[artefacts] no mp4 encoder in this OpenCV build: output.mp4 not written; "
             "the frames handed to write_video were checked instead")
    assert sizes.get("arti_pred.obj", 0) > 0 and sizes.get("arti_pred.mtl", 0) > 0, sizes
    return launches


def _train_batch(cfg, b: int, g: int = 4):
    """Synthetic batch of `b` images with `g` GT boxes each, in the style of
    tools/train_on_chip.py::_batch (np.random.RandomState(0)); only the
    fields the config's heads read."""
    h, w = cfg.input.height, cfg.input.width
    rs = np.random.RandomState(0)
    bs = max(20, min(h, w) // 5)
    boxes = []
    for _ in range(b * g):
        x1 = rs.uniform(0, w - 2 * bs)
        y1 = rs.uniform(0, h - 2 * bs)
        boxes.append([x1, y1, x1 + rs.uniform(bs, 2 * bs), y1 + rs.uniform(bs, 2 * bs)])
    batch = {
        "images": rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        "gt_boxes": np.asarray(boxes, np.float32).reshape(b, g, 4),
        "gt_classes": rs.randint(0, 2, (b, g)).astype(np.int32),
        "gt_valid": np.ones((b, g), bool),
    }
    assert not (cfg.model.mask_on or cfg.model.plane_on or cfg.model.axis_on
                or cfg.model.depth_on), "stage 1 runs the detector only"
    return batch


def _train_weights(seed: int = 0):
    """`random_state_dict(seed)` with the RPN delta damping of phase 3, and
    the frozen stem conv scaled by 1/256: d2's caffe trunk takes raw 0..255
    pixels (pixel_std 1), so random trunk weights give O(300) features and
    O(300) gradients, and SGD at lr 0.002 diverges within a few steps; the
    stem and res2 are frozen (freeze_at 2), so the scale is a fixed
    normalisation of the input and the features come out O(1)."""
    from articulation3d_tpu_torch.weights import random_state_dict
    sd = random_state_dict(seed)
    for k in ("weight", "bias"):
        sd[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= 0.01
    sd["backbone.bottom_up.stem.conv1.weight"] *= 1.0 / 256.0
    return sd


def _stage1_config(**model_kw):
    from articulation3d_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", "step1_bbox.yaml"))
    out = os.path.join(ROOT, ".chip_smoke", "train")
    return cfg.replace(weights="", output_dir=out,
                       model=dataclasses.replace(cfg.model, **model_kw),
                       solver=dataclasses.replace(cfg.solver, warmup_iters=0,
                                                  base_lr=0.002))


def _record_train_pool(module, store):
    """Wrap the model's training pooler to keep its inputs, the cotangent
    that reaches its output and the gradients it sends to its features
    (in stage 1 the pooler is the features' only reader)."""
    orig = module.multilevel_roi_align_train

    def rec(features, boxes, **kw):
        out = orig(features, boxes, **kw)
        item = {"features": [f.detach() for f in features], "boxes": boxes, "kw": kw,
                "dfeats": [None] * len(features)}
        store.append(item)
        if out.requires_grad:
            out.register_hook(lambda g: item.__setitem__("g", g.detach().clone()))
            for i, f in enumerate(features):
                if f.requires_grad:
                    f.register_hook(lambda d, i=i: item["dfeats"].__setitem__(
                        i, d.detach().clone()))
        return out

    module.multilevel_roi_align_train = rec
    return orig


def phase_training(rac, card) -> dict:
    """Stage 1 at full width through `Trainer`: 2 warm + 20 timed steps on
    one batch of 16; K1/K2 launches per step, loss curve, peak memory, one
    profiled step, then K2 at the path's own box-pool inputs."""
    import torch

    from articulation3d_tpu_torch.models import planercnn as pmod
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import load_d2_state_dict

    cfg = _stage1_config()
    sc = cfg.solver
    batch = _train_batch(cfg, sc.ims_per_batch)
    trainer = Trainer(cfg, [batch])
    load_d2_state_dict(trainer.model, {k: v for k, v in _train_weights().items()
                                       if k in trainer.model.state_dict()})
    _log(f"[train] configs/step1_bbox.yaml as shipped (R50-FPN, dtype {cfg.model.dtype}, "
         f"pooler {cfg.model.roi_pooler_impl}, RPN {cfg.model.rpn.pre_nms_topk_train}/"
         f"{cfg.model.rpn.post_nms_topk_train}, {cfg.model.rpn.batch_size_per_image} anchors "
         f"and {cfg.model.roi_heads.batch_size_per_image} ROIs per image, ims "
         f"{sc.ims_per_batch}, {cfg.input.height}x{cfg.input.width}) except solver "
         f"warmup_iters 0 and base_lr 0.002; weights random_state_dict(0), RPN deltas "
         f"x0.01, frozen stem conv x1/256; one synthetic batch of {sc.ims_per_batch}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rac.multilevel_roi_align_cuda.launches = 0
    rac.multilevel_roi_align_adjoint_cuda.launches = 0
    t0 = time.perf_counter()
    recs = trainer.train(2) + trainer.train(22)
    wall = time.perf_counter() - t0
    k1 = rac.multilevel_roi_align_cuda.launches
    k2 = rac.multilevel_roi_align_adjoint_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    n = len(recs)
    totals = [r["total_loss"] for r in recs]
    timed = recs[2:]
    t_timed = sum(r["wall_s"] for r in timed)
    _log(f"[train] {n} steps in {wall:.3f} s: first step {recs[0]['wall_s']:.4f} s "
         f"(kernel load, cuDNN autotuning), second {recs[1]['wall_s']:.4f} s; 20 timed "
         f"steps {t_timed:.4f} s = {len(timed) / t_timed:.4f} steps/s, "
         f"{sc.ims_per_batch * len(timed) / t_timed:.3f} images/s; per-step walls "
         f"{['%.4f' % r['wall_s'] for r in timed]} ({card})")
    _log(f"[train] max_memory_allocated {peak / 2**30:.3f} GiB; launches per step K1 "
         f"{k1 / n:.2f} K2 {k2 / n:.2f} ({k1}, {k2} over {n} steps)")
    _log(f"[train] total_loss first {totals[0]:.6f} last {totals[-1]:.6f}; curve "
         f"{['%.4f' % t for t in totals]}")
    _log(f"[train] first step losses {dict((k, round(v, 6)) for k, v in recs[0].items())}")
    _log(f"[train] last step losses {dict((k, round(v, 6)) for k, v in recs[-1].items())}")
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert k1 == n and k2 == n, (k1, k2, n)
    assert totals[-1] < totals[0], totals

    _profile_train_step(trainer, card)

    # K2 (and K1) at the training path's own box-pool inputs
    store = []
    orig = _record_train_pool(pmod, store)
    try:
        trainer.train(trainer.iter + 1)
    finally:
        pmod.multilevel_roi_align_train = orig
    (item,) = store
    feats, boxes, kw = item["features"], item["boxes"], item["kw"]
    g = item["g"].reshape(-1, *item["g"].shape[2:]).contiguous()
    valid = kw["valid"]
    p, sr, al = kw["output_size"], kw["sampling_ratio"], kw["aligned"]
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=al)
    args = dict(opts, valid=valid)
    shapes = [f.shape for f in feats]
    bumped, n_rec = _check_record(rac, feats, boxes, valid, p, sr, al)
    pr = rac._prepare(shapes, boxes, **args)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(opts, min_level=2))
    kboxes, _ = rac._kernel_boxes(boxes, None, p)
    # K2 takes the cotangent as the pooler gets it: invalid rows are skipped
    # by their record (nty = 0), as the plain version skips them
    got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **opts)
    want = rac.multilevel_roi_align_adjoint_separable(g, shapes, pr)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    assert err <= 1e-4 * scale, (err, scale)
    adj_ms = _time_ms(lambda: rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record,
                                                                    **opts))
    grads = [torch.zeros_like(d) for d in got]
    adj_kernel_ms = _time_ms(lambda: rac._launch_adj(g, kboxes, record, dict(opts, min_level=2),
                                                     grads))
    adj_plain_ms = _time_ms(lambda: rac.multilevel_roi_align_adjoint_separable(g, shapes, pr),
                            iters=3, warmup=1)
    fwd_ms = _time_ms(lambda: rac.multilevel_roi_align_cuda(feats, boxes, **args))
    fwd_kernel_ms = _time_kernel(rac, feats, boxes, valid, p, sr, al)
    fwd_plain_ms = _time_ms(lambda: rac.multilevel_roi_align_separable(feats, boxes, **args),
                            iters=3, warmup=1)
    fwd_bound, fwd_by = _bound(rac, feats, boxes, valid, p, sr, al)
    bound, by = _adjoint_bound(rac, shapes, pr, g)
    atomics = _adjoint_atomics(rac, pr, g.shape[-1])
    rmw_ms = atomics * 16 * 2 / HBM_BYTES_PER_S * 1e3
    rois = boxes.shape[0] * boxes.shape[1]
    _log(f"[timing] training box pool, {rois} ROIs ({int(valid.sum())} sampled), "
         f"float32 features: K2 wrapper {adj_ms:.4f} ms (kernel alone "
         f"{adj_kernel_ms:.4f} ms, zero fill and checks {adj_ms - adj_kernel_ms:.4f} ms), "
         f"plain {adj_plain_ms:.4f} ms, bound {bound:.4f} ms by {by}, kernel/bound "
         f"{adj_kernel_ms / bound:.2f}x; {atomics} float4 atomic adds, whose read and "
         f"write of 16 B each would take {rmw_ms:.4f} ms at 3.35 TB/s ({rmw_ms / bound:.2f}x "
         f"the bound); max_abs_err {err:.3e} (max|plain| {scale:.3e}); "
         f"K1 wrapper {fwd_ms:.4f} ms (kernel alone {fwd_kernel_ms:.4f} ms), plain "
         f"{fwd_plain_ms:.4f} ms, bound {fwd_bound:.4f} ms by {fwd_by}, wrapper/bound "
         f"{fwd_ms / fwd_bound:.2f}x; record == _prepare on {n_rec} ROIs ({bumped} bumped) "
         f"({card})")
    return dict(k1=k1, k2=k2, rois=rois, adj_err=err, adj_ms=adj_ms,
                adj_kernel_ms=adj_kernel_ms, adj_plain_ms=adj_plain_ms,
                adj_bound_ms=bound, adj_bound_by=by, adj_atomics=atomics, batch=batch,
                k1_train=dict(ms=fwd_ms, kernel_ms=fwd_kernel_ms, plain_ms=fwd_plain_ms,
                              bound_ms=fwd_bound, bound_by=fwd_by))


def _adjoint_bound(rac, shapes, pr, g):
    """Least time on an H100 SXM for one K2 call: g's rows of the valid
    ROIs read once and each float32 cell of the four (B, H_l, W_l, C)
    level gradients written once, over 3.35 TB/s (a kernel that gathers
    per output cell needs no more; the zero fill and the atomics'
    read-modify-write are costs of this design, not of the function); and
    the multiply-adds over the support at the fp32 rate.  Returns
    (ms, "bytes" | "operations")."""
    ry, rx = rac._predicated_weights(pr)
    ry_nz, rx_nz = (ry != 0).cpu().numpy(), (rx != 0).cpu().numpy()
    nty = pr["nty"].cpu().numpy()
    p, c = int(g.shape[-2]), int(g.shape[-1])
    sup = lambda nz: sum(int(np.ptp(np.nonzero(row)[0])) + 1 for row in nz if row.any())
    flops = sum(2 * c * sup(ry_nz[r]) * sup(rx_nz[r]) for r in np.nonzero(nty > 0)[0])
    out = sum(int(np.prod(s[:3])) for s in shapes) * c * 4
    nbytes = int((nty > 0).sum()) * p * p * c * 4 + out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _adjoint_atomics(rac, pr, c: int) -> int:
    """The float4 atomic adds one K2 call issues: per valid ROI, the window
    rows and columns that some output row's (column's) support holds,
    times C / 4."""
    import torch
    ry, rx = rac._predicated_weights(pr)

    def covered(w):                     # (T, P, span) -> (T,) cells covered
        nz = w != 0
        span = w.shape[-1]
        idx = torch.arange(span, device=w.device)
        has = nz.any(-1)
        lo = torch.where(has, nz.float().argmax(-1), torch.full_like(has, span, dtype=torch.long))
        hi = torch.where(has, span - 1 - nz.flip(-1).float().argmax(-1),
                         torch.full_like(has, -1, dtype=torch.long))
        return ((idx >= lo[..., None]) & (idx <= hi[..., None])).any(1).sum(-1)

    valid = pr["nty"] > 0
    return int((covered(ry) * covered(rx))[valid].sum()) * (c // 4)


def _profile_train_step(trainer, card) -> None:
    """One warm training step under torch.profiler: device-busy share,
    top kernels by device time and K2's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(trainer.iter + 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, n = _device_time(prof)
    total = sum(by_name.values())
    adj = sum(v for k, v in by_name.items() if "roi_align_adj" in k)
    fwd = sum(v for k, v in by_name.items() if "roi_align_fwd" in k)
    _log(f"[profile-train] one warm step of {trainer.cfg.solver.ims_per_batch} images: wall "
         f"{wall_us / 1e3:.3f} ms under the profiler, device busy {busy / 1e3:.3f} ms "
         f"({100 * busy / wall_us:.1f}%), {n} kernels, kernel time {total / 1e3:.3f} ms; "
         f"K2 {adj / 1e3:.3f} ms ({100 * adj / max(total, 1e-9):.2f}%), K1 {fwd / 1e3:.3f} ms "
         f"({100 * fwd / max(total, 1e-9):.2f}%) ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[profile-train]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  "
             f"{name[:110]}")


def _device_time(prof):
    """(busy us, {kernel name: us}, kernel count) of a profile's CUDA events."""
    import torch
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, by_name, len(spans)


def phase_training_parity(rac, train) -> None:
    """One float32 step from the same weights and generator seed with the
    kernel pooler ("cuda": K1 forward, K2 backward) and with the gather
    pooler under autograd ("torch"): no sampled ROI may come from a bumped
    level; losses within 1e-4 relative; the p2 convs' gradients (which
    also carry the RPN's) within 1e-3 x max|grad|.  Then the pooler alone:
    on the kernel run's own features, boxes and cotangent, K3's gradients
    to p2..p5 (K2) against the gather's autograd within 1e-4 x max|grad|
    per level (the K2 parity tolerance).  The two runs' own pooler
    gradients are printed beside their cotangents, not held to a
    tolerance: the L1 box loss has a kink, so a float32 difference in the
    forward can flip the sign of a foreground ROI's cotangent."""
    import torch

    from articulation3d_tpu_torch.models import planercnn as pmod
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from articulation3d_tpu_torch.train.optimizer import freeze_mask
    from articulation3d_tpu_torch.train.train_step import compute_losses, to_device
    from articulation3d_tpu_torch.weights import load_d2_state_dict

    cfg = _stage1_config(dtype="float32")
    model = PlaneRCNN(cfg)
    load_d2_state_dict(model, {k: v for k, v in _train_weights().items()
                               if k in model.state_dict()})
    model = model.cuda().train()
    freeze_mask(model, cfg.model.freeze)
    batch = to_device(train["batch"], "cuda")
    names = ("backbone.fpn_output2.weight", "backbone.fpn_lateral2.weight")
    res = {}
    for impl in ("cuda", "torch"):
        model.config = cfg.replace(model=dataclasses.replace(cfg.model, roi_pooler_impl=impl))
        model.zero_grad(set_to_none=True)
        store = []
        orig = _record_train_pool(pmod, store)
        rac.multilevel_roi_align_cuda.launches = 0
        rac.multilevel_roi_align_adjoint_cuda.launches = 0
        try:
            gen = torch.Generator(device="cuda").manual_seed(7)
            losses = compute_losses(model, batch, gen)
            sum(losses.values()).backward()
        finally:
            pmod.multilevel_roi_align_train = orig
        torch.cuda.synchronize()
        boxes, valid = store[0]["boxes"], store[0]["kw"]["valid"]
        flat = boxes.reshape(-1, 4)[valid.reshape(-1)]
        bumped = int((rac.pallas_level_idx(flat, n_levels=4, strides=STRIDES, output_size=7,
                                           sampling_ratio=0, aligned=True)
                      != rac.assign_boxes_to_levels(flat) - 2).sum())
        grads = {n: dict(model.named_parameters())[n].grad.detach().clone() for n in names}
        assert all(d is not None for d in store[0]["dfeats"]) and "g" in store[0], impl
        res[impl] = ({k: float(v.detach()) for k, v in losses.items()}, grads, boxes, store[0])
        _log(f"[train-parity] {impl} pooler, float32, {batch['images'].shape[0]} images: "
             f"K1 launches {rac.multilevel_roi_align_cuda.launches}, K2 launches "
             f"{rac.multilevel_roi_align_adjoint_cuda.launches}; sampled ROIs pooled from a "
             f"bumped level: {bumped}/{flat.shape[0]}; losses "
             f"{dict((k, round(v, 6)) for k, v in res[impl][0].items())}")
        assert bumped == 0, bumped
    (la, ga, ba, ia), (lb, gb, bb, ib) = res["cuda"], res["torch"]
    assert bool((ba == bb).all()), "the two runs sampled different ROIs"
    lerr = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12) for k in lb)
    gerr = {n: float((ga[n] - gb[n]).abs().max()) / float(gb[n].abs().max()) for n in names}
    _log(f"[train-parity] losses max rel err {lerr:.3e} (tol 1e-4); p2 conv gradients max "
         f"abs err / max|grad| {dict((n, float('%.3e' % v)) for n, v in gerr.items())} "
         f"(tol 1e-3)")
    assert lerr <= 1e-4, lerr
    assert all(v <= 1e-3 for v in gerr.values()), gerr

    rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    dg = (ia["g"] - ib["g"]).abs().flatten(2).amax(-1)             # per ROI
    _log(f"[train-parity] the two runs' cotangents at the pooler: max abs err / max|g| "
         f"{rel(ia['g'], ib['g']):.3e}, ROIs whose rows differ by more than 1e-4 x max|g|: "
         f"{int((dg > 1e-4 * float(ib['g'].abs().max())).sum())}/{dg.numel()}; their "
         f"pooler gradients, max abs err / max|grad| per level "
         f"{['%.3e' % rel(a, b) for a, b in zip(ia['dfeats'], ib['dfeats'])]}")
    # the pooler alone, on one set of features, boxes and cotangent
    vjp = {}
    for impl in ("cuda", "torch"):
        fs = [f.clone().requires_grad_(True) for f in ia["features"]]
        out = rac.multilevel_roi_align_train(fs, ia["boxes"], **dict(ia["kw"], impl=impl))
        vjp[impl] = torch.autograd.grad(out, fs, grad_outputs=ia["g"])
    torch.cuda.synchronize()
    perr = [rel(a, b) for a, b in zip(vjp["cuda"], vjp["torch"])]
    scale = [float(b.abs().max()) for b in vjp["torch"]]
    _log(f"[train-parity] pooler alone, one cotangent: K3 (K2) against the gather's autograd, "
         f"max abs err / max|grad| per level p2..p5 {['%.3e' % e for e in perr]} (tol 1e-4; "
         f"max|grad| {['%.3e' % v for v in scale]})")
    assert all(e <= 1e-4 for e in perr), perr
    assert scale[0] > 0, scale


def _profile_step(pipe, frames, card) -> None:
    """One warm device step under torch.profiler: device time by kernel
    name (top 12) and the device's busy share of the step's wall time.
    The profiler slows the host, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = torch.from_numpy(np.stack(frames)).cuda()
    pipe.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, n = _device_time(prof)
    total = sum(by_name.values())
    _log(f"[profile] one warm step of 8 frames: wall {wall_us / 1e3:.3f} ms under the "
         f"profiler, device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
         f"{n} kernels, kernel time {total / 1e3:.3f} ms ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[profile]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  {name[:110]}")


class _count_calls:
    """Counts the calls of `module.name` until `restore()`."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0
        self.orig = getattr(module, name)

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        setattr(module, name, counted)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def _time_kernel(rac, feats, boxes, valid, p, sr, aligned) -> float:
    """K1 alone (`_launch` into preallocated outputs), CUDA events, ms."""
    import torch
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned,
                min_level=2)
    boxes, valid = rac._kernel_boxes(boxes, valid, p)
    total = boxes.shape[0] * boxes.shape[1]
    out = torch.empty((total, p, p, feats[0].shape[-1]), dtype=torch.float32, device="cuda")
    record = torch.empty((total, 5), dtype=torch.int32, device="cuda")
    return _time_ms(lambda: rac._launch(feats, boxes, valid, opts, record, out))


def _main_path_err(rac, captured) -> float:
    """Max abs difference of kernel and plain version on the main path's
    own pool inputs, held to the phase-2 tolerances."""
    import torch
    err = 0.0
    for roi_feats, boxes, kw in captured:
        args = dict(strides=STRIDES, output_size=kw["resolution"],
                    sampling_ratio=kw["sampling_ratio"], aligned=kw["aligned"],
                    valid=kw["valid"])
        got = rac.multilevel_roi_align_cuda(roi_feats, boxes, **args)
        want = rac.multilevel_roi_align_separable(roi_feats, boxes, **args)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = 1e-5 if roi_feats[0].dtype == torch.float32 else 1e-2
        assert e <= tol * float(want.abs().max()), e
        err = max(err, e)
    return err


if __name__ == "__main__":
    sys.exit(main())
