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
  9. the recipe from a dataset on disk, into `.chip_smoke/datasets` and
     `.chip_smoke/recipe`: (a) a synthetic 480x640 dataset in the schema of
     tools/generate_arti.py (48 train, 16 val, 16 test records, a quarter
     of them negative, u16 depth, two 32-frame val clips), registered under
     the arti_* and scannet_* names; (b) stage 1 through `train_net.main` on
     configs/step1_bbox.yaml from the loader (ims 16, 2 warm + 20 timed
     steps, phase 5's damped weights as the `weights` file): steps/s beside
     phase 5's, the mapper alone over one epoch, the busy share of one warm
     step, peak memory, K1/K2 per step and a falling loss; (c)
     `--eval-only --resume` on arti_val with score threshold 0: the
     ArtiEvaluator dict (finite, NaN only where no GT is in the range), the
     walls of inference, RLE and the evaluator, the model back in train
     mode; (d) stage 3 on configs/step3_plane.yaml warm-started from (b)'s
     checkpoint (ims 8, 2 + 10 steps, packed masks and u16 depth, no K2),
     then the ScannetEvaluator; (e) the evaluators' known answers: the val
     GT as predictions gives bbox and bbox+axis AP 1.0 per class and AUROC
     1.0, axes turned by 90 degrees bbox+axis AP 0, GT planes plane AP 1.0;
     (f) `opt_arti` with conf 0 in two SLURM shards over the val clips, then
     `--load-results`;
 10. a JSON line of kernel measurements, then the device JSON as the last
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

    # 9. the recipe from a dataset on disk -----------------------------------
    recipe = phase_recipe(rac, card, train)

    # 10. results --------------------------------------------------------
    max_err = max(_main_path_err(rac, captured), recipe["err"])
    kernels = [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "articulation3d_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "articulation3d_tpu/ops/roi_align_pallas.py:184",
        "launches": k1_inference + train["k1"] + k1_cli + recipe["k1"],
        "launches_by_path": {"inference": k1_inference, "training": train["k1"],
                             "cli": k1_cli, "recipe": recipe["k1"]},
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
        "launches": train["k2"] + recipe["k2"],
        "launches_by_path": {"inference": 0, "training": train["k2"], "cli": 0,
                             "recipe": recipe["k2"]},
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

    busy = _profile_train_step(trainer, card)

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
    return dict(k1=k1, k2=k2, rois=rois, adj_err=err, adj_ms=adj_ms, busy=busy,
                steps_per_s=len(timed) / t_timed,
                images_per_s=sc.ims_per_batch * len(timed) / t_timed,
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


def _profile_train_step(trainer, card, tag: str = "profile-train") -> float:
    """One warm training step under torch.profiler: device-busy share,
    top kernels by device time and K2's share.  Returns the busy share."""
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
    _log(f"[{tag}] one warm step of {trainer.cfg.solver.ims_per_batch} images: wall "
         f"{wall_us / 1e3:.3f} ms under the profiler, device busy {busy / 1e3:.3f} ms "
         f"({100 * busy / wall_us:.1f}%), {n} kernels, kernel time {total / 1e3:.3f} ms; "
         f"K2 {adj / 1e3:.3f} ms ({100 * adj / max(total, 1e-9):.2f}%), K1 {fwd / 1e3:.3f} ms "
         f"({100 * fwd / max(total, 1e-9):.2f}%) ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[{tag}]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  "
             f"{name[:110]}")
    return busy / wall_us


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


class _record_pools:
    """Keeps the inputs of the first `n` calls of `PlaneRCNN._pool`, on
    every model, until `restore()`: the pool inputs of a path that builds
    its own model (`train_net`, `Trainer.test`)."""

    def __init__(self, n: int):
        from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
        self.cls, self.orig, self.calls = PlaneRCNN, PlaneRCNN._pool, []

        def rec(model, roi_feats, boxes, **kw):
            if len(self.calls) < n:
                self.calls.append(([f.detach() for f in roi_feats], boxes.detach(), kw))
            return self.orig(model, roi_feats, boxes, **kw)

        PlaneRCNN._pool = rec

    def restore(self):
        self.cls._pool = self.orig


def _main_path_err(rac, captured, tag: str = "main-path") -> float:
    """Max abs difference of kernel and plain version on a path's own pool
    inputs (`PlaneRCNN._pool`'s arguments), held to the phase-2 tolerances:
    1e-5 x max|plain| for float32 maps, 1e-2 x for bfloat16.  A training
    pool goes through `multilevel_roi_align_train` (K1 inside the
    autograd Function), an inference pool through the K1 wrapper."""
    import torch
    err, line = 0.0, []
    for roi_feats, boxes, kw in captured:
        args = dict(strides=STRIDES, output_size=kw["resolution"],
                    sampling_ratio=kw["sampling_ratio"], aligned=kw["aligned"],
                    valid=kw["valid"])
        with torch.no_grad():
            if kw.get("training"):
                got = rac.multilevel_roi_align_train(roi_feats, boxes, impl="cuda", **args)
            else:
                got = rac.multilevel_roi_align_cuda(roi_feats, boxes, **args)
            want = rac.multilevel_roi_align_separable(roi_feats, boxes, **args)
        if boxes.is_cuda:
            torch.cuda.synchronize()
        e, scale = float((got - want).abs().max()), float(want.abs().max())
        tol = 1e-5 if roi_feats[0].dtype == torch.float32 else 1e-2
        line.append(f"{'train' if kw.get('training') else 'infer'} P={kw['resolution']} "
                    f"{tuple(boxes.shape[:2])} {str(roi_feats[0].dtype)[6:]} err {e:.3e} "
                    f"(tol {tol * scale:.3e})")
        assert e <= tol * scale, (e, tol * scale)
        err = max(err, e)
    _log(f"[{tag}] K1 against the plain version on the path's own pool inputs: "
         f"{'; '.join(line)}")
    return err


# --------------------------------------------------------------------------- #
# 9. the recipe: data path, stage 1 and 3 from the loader, evaluators, opt_arti
# --------------------------------------------------------------------------- #

# split -> (positive videos, records per positive video, negative videos,
# records per negative video)
RECIPE_SPLITS = {"train": (5, 8, 1, 8), "val": (2, 6, 1, 4), "test": (2, 6, 1, 4)}
PLANE_KEY = "plane_ap@iou0.5normal30.0offset0.3"


def _write_recipe_dataset(root: str, h: int = 480, w: int = 640, clip_frames: int = 32,
                          seed: int = 0) -> dict:
    """A synthetic dataset in the schema `tools/generate_arti.py` emits
    (XYXY boxes, `bbox_mode` 0, contiguous `category_id` 0/1, integer
    `image_id`, negative records with no annotations), under `root`:
    `articulation/cached_set_{train,val,test}.json` and the same train and
    val records as `scannet/cached_set_{train,val}.json`, frames in `arti/`,
    u16 millimetre depth in `arti_depth/`.

    Each video is a seeded noise scene (as `tools/make_soak_dataset.py`
    draws it) `clip_frames` pixels wider than a frame, with 1-3 bright
    rectangles, each with a dark axis line; frame t is the scene shifted t
    pixels, named `{youtube11}_001_5_{t}.png`.  Annotations carry a polygon,
    a unit normal, a plane and a rot or tran axis that misses the box
    centre.  The val split's positive videos are also written whole as
    `clips/{video_id}.mp4`.  Returns {split: records}."""
    import cv2

    from articulation3d_tpu_torch.video.io import write_video

    for d in ("arti", "arti_depth", "articulation", "scannet", "clips"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rs = np.random.RandomState(seed)
    ramp = (1500 + np.arange(h)[:, None] * 4 + np.arange(w)[None, :] % 128).astype(np.uint16)
    cw = (w - clip_frames) // 3                       # one object per column
    out = {}
    for split, (n_pos, per_pos, n_neg, per_neg) in RECIPE_SPLITS.items():
        records = []
        for v in range(n_pos + n_neg):
            yt = (split.upper() + "XXXXX")[:5] + f"{v:06d}"
            positive = v < n_pos
            base = rs.randint(0, 90, (h, w + clip_frames, 3)).astype(np.uint8)
            stripes = (np.arange(h)[:, None] // 16 % 2) * 25
            base = np.clip(base + stripes[..., None], 0, 255).astype(np.uint8)
            objects = []
            for j in range(rs.randint(1, 4) if positive else 0):
                bw, bh = rs.uniform(0.35, 0.85) * cw, rs.uniform(0.15, 0.4) * h
                x1 = clip_frames + j * cw + rs.uniform(0, cw - bw)
                y1 = rs.uniform(0.05 * h, 0.95 * h - bh)
                x2, y2 = x1 + bw, y1 + bh
                cat = (v + j) % 2
                axis = ([x1 + 0.15 * bw, y1, x1 + 0.15 * bw, y2] if cat == 0
                        else [x1, y1 + 0.7 * bh, x2, y1 + 0.7 * bh])
                color = tuple(int(c) for c in rs.randint(180, 255, 3))
                cv2.rectangle(base, (int(x1), int(y1)), (int(x2), int(y2)), color, -1)
                cv2.line(base, (int(axis[0]), int(axis[1])), (int(axis[2]), int(axis[3])),
                         (30, 30, 30), 3)
                normal = rs.randn(3) * [0.3, 0.3, 0.0] + [0.0, 0.0, 1.0]
                normal = (normal / np.linalg.norm(normal)).tolist()
                objects.append((x1, y1, x2, y2, cat, axis, normal,
                                (np.asarray(normal) * rs.uniform(1.0, 4.0)).tolist()))
            frames = [np.ascontiguousarray(base[:, t:t + w]) for t in range(clip_frames)]
            offsets = (np.linspace(0, clip_frames - 1, per_pos).round().astype(int)
                       if positive else np.arange(per_neg))
            for t in offsets:
                stem = f"{yt}_001_5_{t}"
                path = os.path.join(root, "arti", stem + ".png")
                depth = os.path.join(root, "arti_depth", stem + ".png")
                cv2.imwrite(path, frames[t])
                cv2.imwrite(depth, ramp + np.uint16(10 * (len(records) % 50)))
                annos = []
                for x1, y1, x2, y2, cat, axis, normal, plane in objects:
                    bx = [x1 - t, y1, x2 - t, y2]
                    ax = [axis[0] - t, axis[1], axis[2] - t, axis[3]]
                    annos.append({"bbox": bx, "bbox_mode": 0, "category_id": cat,
                                  "segmentation": [[bx[0], bx[1], bx[2], bx[1], bx[2], bx[3],
                                                    bx[0], bx[3]]],
                                  "rot_axis": ax if cat == 0 else None,
                                  "tran_axis": ax if cat == 1 else None,
                                  "normal": normal, "plane": plane})
                records.append({"file_name": path, "image_id": len(records), "height": h,
                                "width": w, "depth_path": depth, "annotations": annos})
            if split == "val" and positive:
                write_video(os.path.join(root, "clips", f"{yt}_1_5.mp4"), frames, fps=30.0)
        for sub, names in (("articulation", ["arti_rot", "arti_tran"]),
                           ("scannet", ["plane", "plane2"])):
            if sub == "scannet" and split == "test":
                continue
            with open(os.path.join(root, sub, f"cached_set_{split}.json"), "w") as f:
                json.dump({"info": {"description": f"synthetic {split} set"},
                           "categories": [{"id": i, "name": n} for i, n in enumerate(names)],
                           "data": records}, f)
        out[split] = records
    return out


def _known_answer_predictions(records, rotate_axes: bool = False) -> list:
    """The GT of `records` as predictions: score 1, exact XYWH boxes, RLE
    masks of the polygons, the GT axes encoded about the box centres (their
    line normals turned by 90 degrees with `rotate_axes`), and planes whose
    normals the evaluator's ScanNet -> SunCG swap maps onto the GT normals.
    Negative records predict nothing."""
    from articulation3d_tpu_torch.data.axis_codec import axis_to_angle_offset
    from articulation3d_tpu_torch.data.mapper import polygons_to_bitmask
    from articulation3d_tpu_torch.utils.rle import rle_encode
    preds = []
    for rec in records:
        inst, rot, tran, planes = [], [], [], []
        for a in rec["annotations"]:
            x1, y1, x2, y2 = a["bbox"]
            mask = polygons_to_bitmask(a["segmentation"], rec["height"], rec["width"])
            inst.append({"image_id": rec["image_id"], "category_id": a["category_id"],
                         "bbox": [x1, y1, x2 - x1, y2 - y1], "score": 1.0,
                         "segmentation": rle_encode(mask)})
            axis = a["rot_axis"] if a["rot_axis"] is not None else a["tran_axis"]
            enc = axis_to_angle_offset(np.asarray([axis], np.float64),
                                       np.asarray([[(x1 + x2) / 2, (y1 + y2) / 2]]))[0]
            enc = enc.astype(np.float64)
            if rotate_axes:
                enc[0], enc[1] = enc[1], -enc[0]
            rot.append(enc[:3])
            tran.append(enc[:2])
            n = a["normal"]
            planes.append([n[0], n[2], n[1]])
        preds.append({"image_id": rec["image_id"], "file_name": rec["file_name"],
                      "instances": inst, "pred_rot_axis": np.asarray(rot).reshape(-1, 3),
                      "pred_tran_axis": np.asarray(tran).reshape(-1, 2),
                      "pred_plane": np.asarray(planes).reshape(-1, 3)})
    return preds


def _check_eval_values(results, dataset_name: str) -> list:
    """Every value finite, or NaN where the COCO protocol gives NaN: an
    area range or a category without GT in the dataset.  Returns the NaN
    keys."""
    import math

    from articulation3d_tpu_torch.data.catalog import get_dataset_dicts, get_metadata
    from articulation3d_tpu_torch.evaluation import convert_to_coco_dict
    from articulation3d_tpu_torch.evaluation.coco_eval import AREA_RANGES
    anns = convert_to_coco_dict(get_dataset_dicts(dataset_name),
                                get_metadata(dataset_name))["annotations"]
    names = {c: n for c, n in zip(get_metadata(dataset_name).thing_dataset_id_to_contiguous_id,
                                  get_metadata(dataset_name).thing_classes)}
    by_range = {"APs": "small", "APm": "medium", "APl": "large"}
    nan = []
    for k, v in results.items():
        v = float(v)
        if math.isfinite(v):
            continue
        assert math.isnan(v), (k, v)
        metric = k.split("/", 1)[-1]
        if metric in by_range:
            lo, hi = AREA_RANGES[by_range[metric]]
            assert not any(lo <= a["area"] < hi for a in anns), (k, "has GT in its range")
        elif metric.startswith("AP-"):
            assert not any(names[a["category_id"]] == metric[3:] for a in anns), (k, "has GT")
        else:
            raise AssertionError(f"{k} is NaN")
        nan.append(k)
    return nan


def _recipe_argv(stage: str, out: str, weights: str, ckpt_period: int, *flags) -> list:
    """`train_net`'s command line for one stage of the recipe: the shipped
    config with (b)'s overrides, the flags before the overrides."""
    return ["--config-file", os.path.join(ROOT, "configs", f"{stage}.yaml"), *flags,
            "weights", weights, "output_dir", out, "solver.warmup_iters", "0",
            "solver.base_lr", "0.002", "test.eval_period", "0",
            "solver.checkpoint_period", str(ckpt_period), "model.roi_pooler_impl", "cuda",
            "model.roi_heads.score_thresh_test", "0.0"]


def _train_rates(recs, ims: int, warm: int = 2):
    """(steps/s, images/s, steps/s of the step alone, mean batch wait s)
    over the records after `warm`; a step's wall is its wait for the batch
    plus the step."""
    timed = recs[warm:]
    wall = sum(r["data_s"] + r["wall_s"] for r in timed)
    step = sum(r["wall_s"] for r in timed)
    return (len(timed) / wall, ims * len(timed) / wall, len(timed) / step,
            float(np.mean([r["data_s"] for r in timed])))


def phase_recipe(rac, card, phase5) -> dict:
    """(a) the dataset; (b) stage 1 through `train_net` from the loader;
    (c) `--eval-only --resume` on arti_val; (d) stage 3 from (b)'s
    checkpoint, then ScannetEvaluator; (e) the evaluators' known answers;
    (f) `opt_arti` in two shards, then merged.  Returns K1's and K2's
    launches over (b)-(f)."""
    import shutil

    import torch

    from articulation3d_tpu_torch import opt_arti, train_net
    from articulation3d_tpu_torch.config import load_config
    from articulation3d_tpu_torch.data.catalog import get_dataset_dicts, register_builtin_datasets
    import cv2

    from articulation3d_tpu_torch.data.mapper import (DetectionLoader, PlaneRCNNMapper,
                                                      read_image_bgr)
    from articulation3d_tpu_torch.evaluation import ArtiEvaluator, ScannetEvaluator
    from articulation3d_tpu_torch.train.checkpoint import latest_checkpoint

    data_root = os.path.join(ROOT, ".chip_smoke", "datasets")
    out = os.path.join(ROOT, ".chip_smoke", "recipe")
    for d in (data_root, out):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(out)
    launches = {"k1": 0, "k2": 0}

    def count(fn):
        rac.multilevel_roi_align_cuda.launches = 0
        rac.multilevel_roi_align_adjoint_cuda.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        k1 = rac.multilevel_roi_align_cuda.launches
        k2 = rac.multilevel_roi_align_adjoint_cuda.launches
        launches["k1"] += k1
        launches["k2"] += k2
        return res, k1, k2, time.perf_counter() - t0

    # (a) the dataset
    t0 = time.perf_counter()
    splits = _write_recipe_dataset(data_root)
    register_builtin_datasets(data_root)
    n = {s: (len(r), sum(1 for x in r if not x["annotations"]),
             sum(len(x["annotations"]) for x in r)) for s, r in splits.items()}
    _log(f"[recipe] dataset under .chip_smoke/datasets in {time.perf_counter() - t0:.2f} s: "
         f"(records, negatives, objects) per split {n}; 480x640 frames, u16 mm depth, "
         f"2 val clips of 32 frames")

    # (b) stage 1 from the loader, through train_net
    init = os.path.join(out, "init_weights.pth")
    heads = ("roi_heads.mask_head.", "roi_heads.plane_head.", "roi_heads.axis_head.",
             "depth_head.")
    torch.save({k: v for k, v in _train_weights().items() if not k.startswith(heads)}, init)
    out1 = os.path.join(out, "stage1")
    torch.cuda.reset_peak_memory_stats()
    (trainer, recs), k1, k2, wall = count(lambda: train_net.main(
        _recipe_argv("step1_bbox", out1, init, 22, "--max-iter", "22")))
    peak = torch.cuda.max_memory_allocated()
    cfg1 = trainer.cfg
    ims = cfg1.solver.ims_per_batch
    sps, ips, step_sps, wait = _train_rates(recs, ims)
    totals = [r["total_loss"] for r in recs]
    _log(f"[recipe-stage1] train_net on configs/step1_bbox.yaml (ims {ims}, RPN "
         f"{cfg1.model.rpn.pre_nms_topk_train}/{cfg1.model.rpn.post_nms_topk_train}, "
         f"{cfg1.model.roi_heads.batch_size_per_image} ROIs per image, pooler "
         f"{cfg1.model.roi_pooler_impl}) from arti_train ({len(splits['train'])} records) "
         f"through PrefetchLoader, weights = random_state_dict(0) with the phase-5 damping: "
         f"{len(recs)} steps in {wall:.3f} s; 20 timed steps {sps:.4f} steps/s, {ips:.3f} "
         f"images/s (the step alone {step_sps:.4f} steps/s, mean wait for a batch "
         f"{1e3 * wait:.2f} ms) against phase 5's synthetic batch {phase5['steps_per_s']:.4f} "
         f"steps/s, {phase5['images_per_s']:.3f} images/s ({card})")
    _log(f"[recipe-stage1] launches per step K1 {k1 / len(recs):.2f} K2 {k2 / len(recs):.2f}; "
         f"max_memory_allocated {peak / 2**30:.3f} GiB; total_loss first {totals[0]:.6f} last "
         f"{totals[-1]:.6f}; curve {['%.4f' % t for t in totals]}")
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert k1 == len(recs) == 22 and k2 == len(recs), (k1, k2)
    assert np.mean(totals[-3:]) < np.mean(totals[:3]), totals
    ckpt1 = latest_checkpoint(out1)
    assert ckpt1 and ckpt1.endswith("model_0000021.pth"), ckpt1
    busy = _profile_train_step(trainer, card, tag="profile-recipe")
    trainer._batches.close()            # its prefetch thread stops: the mapper runs alone
    for name, cfg in (("stage 1", cfg1), ("stage 3", load_config(
            os.path.join(ROOT, "configs", "step3_plane.yaml")))):
        records = get_dataset_dicts(cfg.datasets_train[0])
        loader = DetectionLoader(records, PlaneRCNNMapper(cfg, is_train=True),
                                 cfg.solver.ims_per_batch, shuffle=True, seed=cfg.seed)
        t0 = time.perf_counter()
        batches = list(loader.epoch(0))
        dt = time.perf_counter() - t0
        n_img = sum(len(b["image_id"]) for b in batches)
        t0 = time.perf_counter()
        for r in records:
            read_image_bgr(r["file_name"], r["height"], r["width"])
        t_read = (time.perf_counter() - t0) / len(records)
        t0 = time.perf_counter()
        for r in records:
            cv2.imread(r["depth_path"], cv2.IMREAD_UNCHANGED)
        t_depth = (time.perf_counter() - t0) / len(records)
        _log(f"[recipe-mapper] {name} mapper alone, one epoch of {cfg.datasets_train[0]} "
             f"({n_img} images in {len(batches)} batches of {cfg.solver.ims_per_batch}, one "
             f"thread): {dt:.4f} s = {n_img / dt:.2f} images/s, {1e3 * dt / n_img:.2f} ms per "
             f"image; of that the frame's imread + resize {1e3 * t_read:.2f} ms (a u16 depth "
             f"PNG's imread {1e3 * t_depth:.2f} ms); batch keys "
             f"{sorted(k for k, v in batches[0].items() if isinstance(v, np.ndarray))} ({card})")
    del trainer
    torch.cuda.empty_cache()

    # (c) --eval-only --resume on arti_val, every detection kept
    pools = _record_pools(3)
    try:
        (trainer, results), k1c, _, wall = count(lambda: train_net.main(
            _recipe_argv("step1_bbox", out1, init, 22, "--eval-only", "--resume")))
    finally:
        pools.restore()
    captured = pools.calls
    res = results["arti_val"]
    walls = trainer.test_walls["arti_val"]
    nan = _check_eval_values(res, "arti_val")
    _log(f"[recipe-eval] --eval-only --resume at iteration {trainer.iter} on arti_val (batch "
         f"{max(ims, 1)}, score_thresh_test 0): {wall:.3f} s = mapper {walls['mapper']:.4f} s + "
         f"inference {walls['inference']:.4f} s + RLE of the masks {walls['rle']:.4f} s + "
         f"evaluator {walls['evaluator']:.4f} s (rest: build and resume); K1 launches {k1c}; "
         f"NaN (no GT in the range or category) {nan} ({card})")
    _log(f"[recipe-eval] ArtiEvaluator {json.dumps({k: float(v) for k, v in res.items()})}")
    assert trainer.iter == 22 and trainer.model.training
    assert {"bbox/AP", "segm/AP", "auroc", "bbox - arti_rot", "bbox+axis - arti_tran"} <= set(res)
    preds_pth = os.path.join(out1, "instances_predictions.pth")
    dumped = torch.load(preds_pth, weights_only=False)
    assert len(dumped) == len(splits["val"])
    assert all(len(p["instances"]) == 100 for p in dumped), [len(p["instances"]) for p in dumped]
    del trainer
    torch.cuda.empty_cache()

    # (d) stage 3, warm-started from (b)'s checkpoint, then ScannetEvaluator
    out3 = os.path.join(out, "stage3")
    torch.cuda.reset_peak_memory_stats()
    pools = _record_pools(3)                        # the first step's three pools
    try:
        (trainer, recs3), k1d, k2d, wall = count(lambda: train_net.main(
            _recipe_argv("step3_plane", out3, ckpt1, 12, "--max-iter", "12")))
    finally:
        pools.restore()
    captured += pools.calls
    peak = torch.cuda.max_memory_allocated()
    cfg3 = trainer.cfg
    sps3, ips3, step3, wait3 = _train_rates(recs3, cfg3.solver.ims_per_batch)
    batch = next(trainer.loader.loader.epoch(0))
    _log(f"[recipe-stage3] train_net on configs/step3_plane.yaml (ims "
         f"{cfg3.solver.ims_per_batch}, frozen {list(cfg3.model.freeze)}) from scannet_train, "
         f"weights = the stage-1 checkpoint {os.path.relpath(ckpt1, ROOT)}: {len(recs3)} steps in "
         f"{wall:.3f} s; 10 timed steps {sps3:.4f} steps/s, {ips3:.3f} images/s (the step alone "
         f"{step3:.4f} steps/s, mean wait {1e3 * wait3:.2f} ms); launches per step K1 "
         f"{k1d / len(recs3):.2f} K2 {k2d / len(recs3):.2f}; max_memory_allocated "
         f"{peak / 2**30:.3f} GiB; batch {batch['gt_masks_packed'].dtype} gt_masks_packed "
         f"{batch['gt_masks_packed'].shape}, {batch['gt_depth_mm'].dtype} gt_depth_mm "
         f"{batch['gt_depth_mm'].shape}; losses first {dict((k, round(v, 4)) for k, v in recs3[0].items())} "
         f"last total {recs3[-1]['total_loss']:.4f} ({card})")
    assert all(np.isfinite(v) for r in recs3 for v in r.values()), recs3
    assert batch["gt_masks_packed"].dtype == np.uint8 and batch["gt_depth_mm"].dtype == np.uint16
    assert {"loss_mask", "loss_plane", "depth_loss"} <= set(recs3[0]), set(recs3[0])
    assert k1d > 0 and k2d == 0, (k1d, k2d)
    pools = _record_pools(3)                        # the first batch's three pools
    try:
        results3, k1e, _, wall = count(trainer.test)
    finally:
        pools.restore()
    captured += pools.calls
    res3 = results3["scannet_val"]
    walls = trainer.test_walls["scannet_val"]
    _log(f"[recipe-eval3] test() on scannet_val (batch {cfg3.solver.ims_per_batch}, "
         f"score_thresh_test 0, depth override of 100 masks per image): {wall:.3f} s = mapper "
         f"{walls['mapper']:.4f} s + inference {walls['inference']:.4f} s + RLE "
         f"{walls['rle']:.4f} s + evaluator {walls['evaluator']:.4f} s; K1 launches {k1e} "
         f"({card})")
    _log(f"[recipe-eval3] ScannetEvaluator {json.dumps({k: float(v) for k, v in res3.items()})}")
    assert trainer.model.training and PLANE_KEY in res3 and "depth_l1_dist" in res3
    assert all(np.isfinite(float(v)) for v in res3.values()), res3
    ckpt3 = latest_checkpoint(out3)
    del trainer
    err = _main_path_err(rac, captured, tag="recipe-pools")
    assert any(kw.get("training") for _, _, kw in captured), "no stage-3 training pool"
    del captured
    torch.cuda.empty_cache()

    # (e) the evaluators' known answers
    t0 = time.perf_counter()
    val = get_dataset_dicts("arti_val")
    known = {}
    for rotate in (False, True):
        ev = ArtiEvaluator("arti_val", output_dir=os.path.join(out, "known"))
        ev._predictions = _known_answer_predictions(val, rotate_axes=rotate)
        known[rotate] = ev.evaluate()
    sev = ScannetEvaluator("scannet_val")
    scan_val = get_dataset_dicts("scannet_val")
    for rec, p in zip(scan_val, _known_answer_predictions(scan_val)):
        sev.process([{"image_id": rec["image_id"], "file_name": rec["file_name"]}],
                    [{"instances": p["instances"],
                      "pred_plane": [a["plane"] for a in rec["annotations"]]}])
    scan = sev.evaluate()
    cats = ("arti_rot", "arti_tran")
    pick = lambda r, m: {c: r[f"{m} - {c}"] for c in cats}
    _log(f"[recipe-known] GT as predictions on arti_val: bbox {pick(known[False], 'bbox')}, "
         f"bbox+axis {pick(known[False], 'bbox+axis')}, bbox+normal "
         f"{pick(known[False], 'bbox+normal')}, auroc {known[False]['auroc']}, bbox/AP "
         f"{known[False]['bbox/AP']}; axes turned 90 deg: bbox+axis "
         f"{pick(known[True], 'bbox+axis')}; ScannetEvaluator, GT planes, no depth: "
         f"{PLANE_KEY} {scan[PLANE_KEY]}, box {scan['box_ap@0.5']}, mask {scan['mask_ap@0.5']} "
         f"({time.perf_counter() - t0:.3f} s)")
    for c in cats:
        assert known[False][f"bbox - {c}"] == 1.0 and known[False][f"bbox+axis - {c}"] == 1.0
        assert known[True][f"bbox+axis - {c}"] == 0.0
    assert known[False]["auroc"] == 1.0 and scan[PLANE_KEY] == 1.0

    # (f) opt_arti on the two val clips, two shards, then the merge
    import yaml
    with open(os.path.join(ROOT, "configs", "config.yaml")) as f:
        opt_cfg = yaml.safe_load(f)
    opt_cfg["weights"] = ckpt3
    opt_cfg["model"]["roi_heads"] = {"score_thresh_test": 0.0}
    opt_cfg["model"]["roi_pooler_impl"] = "cuda"
    cfg_path = os.path.join(out, "opt_arti.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(opt_cfg, f)
    opt_out = os.path.join(out, "opt_arti")
    argv = ["--config", cfg_path, "--input", preds_pth, "--output", opt_out,
            "--dataset", "arti_val", "--video-root", os.path.join(data_root, "clips"),
            "--conf-threshold", "0"]
    env = {k: os.environ.get(k) for k in ("SLURM_ARRAY_TASK_ID", "SLURM_ARRAY_TASK_MAX")}
    shard_walls, k1f = [], 0
    try:
        os.environ["SLURM_ARRAY_TASK_MAX"] = "1"
        for task in ("0", "1"):
            os.environ["SLURM_ARRAY_TASK_ID"] = task
            r, k1s, _, wall = count(lambda: opt_arti.main(argv))
            assert r is None
            shard_walls.append(wall)
            k1f += k1s
        del os.environ["SLURM_ARRAY_TASK_ID"]
        merged, _, _, merge_wall = count(lambda: opt_arti.main(argv + ["--load-results"]))
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shards = sorted(n for n in os.listdir(opt_out) if n.startswith("predictions_"))
    n_pred = sum(len(torch.load(os.path.join(opt_out, s), weights_only=False)["predictions"])
                 for s in shards)
    nan = _check_eval_values(merged, "arti_val")
    _log(f"[recipe-opt_arti] 2 shards over 3 val videos (2 clips of 32 frames at 480x640, one "
         f"negative video without a clip): walls {['%.3f' % w for w in shard_walls]} s, merge "
         f"{merge_wall:.3f} s; K1 launches {k1f}; {shards} with {n_pred} predictions; NaN "
         f"{nan} ({card})")
    _log(f"[recipe-opt_arti] merged ArtiEvaluator {json.dumps({k: float(v) for k, v in merged.items()})}")
    assert shards == ["predictions_0000.pth", "predictions_0001.pth"], shards
    assert n_pred == 2 * RECIPE_SPLITS["val"][1] and k1f >= 2 * 4 * 3, (n_pred, k1f)
    assert {"bbox - arti_rot", "auroc"} <= set(merged)
    return dict(k1=launches["k1"], k2=launches["k2"], busy=busy, err=err)


if __name__ == "__main__":
    sys.exit(main())
