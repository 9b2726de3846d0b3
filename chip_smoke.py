#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`articulation3d_tpu_torch`) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure is an exception and a
non-zero exit):

  1. device and build: the card's name and power limit, and the build of
     the ROIAlign kernel (csrc/roi_align_fwd.cu) with its ptxas report;
  2. the kernel against its plain torch version on the card, on a 480x640
     pyramid (C = 256, B = 2) for the box (N = 1000, 7x7, V2, ratio 0),
     mask (N = 100, 14x14, V1, ratio 2) and plane (N = 100, 14x14, V1,
     ratio 0) pools, in float32 and bfloat16, with invalid rows, plus the
     5:1 and bumped-level 9:1 box sets;
  3. the main path: `VideoPipeline` at full width (R50-FPN, 1000
     proposals, 100 detections, mask/plane/axis/depth heads, the shipped
     configs/config.yaml with seeded random weights and score threshold 0)
     on 16 synthetic 480x640 frames in two chunks of 8, with the kernel's
     launch count, per-chunk wall times and peak memory; then the kernel's
     time at the main path's own pool inputs beside its plain version and
     its bound;
  4. the kernel path against the plain gather path, whole model, float32;
  5. a JSON line of kernel measurements, then the device JSON as the last
     line.

Exits non-zero without a result when there is no CUDA device or the
package is not beside this script.  TF32 is off for every phase.
"""

from __future__ import annotations

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
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            zero_ok = valid is None or bool((got[~valid] == 0).all())
            _log(f"[kernel-parity] {name:22s} {str(dtype)[6:]:8s} P={p:2d} sr={sr} "
                 f"aligned={int(aligned)} rois={boxes.shape[0] * boxes.shape[1]:5d} "
                 f"max_abs_err={err:.3e} max|out|={scale:.3e} tol={tol * scale:.3e} "
                 f"invalid_rows_zero={zero_ok}")
            assert np.isfinite(err) and err <= tol * scale, (name, dtype, err)
            assert zero_ok, (name, dtype)


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
    import dataclasses

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
    lib = rac.build_kernel(verbose=True)
    _log(f"[build] {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f}s")

    # 2. kernel vs plain version -----------------------------------------
    phase_kernel_parity(rac)

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
    rac.multilevel_roi_align_cuda.launches = 0
    preds = pipe.run(frames, verbose=True)
    launches = rac.multilevel_roi_align_cuda.launches
    _log(f"[main] model dtype {cfg.model.dtype}, pooler {cfg.model.roi_pooler_impl}, "
         f"batch 8, 16 frames 480x640; kernel launches {launches}; "
         f"valid ROIs per pool stage {pipe.pool_valid}")
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
    for (roi_feats, boxes, kw), stage in zip(captured, ("box", "mask", "plane")):
        p, sr, al = kw["resolution"], kw["sampling_ratio"], kw["aligned"]
        valid = kw["valid"]
        args = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=al,
                    valid=valid)
        ms = _time_ms(lambda: rac.multilevel_roi_align_cuda(roi_feats, boxes, **args))
        plain = _time_ms(lambda: rac.multilevel_roi_align_separable(roi_feats, boxes, **args),
                         iters=3, warmup=1)
        pr = rac._prepare([f.shape for f in roi_feats], boxes, **args)
        out = torch.empty((boxes.shape[0] * boxes.shape[1], p, p, roi_feats[0].shape[-1]),
                          dtype=torch.float32, device="cuda")
        kern = _time_ms(lambda: rac._launch(roi_feats, pr, out, p))
        bound, by = _bound(rac, roi_feats, boxes, valid, p, sr, al)
        bound_by.add(by)
        _log(f"[timing] {stage:5s} pool P={p:2d} rois={boxes.shape[0] * boxes.shape[1]} "
             f"valid={int(valid.sum())} {str(roi_feats[0].dtype)[6:]}: wrapper {ms:.4f} ms "
             f"(kernel alone {kern:.4f} ms, prologue {ms - kern:.4f} ms), plain "
             f"{plain:.4f} ms, bound {bound:.4f} ms by {by} ({card})")
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

    # 5. results ---------------------------------------------------------
    max_err = _main_path_err(rac, captured)
    kernels = [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "articulation3d_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "articulation3d_tpu/ops/roi_align_pallas.py:184",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": None,
    }]
    _log(f"[kernels] per batch of 8 = box + mask + plane pools; kernel alone "
         f"{tot['kernel_ms']:.4f} ms ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


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
    total = sum(by_name.values())
    _log(f"[profile] one warm step of 8 frames: wall {wall_us / 1e3:.3f} ms under the "
         f"profiler, device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
         f"{len(spans)} kernels, kernel time {total / 1e3:.3f} ms ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[profile]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  {name[:110]}")


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
