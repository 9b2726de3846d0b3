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
     ratio 0) pools, with invalid rows, plus the 5:1 and 9:1 box sets and
     the 1000 proposals of the reference oracle's 480x640 fixture
     (tests/fixtures/golden_oracle_biased_480x640.npz, mostly slivers) at
     all three pools: K1 in float32 and bfloat16, with the record (level,
     y0, x0, ny, nx) its fused prologue writes held integer-exactly against
     torch `_prepare` and `_roi_record` on the card and every level
     detectron2's (fault F2: no ROI leaves it); K2 in float32 from that
     record, with the transpose identity <K1(F), G> = <F, K2(G)> summed in
     float64; then "[oracle-rois]": K1's and K2's times on those proposals
     at a batch of 8 beside their plain versions and bounds; then "[f1]":
     both kernels, uncapped (the default since the repair of fault F1), on
     ROIs whose bins take more than 4 samples (p2 slivers up to 23, the
     120x360 door at p3 with 7), the record exact; and both kernels at
     JAX's cap of 4 (their runtime cap) against the capped plain versions
     and record;
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
     kernel run's own features, boxes and cotangent; then the same with the
     RPN deltas undamped, whose proposals are slivers, some of which the
     JAX Pallas kernel pools from a coarser level (`_pallas_moved`);
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
     on this path, and the walls of its stages; then "[export-extra]": the
     rest of export and vis on that pipeline's detections of frames 0-1 (at
     most 10 each, into `.chip_smoke/export_extra/`): RLE-input plane
     meshes, world transforms, camera and axis primitives, the .ply/.obj
     writers, the webview tilt, `render_img` (render_0.png), the normal
     sphere, the affinity heatmap, match and box drawing, the labelled
     overlays, with the wall of each;
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
 10. "[refine-serve]": `VideoPipeline` on configs/config.yaml with
     `model.refine_on true` (480x640, batch 8, score threshold 0, 16
     frames, 100 instances per image through the refine U-Net at 192x256):
     frames/s, the refine pass's share of a warm step, peak memory, the
     same with cuDNN TF32 on, and the kernel route against the plain route
     (the refined masks' foreground IoU, planes' max error);
 11. "[refine-train]": `Trainer` on configs/step3_plane.yaml with
     `model.refine_on true` at ims 4 (cut from 8), 2 + 10 steps on one
     synthetic batch: steps/s, peak memory, K1/K2 per step, a falling
     `refine_loss`, and K1 against its plain version on the first step's
     five pools, the cascade's two no-grad pools among them
     ("[refine-train-pools]");
 12. "[drpn]": configs/config.yaml with `model.rpn.head_convs 5`: one
     serving batch, K1 against its plain version on its three pools
     ("[drpn-pools]"), then proposals and detections of the kernel route
     against the plain route;
 13. "[ddp-1]": an NCCL process group of one and phase 5's stage-1 step
     (ims 16) wrapped in DistributedDataParallel against the unwrapped step
     from the same state (losses, parameters, steps/s) and K1 and K2 of the
     wrapped step against their plain versions ("[ddp-pools]");
 14. "[ddp-2]": two processes (`chip_smoke.py --ddp-rank R 2 STORE OUT`)
     on the one card over gloo, each with 8 of a float32 global batch of
     16: two stage-1 steps of the `Trainer`'s own step (`sharded_train_step`,
     JAX's `make_sharded_train_step`) against this process's emulation of
     it (the mean of the two halves' gradients, each half with its own
     normalisers), and the steps/s of 10 more; two steps of the
     global-batch step (`train_step`) against this process at 16; one
     step with `solver.grad_sync_dtype: bfloat16` whose synced buckets are
     bit-equal to ((g0/2).bfloat16() + (g1/2).bfloat16()).bfloat16().float()
     of the ranks' own buckets and differ from the float32 sync, and the
     steps/s of 10 more; `Trainer.test` with both evaluators distributed
     over phase 9's arti_val and scannet_val, and `VideoPipeline` over a
     32-frame val clip, against this process; with more than one card,
     `--only ddp-cards` runs the same (without the bfloat16 step) with one
     process per card over NCCL ("[ddp-cards]", never in a whole run);
 15. "[remat]": phase 5's cell with `resnet.remat` off and on from the
     same state, as alternating pairs (off, on, off, on): peak memory,
     steps/s, the losses and parameters of remat against off beside the
     two off runs' own spread; K1 and K2 of a remat step against their
     plain versions ("[remat-pools]");
 16. "[goldens]": a fixture the port's `save_goldens` writes from its probe
     on the CPU (configs/config.yaml's model at full width, 480x640, phase
     3's weights, float32, 200 proposals, 20 detections), then the
     `compare_goldens` CLI on the card with the gather pooler and the
     kernel; then the reference oracle's fixtures
     (tests/fixtures/golden_oracle_biased_{480x640,128x160}.npz, with the
     port's build of their biased weights from seed 0,
     `bias_for_detections(random_state_dict(0))`) through both routes on
     the card at the gates of tests/test_torch_goldens.py; then where the
     card's float32 model departs from the CPU's on the 480x640 fixture
     (FPN features per level within 1e-5 of their largest value, proposal
     and detection box differences, with cuDNN's default algorithms,
     deterministic ones and cuDNN off);
 17. "[serving-preset]": the deployment preset `serving_config()` (500
     post-NMS proposals, 30 detections per image, score threshold 0) beside
     phase 3's parity cell, same weights, `VideoPipeline` at batch 8, as
     alternating pairs (parity, preset, parity, preset), each turn 25
     chunks of 8 noise frames: frames/s over its 24 warm chunks, the
     spread of their walls, peak memory, K1 launches; K1 at the preset's own pool
     inputs (box 500 ROIs per image, mask and plane 30) and parity's, its
     record against `_prepare`, against its plain version, and its times
     beside the plain version and the bound; then the preset's equivalence
     contract on the card: RPN survivors and regime per frame, the preset's
     detections matched to parity's at bench.py's on-chip gates (every one
     in a frame of at most 500 survivors, at least 90 % above), the depth
     maps equal, once on the cell and once at 100 proposals per level
     before NMS, where every frame fits under 500;
 18. "[profile-stages]": the port's stage profilers on the card through
     their CLIs' `main()`, with no `--device` (two warm runs, then the
     mean wall of 5 runs, 3 for training, each ending in a host
     readback): `profile_inference` at batch 8 at both presets,
     `profile_depth` at batch 8, `profile_train` at stage 1 with ims 16
     and at stage 3 with ims 8; each CLI prints its table under the card's
     name and power limit.  A hook around each row (`_StageProbe`) prints
     K1's and K2's calls per run (their wrappers' counters over the timed
     runs) and one more run under torch.profiler (kernel launches, device
     busy time, K1's and K2's device time), holds K1 against its plain
     version on that run's pool inputs, and the training pool's kernel
     rows against its gather rows (forward and gradients); it fails if a
     row has no time, if a kernel row does not call K1 (the inference
     kernel rows, "train pool ... (kernel)", the loss and step rows) or K2
     ("train pool fwd+bwd (kernel)", stage 1's backward rows), if a gather
     row calls either, or if a kernel disagrees;
 19. a JSON line of kernel measurements, then the device JSON as the last
     line.

`python3 chip_smoke.py --only parity,oracle-rois,f1,train-parity,refine-serve,
refine-train,drpn,ddp-1,ddp-2,remat,ddp-cards,export-extra,goldens,serving-preset,
profile-stages` builds the kernels and runs just the named phases of 2, 6, 8 and
10-18 (any subset; "parity" is
phase 2's kernel and adjoint parity, "train-parity" phase 6 on phase 5's
batch; "ddp-2" writes phase 9's dataset if it is missing); it is
for iterating on those phases, makes no kernel line, and its last line,
`{"partial": true, "phases": [...], ...}`, has no "ok" key: it is never
the result of a whole run.

Exits non-zero without a result when there is no CUDA device or the
package is not beside this script.  TF32 is off for every phase but one
timing of phase 10, which states it.
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
PRESET_CHUNKS = 25             # chunks of 8 frames per timed turn of "[serving-preset]"
POOLS = {"box": (7, 0, True), "mask": (14, 2, False), "plane": (14, 0, False)}


def _log(*a):
    print(*a, flush=True)


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


def _oracle_proposals() -> np.ndarray:
    """(1000, 4): the reference oracle's proposals on its 480x640 fixture,
    most of them slivers (random-weight RPN deltas)."""
    path = os.path.join(ROOT, "tests", "fixtures", "golden_oracle_biased_480x640.npz")
    return np.load(path)["proposal_boxes"].astype(np.float32)


def _adversarial_boxes():
    """bench.py's aspect5 (5:1) and aspect9 sets; the wide 9:1 box is one
    that the JAX Pallas kernel pools from p3 instead of p2."""
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
    return {"aspect5": adv, "aspect9": nine}


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
        oracle = torch.from_numpy(_oracle_proposals()[None]).cuda()
        for name, (p, sr, aligned) in POOLS.items():
            cases.append((f"oracle_{name}", [f[:1].contiguous() for f in feats2], oracle,
                          None, p, sr, aligned))
        for name, feats, boxes, valid, p, sr, aligned in cases:
            kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr,
                      aligned=aligned, valid=valid)
            got = rac.multilevel_roi_align_cuda(feats, boxes, **kw)
            want = rac.multilevel_roi_align_separable(feats, boxes, **kw)
            n_rec, cells = _check_record(rac, feats, boxes, valid, p, sr, aligned)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            zero_ok = valid is None or bool((got[~valid] == 0).all())
            _log(f"[kernel-parity] {name:22s} {str(dtype)[6:]:8s} P={p:2d} sr={sr} "
                 f"aligned={int(aligned)} rois={boxes.shape[0] * boxes.shape[1]:5d} "
                 f"max_abs_err={err:.3e} max|out|={scale:.3e} tol={tol * scale:.3e} "
                 f"invalid_rows_zero={zero_ok}; record == _prepare == _roi_record on "
                 f"{n_rec} ROIs, each on its detectron2 level; {cells}")
            assert np.isfinite(err) and err <= tol * scale, (name, dtype, err)
            assert zero_ok, (name, dtype)


def _check_record(rac, feats, boxes, valid, p, sr, aligned):
    """K1's record (its fused prologue, on the card) against torch
    `_prepare` and `_roi_record` on the card, integer-exactly, and every
    level detectron2's; returns (ROIs checked, a note of the largest cell
    blocks)."""
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
    off = int((record[:, 0].long() != base).sum())
    assert off == 0, off
    ny, nx = record[:, 3].long(), record[:, 4].long()
    on = ny > 0
    note = (f"cells per valid ROI up to {int((ny * nx)[on].max()) if bool(on.any()) else 0} "
            f"(ny up to {int(ny.max())}, nx up to {int(nx[on].max()) if bool(on.any()) else 0}), "
            f"{int(_pallas_moved(boxes, valid, p, sr, aligned).sum())} valid ROIs that the JAX "
            f"Pallas kernel pools from a coarser level")
    return int(record.shape[0]), note


def _pallas_moved(boxes, valid, p, sr, aligned):
    """(T,) bool: the valid ROIs that the JAX Pallas kernel pools from a
    level coarser than detectron2's: a copy of its rule (`pallas_level_idx`,
    articulation3d_tpu/ops/roi_align_pallas.py:120-171) on the port's own
    sample placement.  With the JAX package's cap of 4 samples, an ROI
    moves when the cells its samples need at its level (rows from
    floor(first) - 1, clamped at 0, to floor(last) + 1; columns the same
    from an origin floored to a multiple of 8) exceed 64 rows or 80
    columns, unless its level is the top one (p5)."""
    import torch

    from articulation3d_tpu_torch.ops.roi_align import _sample_coords, assign_boxes_to_levels
    flat = boxes.reshape(-1, 4).float()
    lv = assign_boxes_to_levels(flat) - 2
    scale = torch.tensor([1.0 / s for s in STRIDES], dtype=torch.float32,
                         device=flat.device)[lv]
    ys, xs, ym, xm = _sample_coords(flat, scale, p, sr, aligned, adaptive_cap=4)
    lo = lambda c, m: torch.where(m > 0, c, torch.full_like(c, 1e9)).amin((1, 2))
    hi = lambda c, m: torch.where(m > 0, c, torch.full_like(c, -1e9)).amax((1, 2))
    need_y = torch.floor(hi(ys, ym)) + 2 - (torch.floor(lo(ys, ym)) - 1).clamp(min=0)
    x0 = torch.floor((torch.floor(lo(xs, xm)) - 1).clamp(min=0) / 8) * 8
    need_x = torch.floor(hi(xs, xm)) + 2 - x0
    moved = ((need_y > 64) | (need_x > 80)) & (lv < len(STRIDES) - 1)
    if valid is not None:
        moved &= valid.reshape(-1).bool()
    return moved


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
    oracle = torch.from_numpy(_oracle_proposals()[None]).cuda()
    for name, (p, sr, aligned) in POOLS.items():
        cases.append((f"oracle_{name}", [f[:1].contiguous() for f in feats2], oracle, None,
                      p, sr, aligned))
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


def phase_oracle_rois(rac, card) -> dict:
    """"[oracle-rois]": K1 (bfloat16 maps, as served) and K2 (float32) on
    the oracle's 1000 proposals, repeated over a batch of 8 (8000 ROIs,
    the serving box pool's count) at each pool's options: the kernel alone
    beside its plain version and its bound, and the cells per ROI beside
    the damped serving proposals'.  Returns {pool: times}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    feats32 = _pyramid(gen, 8, torch.float32)
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    shapes = [f.shape for f in feats32]
    boxes = torch.from_numpy(np.repeat(_oracle_proposals()[None], 8, axis=0)).cuda()
    out = {}
    for pool, (p, sr, al) in POOLS.items():
        opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=al)
        n_rec, cells = _check_record(rac, feats16, boxes, None, p, sr, al)
        kern = _time_kernel(rac, feats16, boxes, None, p, sr, al)
        plain = _time_ms(lambda: rac.multilevel_roi_align_separable(feats16, boxes, **opts),
                         iters=3, warmup=1)
        bound, by = _bound(rac, feats16, boxes, None, p, sr, al)
        fwd, record = rac._forward_kernel(feats32, boxes, None, dict(opts, min_level=2))
        g = torch.randn(fwd.shape, generator=gen, device="cuda")
        kboxes, _ = rac._kernel_boxes(boxes, None, p)
        grads = [torch.zeros(s, device="cuda") for s in shapes]
        adj = _time_ms(lambda: rac._launch_adj(g, kboxes, record, dict(opts, min_level=2),
                                               grads))
        pr = rac._prepare(shapes, boxes, **opts)
        adj_plain = _time_ms(lambda: rac.multilevel_roi_align_adjoint_separable(g, shapes, pr),
                             iters=3, warmup=1)
        adj_bound, adj_by = _adjoint_bound(rac, shapes, pr, g)
        _log(f"[oracle-rois] {pool:5s} P={p:2d} rois={n_rec}: K1 bf16 kernel alone "
             f"{kern:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms by {by} "
             f"({kern / bound:.2f}x); K2 float32 kernel alone {adj:.4f} ms, plain "
             f"{adj_plain:.4f} ms, bound {adj_bound:.4f} ms by {adj_by} "
             f"({adj / adj_bound:.2f}x); {cells} ({card})")
        out[pool] = dict(kernel_ms=kern, plain_ms=plain, bound_ms=bound, adj_kernel_ms=adj,
                         adj_plain_ms=adj_plain, adj_bound_ms=adj_bound)
    return out


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
    lv, b, y0, x0 = (pr[k].long().cpu().numpy() for k in ("levels", "batch_ids", "y0", "x0"))
    ry_nz, rx_nz = (pr["ry"] != 0).cpu().numpy(), (pr["rx"] != 0).cpu().numpy()  # (T, P, n)
    c = features[0].shape[-1]
    grids = [np.zeros(f.shape[:3], bool) for f in features]
    flops = 0
    for r in np.nonzero(pr["ny"].cpu().numpy() > 0)[0]:
        ys = np.nonzero(ry_nz[r].any(0))[0]
        xs = np.nonzero(rx_nz[r].any(0))[0]
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
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    from articulation3d_tpu_torch.profiling import device_label
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_label(torch.device("cuda", 0))
    kind = torch.cuda.get_device_name(0)

    # 1. device and build -------------------------------------------------
    _log(f"[device] {card}")
    _log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = rac.build_kernels(verbose=True)
    _log(f"[build] {[os.path.relpath(v, ROOT) for v in libs.values()]} in "
         f"{time.perf_counter() - t0:.1f}s")

    only = _only_phases()
    if only:
        for name in only:
            PHASES[name](rac, card)
        print(json.dumps({"partial": True, "phases": only, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 2. kernels vs plain versions ---------------------------------------
    phase_kernel_parity(rac)
    phase_adjoint_parity(rac)
    oracle_rois = phase_oracle_rois(rac, card)
    f1 = phase_f1(rac)

    # 3. main path -------------------------------------------------------
    cfg = _parity_config()
    sd = _serving_weights(cfg)
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
        n_rec, cells = _check_record(rac, roi_feats, boxes, valid, p, sr, al)
        ms = _time_ms(lambda: rac.multilevel_roi_align_cuda(roi_feats, boxes, **args))
        kern = _time_kernel(rac, roi_feats, boxes, valid, p, sr, al)
        plain = _time_ms(lambda: rac.multilevel_roi_align_separable(roi_feats, boxes, **args),
                         iters=3, warmup=1)
        kern4 = _time_kernel(rac, roi_feats, boxes, valid, p, sr, al, adaptive_cap=4)
        over4 = _over_four(rac, boxes, valid, p, sr, al)
        bound, by = _bound(rac, roi_feats, boxes, valid, p, sr, al)
        bound_by.add(by)
        _log(f"[timing] {stage:5s} pool P={p:2d} rois={boxes.shape[0] * boxes.shape[1]} "
             f"valid={int(valid.sum())} {str(roi_feats[0].dtype)[6:]}: wrapper {ms:.4f} ms "
             f"(kernel alone {kern:.4f} ms, wrapper's own {ms - kern:.4f} ms), plain "
             f"{plain:.4f} ms, bound {bound:.4f} ms by {by}; wrapper/bound "
             f"{ms / bound:.2f}x, kernel/bound {kern / bound:.2f}x; record == _prepare on "
             f"{n_rec} ROIs; {cells}; {over4}; kernel alone with JAX's cap of 4 "
             f"{kern4:.4f} ms ({card})")
        per_pool[stage] = dict(ms=ms, kernel_ms=kern, plain_ms=plain, bound_ms=bound,
                               kernel_ms_cap4=kern4)
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
        _log(f"[path-parity] {impl} pooler: kernel launches "
             f"{rac.multilevel_roi_align_cuda.launches}")
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
    phase_export_extra(pipe, clip, card)
    del model, pipe
    torch.cuda.empty_cache()

    # 9. the recipe from a dataset on disk -----------------------------------
    recipe = phase_recipe(rac, card, train)

    # 10-12. the refine head (serving, training) and the DRPN head ----------
    rserve = phase_refine_serve(rac, card)
    rtrain = phase_refine_train(rac, card)
    drpn = phase_drpn(rac, card)

    # 13-14. data parallelism: DDP over NCCL at one rank, two ranks over gloo
    ddp1 = phase_ddp1(rac, card, train)
    ddp2 = phase_ranks(card, 2, "ddp-2")

    # 15. resnet.remat off and on, phase 5's cell ------------------------------
    remat = phase_remat(rac, card, train)

    # 16. the goldens harness: a CPU-written fixture, the CLI on the card ----
    phase_goldens(rac, card)

    # 17. the deployment preset beside the parity caps ---------------------
    preset = phase_serving_preset(rac, card)

    # 18. the stage profilers ----------------------------------------------
    stages = phase_profile_stages(rac, card)

    # 19. results --------------------------------------------------------
    max_err = max(_main_path_err(rac, captured), recipe["err"], f1["k1"], rtrain["err"],
                  drpn["err"], ddp1["err1"], remat["err1"], preset["err"], stages["err1"])
    k1_new = {"refine_serve": rserve["k1"], "refine_train": rtrain["k1"], "drpn": drpn["k1"],
              "ddp": ddp1["k1"], "ddp2": ddp2["k1"], "remat": remat["k1"],
              "serving_preset": preset["k1"], "serving_preset_parity": preset["k1_parity"],
              "profile_stages": stages["k1"]}
    kernels = [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "articulation3d_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "articulation3d_tpu/ops/roi_align_pallas.py:184",
        "launches": k1_inference + train["k1"] + k1_cli + recipe["k1"] + sum(k1_new.values()),
        "launches_by_path": {"inference": k1_inference, "training": train["k1"],
                             "cli": k1_cli, "recipe": recipe["k1"], **k1_new},
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
        # "[serving-preset]": the preset's pools and parity's, in one call
        "serving_preset_pools": {k: {m: v[m] for m in ("ms", "kernel_ms", "plain_ms",
                                                       "bound_ms", "rois")}
                                 for k, v in preset["pools"].items()},
        # the oracle's 1000 proposals (mostly slivers) over a batch of 8
        "oracle_proposals": {k: {m: v[m] for m in ("kernel_ms", "plain_ms", "bound_ms")}
                             for k, v in oracle_rois.items()},
        "record_exact": True,
    }, {
        "name": "roi_align_adj",
        "route": "cuda",
        "source": "articulation3d_tpu_torch/csrc/roi_align_adj.cu",
        "replaces": "articulation3d_tpu/ops/roi_align_pallas.py:519",
        "launches": (train["k2"] + recipe["k2"] + rtrain["k2"] + ddp1["k2"] + ddp2["k2"]
                     + remat["k2"] + stages["k2"]),
        "launches_by_path": {"inference": 0, "training": train["k2"], "cli": 0,
                             "recipe": recipe["k2"], "refine_serve": 0,
                             "refine_train": rtrain["k2"], "drpn": 0, "ddp": ddp1["k2"],
                             "ddp2": ddp2["k2"], "remat": remat["k2"], "serving_preset": 0,
                             "profile_stages": stages["k2"]},
        "max_abs_err": max(train["adj_err"], f1["k2"], ddp1["err2"], remat["err2"],
                           stages["err2"]),
        "ms": train["adj_ms"],
        "plain_ms": train["adj_plain_ms"],
        "bound_ms": train["adj_bound_ms"],
        "bound_by": train["adj_bound_by"],
        "library_ms": None,
        "kernel_ms": train["adj_kernel_ms"],
        "float4_atomics": train["adj_atomics"],
        "oracle_proposals": {k: {m: v["adj_" + m] for m in ("kernel_ms", "plain_ms", "bound_ms")}
                             for k, v in oracle_rois.items()},
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
    """`profile_train.train_batch` (the synthetic batch of
    tools/train_on_chip.py::_batch, np.random.RandomState(0)) with only
    the fields the detector reads."""
    from articulation3d_tpu_torch.profile_train import train_batch
    assert not (cfg.model.mask_on or cfg.model.plane_on or cfg.model.axis_on
                or cfg.model.depth_on), "stage 1 runs the detector only"
    batch = train_batch(cfg, b, g)
    return {k: batch[k] for k in ("images", "gt_boxes", "gt_classes", "gt_valid")}


def _train_weights(seed: int = 0, rpn_delta_scale: float = 0.01):
    """`random_state_dict(seed)` with the RPN anchor-delta weights scaled by
    `rpn_delta_scale` (phase 3's damping of 0.01 by default), and the
    frozen stem conv scaled by 1/256: d2's caffe trunk takes raw 0..255
    pixels (pixel_std 1), so random trunk weights give O(300) features and
    O(300) gradients, and SGD at lr 0.002 diverges within a few steps; the
    stem and res2 are frozen (freeze_at 2), so the scale is a fixed
    normalisation of the input and the features come out O(1).  With the
    features at that scale, undamped deltas (scale 1) still leave the
    proposals near their anchors; a scale of 256 gives the RPN the deltas
    that the serving weights' O(300) features give it: slivers."""
    from articulation3d_tpu_torch.weights import random_state_dict
    sd = random_state_dict(seed)
    for k in ("weight", "bias"):
        sd[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= rpn_delta_scale
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
    n_rec, cells = _check_record(rac, feats, boxes, valid, p, sr, al)
    pr = rac._prepare(shapes, boxes, **args)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(opts, min_level=2))
    kboxes, _ = rac._kernel_boxes(boxes, None, p)
    # K2 takes the cotangent as the pooler gets it: invalid rows are skipped
    # by their record (ny = 0), as the plain version skips them
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
    fwd_kernel4 = _time_kernel(rac, feats, boxes, valid, p, sr, al, adaptive_cap=4)
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
         f"{fwd_ms / fwd_bound:.2f}x; record == _prepare on {n_rec} ROIs; {cells}; "
         f"{_over_four(rac, boxes, valid, p, sr, al)}; K1 alone with JAX's cap of 4 "
         f"{fwd_kernel4:.4f} ms ({card})")
    return dict(k1=k1, k2=k2, rois=rois, adj_err=err, adj_ms=adj_ms, busy=busy,
                steps_per_s=len(timed) / t_timed,
                images_per_s=sc.ims_per_batch * len(timed) / t_timed,
                adj_kernel_ms=adj_kernel_ms, adj_plain_ms=adj_plain_ms,
                adj_bound_ms=bound, adj_bound_by=by, adj_atomics=atomics, batch=batch,
                k1_train=dict(ms=fwd_ms, kernel_ms=fwd_kernel_ms, plain_ms=fwd_plain_ms,
                              bound_ms=fwd_bound, bound_by=fwd_by,
                              kernel_ms_cap4=fwd_kernel4))


def _adjoint_bound(rac, shapes, pr, g):
    """Least time on an H100 SXM for one K2 call: g's rows of the valid
    ROIs read once and each float32 cell of the four (B, H_l, W_l, C)
    level gradients written once, over 3.35 TB/s (a kernel that gathers
    per output cell needs no more; the zero fill and the atomics'
    read-modify-write are costs of this design, not of the function); and
    the multiply-adds over the support at the fp32 rate.  Returns
    (ms, "bytes" | "operations")."""
    ry_nz, rx_nz = (pr["ry"] != 0).cpu().numpy(), (pr["rx"] != 0).cpu().numpy()
    ok = pr["ny"].cpu().numpy() > 0
    p, c = int(g.shape[-2]), int(g.shape[-1])
    sup = lambda nz: sum(int(np.ptp(np.nonzero(row)[0])) + 1 for row in nz if row.any())
    flops = sum(2 * c * sup(ry_nz[r]) * sup(rx_nz[r]) for r in np.nonzero(ok)[0])
    out = sum(int(np.prod(s[:3])) for s in shapes) * c * 4
    nbytes = int(ok.sum()) * p * p * c * 4 + out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _adjoint_atomics(rac, pr, c: int) -> int:
    """The float4 atomic adds one K2 call issues: per valid ROI, the cell
    rows and columns that some output row's (column's) support holds,
    times C / 4."""
    import torch
    ry, rx = pr["ry"], pr["rx"]

    def covered(w):                     # (T, P, span) -> (T,) cells covered
        nz = w != 0
        span = w.shape[-1]
        idx = torch.arange(span, device=w.device)
        has = nz.any(-1)
        lo = torch.where(has, nz.float().argmax(-1), torch.full_like(has, span, dtype=torch.long))
        hi = torch.where(has, span - 1 - nz.flip(-1).float().argmax(-1),
                         torch.full_like(has, -1, dtype=torch.long))
        return ((idx >= lo[..., None]) & (idx <= hi[..., None])).any(1).sum(-1)

    valid = pr["ny"] > 0
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
    pooler under autograd ("torch"): losses within 1e-4 relative; the p2
    convs' gradients (which also carry the RPN's) within 1e-3 x max|grad|.
    Then the pooler alone: on the kernel run's own features, boxes and
    cotangent, K3's gradients to p2..p5 (K2) against the gather's autograd
    within 1e-4 x max|grad| per level (the K2 parity tolerance).  The two
    runs' own pooler gradients are printed beside their cotangents, not
    held to a tolerance: the L1 box loss has a kink, so a float32
    difference in the forward can flip the sign of a foreground ROI's
    cotangent.  All of it twice: with phase 5's damped RPN deltas, and with
    the deltas undamped at the serving weights' scale (`_train_weights`,
    x256), whose proposals, and so many sampled ROIs, are slivers; that
    step fails unless some of its sampled ROIs are ones the JAX Pallas
    kernel pools from a coarser level (`_pallas_moved`)."""
    import torch

    from articulation3d_tpu_torch.models import planercnn as pmod
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from articulation3d_tpu_torch.train.optimizer import freeze_mask
    from articulation3d_tpu_torch.train.train_step import compute_losses, to_device
    from articulation3d_tpu_torch.weights import load_d2_state_dict

    cfg = _stage1_config(dtype="float32")
    batch = to_device(train["batch"], "cuda")
    names = ("backbone.fpn_output2.weight", "backbone.fpn_lateral2.weight")
    for damped in (True, False):
        tag = "damped RPN deltas" if damped else "RPN deltas x256 (slivers)"
        model = PlaneRCNN(cfg)
        sd = _train_weights(rpn_delta_scale=0.01 if damped else 256.0)
        load_d2_state_dict(model, {k: v for k, v in sd.items() if k in model.state_dict()})
        del sd
        model = model.cuda().train()
        freeze_mask(model, cfg.model.freeze)
        res = {}
        for impl in ("cuda", "torch"):
            model.config = cfg.replace(model=dataclasses.replace(cfg.model,
                                                                 roi_pooler_impl=impl))
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
            item = store[0]
            boxes, valid = item["boxes"], item["kw"]["valid"]
            grads = {n: dict(model.named_parameters())[n].grad.detach().clone() for n in names}
            assert all(d is not None for d in item["dfeats"]) and "g" in item, impl
            res[impl] = ({k: float(v.detach()) for k, v in losses.items()}, grads, boxes, item)
            note = ""
            if impl == "cuda":
                kw = item["kw"]
                _, note = _check_record(rac, item["features"], boxes, valid, kw["output_size"],
                                        kw["sampling_ratio"], kw["aligned"])
                flat = boxes.reshape(-1, 4)[valid.reshape(-1)]
                wh = (flat[:, 2:] - flat[:, :2]).clamp(min=1e-6)
                aspect = torch.maximum(wh[:, 0] / wh[:, 1], wh[:, 1] / wh[:, 0])
                note = (f"; sampled ROIs at 5:1 or more {int((aspect >= 5).sum())}/"
                        f"{flat.shape[0]}, {note}")
                res[impl] += (int(_pallas_moved(boxes, valid, kw["output_size"],
                                                kw["sampling_ratio"], kw["aligned"]).sum()),)
            _log(f"[train-parity] {tag}, {impl} pooler, float32, "
                 f"{batch['images'].shape[0]} images: K1 launches "
                 f"{rac.multilevel_roi_align_cuda.launches}, K2 launches "
                 f"{rac.multilevel_roi_align_adjoint_cuda.launches}; losses "
                 f"{dict((k, round(v, 6)) for k, v in res[impl][0].items())}{note}")
        (la, ga, ba, ia, moved), (lb, gb, bb, ib) = res["cuda"], res["torch"]
        assert bool((ba == bb).all()), "the two runs sampled different ROIs"
        if not damped:   # ROIs that the JAX Pallas kernel pools off their level
            assert moved > 0, moved
        lerr = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12) for k in lb)
        gerr = {n: float((ga[n] - gb[n]).abs().max()) / float(gb[n].abs().max())
                for n in names}
        _log(f"[train-parity] {tag}: losses max rel err {lerr:.3e} (tol 1e-4); p2 conv "
             f"gradients max abs err / max|grad| "
             f"{dict((n, float('%.3e' % v)) for n, v in gerr.items())} (tol 1e-3)")
        assert lerr <= 1e-4, lerr
        assert all(v <= 1e-3 for v in gerr.values()), gerr

        rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        dg = (ia["g"] - ib["g"]).abs().flatten(2).amax(-1)             # per ROI
        _log(f"[train-parity] {tag}: the two runs' cotangents at the pooler: max abs err / "
             f"max|g| {rel(ia['g'], ib['g']):.3e}, ROIs whose rows differ by more than 1e-4 x "
             f"max|g|: {int((dg > 1e-4 * float(ib['g'].abs().max())).sum())}/{dg.numel()}; "
             f"their pooler gradients, max abs err / max|grad| per level "
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
        _log(f"[train-parity] {tag}: pooler alone, one cotangent: K3 (K2) against the "
             f"gather's autograd, max abs err / max|grad| per level p2..p5 "
             f"{['%.3e' % e for e in perr]} (tol 1e-4; max|grad| "
             f"{['%.3e' % v for v in scale]})")
        assert all(e <= 1e-4 for e in perr), perr
        assert scale[0] > 0, scale
        del model, res, vjp
        torch.cuda.empty_cache()


def _profile_step(pipe, frames, card, tag: str = "profile") -> None:
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
    _log(f"[{tag}] one warm step of 8 frames: wall {wall_us / 1e3:.3f} ms under the "
         f"profiler, device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
         f"{n} kernels, kernel time {total / 1e3:.3f} ms ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"[{tag}]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  {name[:110]}")


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


def _time_kernel(rac, feats, boxes, valid, p, sr, aligned, adaptive_cap=None) -> float:
    """K1 alone (`_launch` into preallocated outputs), CUDA events, ms;
    uncapped, or with `adaptive_cap` (4: the JAX package's count)."""
    import torch
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned,
                min_level=2, adaptive_cap=adaptive_cap)
    boxes, valid = rac._kernel_boxes(boxes, valid, p)
    total = boxes.shape[0] * boxes.shape[1]
    out = torch.empty((total, p, p, feats[0].shape[-1]), dtype=torch.float32, device="cuda")
    record = torch.empty((total, 5), dtype=torch.int32, device="cuda")
    return _time_ms(lambda: rac._launch(feats, boxes, valid, opts, record, out))


def _over_four(rac, boxes, valid, p, sr, aligned) -> str:
    """How many valid ROIs of a pool take more than 4 samples per bin at
    their detectron2 level (the count JAX caps), and the largest count."""
    import torch

    from articulation3d_tpu_torch.ops.roi_align import sample_counts
    flat = boxes.reshape(-1, 4).float()
    lvl = rac.assign_boxes_to_levels(flat) - 2
    scale = torch.tensor([1.0 / s for s in STRIDES], device=flat.device)[lvl]
    n = sample_counts(flat, scale, p, sr, aligned)
    if valid is not None:
        n = n[valid.reshape(-1)]
    return (f"{int((n > 4).sum())}/{n.numel()} valid ROIs take more than 4 samples per bin "
            f"(up to {int(n.max()) if n.numel() else 0})")


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

# --------------------------------------------------------------------------- #
# F1: uncapped adaptive sampling in both kernels
# --------------------------------------------------------------------------- #

# slivers and tall boxes whose bins take 5 to 23 samples (found on the CPU
# with `_roi_record`, adaptive_cap None vs 4)
F1_MOVED = {
    "box": [[82.84113311767578, 7.598225116729736, 639.9981689453125, 262.3997802734375],
            [75.51812744140625, 27.29754066467285, 131.4962158203125, 246.4310760498047],
            [264.30316162109375, 183.0899658203125, 300.2140197753906, 418.6983947753906],
            [441.3808898925781, 7.159747123718262, 495.7129821777344, 232.71519470214844]],
    "plane": [[31.255233764648438, 85.14908599853516, 636.3790283203125, 130.50636291503906],
              [7.546128749847412, 255.8233184814453, 636.2803344726562, 312.2767639160156],
              [64.69647216796875, 187.70018005371094, 622.1502685546875, 208.90760803222656]],
}


def _f1_boxes(pool: str) -> np.ndarray:
    """(1, N, 4): p2 slivers up to the full 640-px width (23 samples per bin
    at 7x7), the 120x360 door (7 samples per bin at p3), the ROIs above and
    2000 random boxes of 20-640 px."""
    rs = np.random.RandomState(0)
    slivers = [[0.0, 100.0, 640.0, 112.0], [5.0, 30.0, 637.0, 40.0],
               [300.0, 0.0, 310.0, 480.0], [20.0, 200.0, 500.0, 215.0]]
    door = [[100.0, 50.0, 220.0, 410.0]]
    n = 2000
    w, h = rs.uniform(20, 640, n), rs.uniform(20, 480, n)
    x1, y1 = rs.uniform(0, 640 - w), rs.uniform(0, 480 - h)
    rand = np.stack([x1, y1, x1 + w, y1 + h], 1)
    return np.concatenate([slivers, door, F1_MOVED[pool], rand]).astype(np.float32)[None]


def phase_f1(rac) -> dict:
    """K1 (float32 and bfloat16) and K2 against their plain versions on ROIs
    whose bins take more than 4 samples, uncapped (the default): the phase-2
    tolerances, K1's record exact against `_prepare` and `_roi_record` on
    the card, and the ROIs whose record the extra samples move (against
    the capped record) counted; then both kernels with the cap at 4 against
    the capped plain versions and `_roi_record`.  Returns the largest
    errors."""
    import torch

    from articulation3d_tpu_torch.ops.roi_align import sample_counts
    gen = torch.Generator(device="cuda").manual_seed(2)
    feats32 = _pyramid(gen, 1, torch.float32)
    errs = {"k1": 0.0, "k2": 0.0}
    for pool in ("box", "plane"):
        p, sr, aligned = POOLS[pool]
        boxes = torch.from_numpy(_f1_boxes(pool)).cuda()
        opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
        flat = boxes.reshape(-1, 4)
        level = rac.assign_boxes_to_levels(flat) - 2
        scale = torch.tensor([1.0 / s for s in STRIDES], device="cuda")[level]
        counts = sample_counts(flat, scale, p, sr, aligned)
        capped = rac._roi_record([f.shape for f in feats32], boxes, adaptive_cap=4, **opts)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            feats = feats32 if dtype == torch.float32 else [f.to(dtype) for f in feats32]
            got = rac.multilevel_roi_align_cuda(feats, boxes, **opts)
            want = rac.multilevel_roi_align_separable(feats, boxes, **opts)
            n_rec, cells = _check_record(rac, feats, boxes, None, p, sr, aligned)
            _, record = rac._forward_kernel(feats, boxes, None, dict(opts, min_level=2))
            torch.cuda.synchronize()
            err, ref = float((got - want).abs().max()), float(want.abs().max())
            moved = (record != capped).any(1)
            _log(f"[f1] K1 {pool:5s} P={p:2d} {str(dtype)[6:]:8s} rois={n_rec}: samples per bin "
                 f"up to {int(counts.max())}, {int((counts > 4).sum())} ROIs above 4; "
                 f"max_abs_err {err:.3e} (tol {tol * ref:.3e}); record == _prepare == "
                 f"_roi_record; {cells}; records the cap would change: "
                 f"{int(moved.sum())} (y0 {int((record[:, 1] != capped[:, 1]).sum())}, x0 "
                 f"{int((record[:, 2] != capped[:, 2]).sum())}, ny or nx "
                 f"{int(((record[:, 3:] != capped[:, 3:]).any(1)).sum())})")
            assert np.isfinite(err) and err <= tol * ref, (pool, dtype, err)
            assert int(counts.max()) >= (23 if p == 7 else 12) and bool(moved.any())
            if dtype == torch.float32:
                errs["k1"] = max(errs["k1"], err)
        shapes = [f.shape for f in feats32]
        g = torch.randn((boxes.shape[1], p, p, 256), generator=gen, device="cuda")
        fwd, record = rac._forward_kernel(feats32, boxes, None, dict(opts, min_level=2))
        got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **opts)
        want = rac.multilevel_roi_align_adjoint_separable(g, shapes,
                                                          rac._prepare(shapes, boxes, **opts))
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ref = max(float(b.abs().max()) for b in want)
        lhs = float((fwd.double() * g.double()).sum())
        rhs = float(sum((f.double() * d.double()).sum() for f, d in zip(feats32, got)))
        rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
        _log(f"[f1] K2 {pool:5s} P={p:2d} float32 rois={boxes.shape[1]}: max_abs_err {err:.3e} "
             f"(tol {1e-4 * ref:.3e}); transpose identity rel_err {rel:.3e} (tol 1e-5)")
        assert err <= 1e-4 * ref and rel <= 1e-5, (pool, err, rel)
        errs["k2"] = max(errs["k2"], err)
        # the kernels' runtime cap (the option block's last int) at JAX's 4
        cap4 = dict(opts, adaptive_cap=4)
        fwd4, record4 = rac._forward_kernel(feats32, boxes, None, dict(cap4, min_level=2))
        want4 = rac.multilevel_roi_align_separable(feats32, boxes, **cap4).reshape(fwd4.shape)
        got4 = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record4, **cap4)
        plain4 = rac.multilevel_roi_align_adjoint_separable(g, shapes,
                                                            rac._prepare(shapes, boxes, **cap4))
        torch.cuda.synchronize()
        e1 = float((fwd4 - want4).abs().max())
        e2 = max(float((a - b).abs().max()) for a, b in zip(got4, plain4))
        ref2 = max(float(b.abs().max()) for b in plain4)
        _log(f"[f1] capped at 4 (JAX's count) {pool:5s}: K1 max_abs_err {e1:.3e}, K2 "
             f"max_abs_err {e2:.3e}, record == _roi_record(adaptive_cap=4) "
             f"{bool((record4 == capped).all())}, {int((fwd4 != fwd).any(-1).any(-1).any(-1).sum())} "
             f"ROIs pooled differently from uncapped")
        assert bool((record4 == capped).all()) and e1 <= 1e-5 * float(want4.abs().max())
        assert e2 <= 1e-4 * ref2, (pool, e1, e2)
        errs["k1"], errs["k2"] = max(errs["k1"], e1), max(errs["k2"], e2)
    return errs


# --------------------------------------------------------------------------- #
# the refine head and the DRPN head at full width
# --------------------------------------------------------------------------- #

def _parity_config(**model_kw):
    """configs/config.yaml at score threshold 0, with `model_kw`: the
    parity caps (1000 post-NMS proposals, 100 detections per image)."""
    from articulation3d_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", "config.yaml"))
    heads = dataclasses.replace(cfg.model.roi_heads, score_thresh_test=0.0)
    return cfg.replace(weights="", model=dataclasses.replace(cfg.model, roi_heads=heads,
                                                             **model_kw))


def _serving_weights(cfg):
    """`random_state_dict(0)` with the config's refine / DRPN keys, the RPN
    deltas damped and, with the refine head, its instance logits lifted by
    2.  A trained RPN proposes boxes near its anchors; at the random
    weights' scale the deltas hit the log(1000/16) clamp and most proposals
    become full-height slivers.  The rate phases keep the damping, so that
    their times stay comparable across runs; the slivers are driven by the
    parity phases and "[goldens]"."""
    from articulation3d_tpu_torch.weights import random_state_dict, schema_options
    sd = random_state_dict(0, **schema_options(cfg.model))
    for k in ("weight", "bias"):
        sd[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= 0.01
    if cfg.model.refine_on:
        # at random weights the global background logit wins every pixel;
        # lift the instance logits so the refined masks are not all empty
        sd["refine_head.refinement_block.pred.1.bias"] += np.float32(2.0)
    return sd


def _calibrate_depth_bn(model, frames) -> None:
    """Set the depth head's BatchNorm statistics to those of `frames` (one
    train-mode pass at momentum 1).  The random statistics of
    `random_state_dict` leave the eval-mode decoder's output near 4e8 m;
    the refine head reads the depth (its plane offsets and an input
    channel), so the refine phases give it metres, as a trained model
    would."""
    import torch

    from articulation3d_tpu_torch.models.depth_head import BatchNorm2d
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    bns = [m for m in model.depth_head.modules() if isinstance(m, BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    with torch.no_grad():
        feats = model.features(preprocess_images(torch.from_numpy(np.stack(frames)).cuda()))
        for m in bns:
            m.momentum = 1.0
        try:
            with model._autocast(feats["p2"].device):
                model.depth_head(feats, train=True)
        finally:
            for m, v in zip(bns, momenta):
                m.momentum = v


def _route_agreement(a, b, masks_a=None, masks_b=None):
    """Kernel route `a` against plain route `b` (Detections of one batch):
    matched share, box and plane max errors, and with full masks the IoU of
    the two routes' foreground over the matched detections (pixels both
    routes mark over pixels either marks, summed over the pairs) and the
    share of equal pixels (near 1 whatever the masks: each pixel is in at
    most one of an image's masks)."""
    n_ref = n_match = 0
    box_err = plane_err = 0.0
    inter = union = eq = tot = 0
    for i in range(a.boxes.shape[0]):
        va, vb = a.valid[i].cpu().numpy(), b.valid[i].cpu().numpy()
        ra, rb = a.boxes[i].cpu().numpy()[va], b.boxes[i].cpu().numpy()[vb]
        ri, oi = _match(rb, ra)
        n_ref, n_match = n_ref + len(rb), n_match + len(ri)
        if not len(ri):
            continue
        box_err = max(box_err, float(np.abs(rb[ri] - ra[oi]).max()))
        pa, pb = a.planes[i].cpu().numpy()[va][oi], b.planes[i].cpu().numpy()[vb][ri]
        plane_err = max(plane_err, float(np.abs(pa - pb).max()))
        if masks_a is not None:
            ma = masks_a[i][np.nonzero(va)[0][oi]]
            mb = masks_b[i][np.nonzero(vb)[0][ri]]
            inter += int((ma & mb).sum())
            union += int((ma | mb).sum())
            eq += int((ma == mb).sum())
            tot += ma.size
    return dict(matched=n_match / max(n_ref, 1), n_ref=n_ref, box_err=box_err,
                plane_err=plane_err, fg_iou=inter / max(union, 1), fg_union=union,
                equal_pixels=eq / max(tot, 1))


def phase_refine_serve(rac, card) -> dict:
    """`VideoPipeline` on configs/config.yaml with `model.refine_on true`
    (480x640, batch 8, score threshold 0, 16 noise frames): frames/s, the
    refine pass's share of a warm step (CUDA events around it, and the
    profiler's busy share), peak memory, K1's launches; then the kernel
    route against the plain route (`roi_pooler_impl: torch`) on 8 of the
    frames in float32: refined masks by the IoU of their foreground over
    the matched detections (at least 0.95; 0.9824 on an H100), planes by
    max error (at most 1e-4 m; 1.47e-6 on an H100)."""
    import torch

    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline

    cfg = _parity_config(refine_on=True)
    sd = _serving_weights(cfg)
    model = build_model(cfg, state_dict=sd)
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(16)]
    _calibrate_depth_bn(model, frames[:8])
    sd.update({f"depth_head.{k}": v.cpu().numpy()
               for k, v in model.depth_head.state_dict().items()})
    pipe = VideoPipeline(cfg, model, batch_size=8, conf_threshold=0.0)
    rc = cfg.model.refine_head
    _log(f"[refine-serve] configs/config.yaml with model.refine_on true (R50-FPN, dtype "
         f"{cfg.model.dtype}, pooler {cfg.model.roi_pooler_impl}, "
         f"{cfg.model.roi_heads.detections_per_image} detections per image, the refine "
         f"U-Net at {rc.height}x{rc.width} in float32), score threshold 0, batch 8, 16 "
         f"frames 480x640, weights random_state_dict(0) with the refine keys, RPN deltas x0.01, "
         f"instance logits +2, the depth head's BatchNorm statistics from the first 8 frames")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rac.multilevel_roi_align_cuda.launches = 0
    preds = pipe.run(frames, verbose=True)
    k1 = rac.multilevel_roi_align_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    assert len(preds) == 16 and k1 == 3 * 2, (len(preds), k1)
    for pr in preds:
        assert pr.masks.shape == (len(pr), 480, 640) and np.isfinite(pr.planes).all()
    fg = float(np.mean([pr.masks.mean() for pr in preds]))
    assert fg > 0, "the refined masks are all background"
    pipe.run(frames)
    walls = list(pipe.chunk_walls)
    fps = 8 / float(np.mean(walls))

    # the refine pass's share of one warm step
    batch = torch.from_numpy(np.stack(frames[:8])).cuda()
    spans = []
    orig = model._refine

    def timed_refine(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    model._refine = timed_refine
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del model._refine
    refine_ms = spans[0][0].elapsed_time(spans[0][1])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, n_k = _device_time(prof)
    total = sum(by_name.values())
    conv = sum(v for k, v in by_name.items() if "conv" in k.lower() or "gemm" in k.lower()
               or "sm90" in k or "cudnn" in k.lower())
    _log(f"[refine-serve] steady chunk walls {['%.4f' % w for w in walls]} s = {fps:.2f} "
         f"frames/s; max_memory_allocated {peak / 2**30:.3f} GiB; K1 launches {k1} (3 per "
         f"batch); mean refined foreground share per mask {fg:.5f} ({card})")
    _log(f"[refine-serve] one warm step of 8 frames: {step_ms:.3f} ms, of which the refine "
         f"pass (paste at threshold -1 + the U-Net over 8 x "
         f"{cfg.model.roi_heads.detections_per_image} instances) {refine_ms:.3f} ms "
         f"({100 * refine_ms / step_ms:.1f}%); under the profiler: wall {wall_us / 1e3:.3f} ms, "
         f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), {n_k} kernels, "
         f"kernel time {total / 1e3:.3f} ms, conv/GEMM kernels {conv / 1e3:.3f} ms ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        _log(f"[refine-serve]   {us / 1e3:9.3f} ms  {100 * us / max(total, 1e-9):5.1f}%  "
             f"{name[:110]}")
    # torch's default for float32 convolutions: cuDNN may use TF32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pipe.run(frames)
        tf32_walls = list(pipe.chunk_walls)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    _log(f"[refine-serve] with cuDNN TF32 on (torch's default; every other line here runs "
         f"it off): chunk walls {['%.4f' % w for w in tf32_walls]} s = "
         f"{8 / float(np.mean(tf32_walls)):.2f} frames/s ({card})")
    del pipe, model
    torch.cuda.empty_cache()

    # kernel route vs plain route, float32, 8 frames
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    from articulation3d_tpu_torch.video.pipeline import make_inference_step
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    model32 = build_model(cfg32, state_dict=sd)
    outs = {}
    for impl in ("cuda", "torch"):
        model32.config = cfg32.replace(model=dataclasses.replace(cfg32.model,
                                                                 roi_pooler_impl=impl))
        step = make_inference_step(model32.config, model32)
        with torch.no_grad():
            res = model32.inference(preprocess_images(batch))
            wire = step(batch)
        masks = np.unpackbits(wire["full_masks_packed"].cpu().numpy(), axis=-1,
                              count=640).astype(bool)
        outs[impl] = (res["detections"], masks, wire["planes"])
    agree = _route_agreement(outs["cuda"][0], outs["torch"][0], outs["cuda"][1],
                             outs["torch"][1])
    _log(f"[refine-serve] kernel route vs plain route, float32, 8 frames: detections matched "
         f"{agree['matched']:.4f} of {agree['n_ref']}, box max err {agree['box_err']:.4f} px, "
         f"refined planes max err {agree['plane_err']:.4e} (limit 1e-4), refined masks' "
         f"foreground IoU {agree['fg_iou']:.6f} over {agree['fg_union']} pixels either route "
         f"marks in the matched detections (gate 0.95), pixels equal "
         f"{agree['equal_pixels']:.6f}")
    assert agree["matched"] >= 0.9 and agree["fg_iou"] >= 0.95, agree
    assert agree["plane_err"] <= 1e-4, agree
    del model32
    torch.cuda.empty_cache()
    return dict(k1=k1, fps=fps, peak=peak, refine_ms=refine_ms, step_ms=step_ms,
                busy=busy / wall_us, agree=agree)


def _stage3_batch(cfg, b: int, g: int = 4):
    """Synthetic stage-3 batch: `_train_batch`'s images and boxes, box-shaped
    packed masks, planes (unit normal x offset), axes and u16 depth."""
    h, w = cfg.input.height, cfg.input.width
    batch = _train_batch(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, mask_on=False, plane_on=False, axis_on=False, depth_on=False)), b, g)
    rs = np.random.RandomState(1)
    masks = np.zeros((b, g, h, w), bool)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2 = batch["gt_boxes"][i, j].astype(int)
            masks[i, j, y1 + 2:y2 - 2, x1 + 2:x2 - 2] = True
    normals = rs.randn(b, g, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    axis = lambda: np.concatenate([rs.randn(b, g, 3), np.ones((b, g, 1))], -1)
    batch.update(gt_masks_packed=np.packbits(masks, axis=-1),
                 gt_planes=(normals * rs.uniform(1, 4, (b, g, 1))).astype(np.float32),
                 gt_rot_axis=axis().astype(np.float32), gt_tran_axis=axis().astype(np.float32),
                 gt_depth_mm=rs.randint(500, 5000, (b, h, w)).astype(np.uint16))
    return batch


def phase_refine_train(rac, card) -> dict:
    """configs/step3_plane.yaml with `model.refine_on true` through `Trainer`
    at ims 4 (cut from the stage's 8), 2 warm + 10 timed steps on one
    synthetic batch: steps/s, peak memory, K1/K2 per step, a finite,
    falling `refine_loss`, and K1 against its plain version on the first
    step's pool inputs (the sampled ROIs' box, mask and plane pools and the
    cascade's no-grad mask and plane pools over its detections)."""
    import torch

    from articulation3d_tpu_torch.config import load_config
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import warm_start

    cfg = load_config(os.path.join(ROOT, "configs", "step3_plane.yaml"))
    # score threshold 0 as in serving: at random weights the 3-way softmax
    # gives every class about 1/3, below the shipped 0.7, and the cascade
    # would hand the refine head no detection
    heads = dataclasses.replace(cfg.model.roi_heads, score_thresh_test=0.0)
    cfg = cfg.replace(weights="", output_dir=os.path.join(ROOT, ".chip_smoke", "refine"),
                      model=dataclasses.replace(cfg.model, refine_on=True, roi_heads=heads),
                      solver=dataclasses.replace(cfg.solver, ims_per_batch=4,
                                                 warmup_iters=0, base_lr=0.002))
    batch = _stage3_batch(cfg, 4)
    trainer = Trainer(cfg, [batch])
    warm_start(trainer.model, _train_weights())
    _log(f"[refine-train] configs/step3_plane.yaml with model.refine_on true (frozen trunk, "
         f"box head and axis head; mask, plane, depth and refine heads training; dtype "
         f"{cfg.model.dtype}, {cfg.model.roi_heads.batch_size_per_image} ROIs and "
         f"{cfg.model.roi_heads.detections_per_image} cascade detections per image at score "
         f"threshold 0), ims 4 (cut from 8), warmup_iters 0, base_lr 0.002; phase 5's weights plus "
         f"random_state_dict(0)'s refine keys; one synthetic batch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rac.multilevel_roi_align_cuda.launches = 0
    rac.multilevel_roi_align_adjoint_cuda.launches = 0
    pools = _record_pools(5)          # the first step's three sampled and two cascade pools
    try:
        recs = trainer.train(2)
    finally:
        pools.restore()
    recs += trainer.train(12)
    k1 = rac.multilevel_roi_align_cuda.launches
    k2 = rac.multilevel_roi_align_adjoint_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    cascade = [kw for _, _, kw in pools.calls[3:]]
    assert len(pools.calls) == 5 and all(kw["training"] and kw["resolution"] == 14
                                         for kw in cascade), [kw for _, _, kw in pools.calls]
    err = _main_path_err(rac, pools.calls, tag="refine-train-pools")
    n = len(recs)
    timed = recs[2:]
    t_timed = sum(r["wall_s"] for r in timed)
    refine = [r["refine_loss"] for r in recs]
    _log(f"[refine-train] {n} steps: first {recs[0]['wall_s']:.4f} s, 10 timed steps "
         f"{t_timed:.4f} s = {len(timed) / t_timed:.4f} steps/s, "
         f"{4 * len(timed) / t_timed:.3f} images/s; max_memory_allocated {peak / 2**30:.3f} "
         f"GiB; launches per step K1 {k1 / n:.2f} K2 {k2 / n:.2f} ({k1}, {k2} over {n} "
         f"steps) ({card})")
    _log(f"[refine-train] refine_loss {['%.4f' % v for v in refine]}; last step losses "
         f"{dict((k, round(v, 6)) for k, v in recs[-1].items())}")
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert k1 == 5 * n and k2 == 0, (k1, k2, n)
    assert np.mean(refine[-3:]) < np.mean(refine[:3]), refine
    busy = _profile_train_step(trainer, card, tag="refine-train-profile")
    del trainer, pools
    torch.cuda.empty_cache()
    return dict(k1=k1, k2=k2, steps_per_s=len(timed) / t_timed, peak=peak, busy=busy, err=err)


def phase_drpn(rac, card) -> dict:
    """configs/config.yaml with `model.rpn.head_convs 5`: one serving batch
    of 8 frames through `VideoPipeline` (K1's launches, and K1 against its
    plain version on that batch's three pools over the DRPN's proposals
    and detections), then the kernel route against the plain route in
    float32: proposals, and detections at phase 4's gates."""
    import torch

    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline

    cfg = _parity_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, rpn=dataclasses.replace(cfg.model.rpn, head_convs=5)))
    sd = _serving_weights(cfg)
    model = build_model(cfg, state_dict=sd)
    pipe = VideoPipeline(cfg, model, batch_size=8, conf_threshold=0.0)
    rs = np.random.RandomState(3)
    frames = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(8)]
    rac.multilevel_roi_align_cuda.launches = 0
    pools = _record_pools(3)
    try:
        preds = pipe.run(frames)
    finally:
        pools.restore()
    k1 = rac.multilevel_roi_align_cuda.launches
    assert len(preds) == 8 and all(len(p) > 0 for p in preds) and k1 == 3, k1
    err = _main_path_err(rac, pools.calls, tag="drpn-pools")
    del pipe, model, pools
    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    model32 = build_model(cfg32, state_dict=sd)
    images = preprocess_images(torch.from_numpy(np.stack(frames)).cuda())
    outs = {}
    for impl in ("cuda", "torch"):
        model32.config = cfg32.replace(model=dataclasses.replace(cfg32.model,
                                                                 roi_pooler_impl=impl))
        outs[impl] = model32.inference(images)
    pa, pb = outs["cuda"]["proposals"], outs["torch"]["proposals"]
    same_valid = bool((pa["valid"] == pb["valid"]).all())
    prop_err = float((pa["boxes"] - pb["boxes"]).abs()[pa["valid"]].max())
    agree = _route_agreement(outs["cuda"]["detections"], outs["torch"]["detections"])
    _log(f"[drpn] configs/config.yaml with model.rpn.head_convs 5 (5 plain 3x3 convs, one "
         f"ReLU), batch 8, 480x640: K1 launches {k1}, detections per frame "
         f"{[len(p) for p in preds]}; kernel route vs plain route, float32: proposals "
         f"{int(pa['valid'].sum())} valid, valid masks equal {same_valid}, box max err "
         f"{prop_err:.3e} px; detections matched {agree['matched']:.4f} of {agree['n_ref']}, "
         f"box max err {agree['box_err']:.4f} px, planes max err {agree['plane_err']:.4e} "
         f"({card})")
    assert same_valid and prop_err <= 1e-3, prop_err
    assert agree["matched"] >= 0.9 and agree["box_err"] < 2.0, agree
    del model32
    torch.cuda.empty_cache()
    return dict(k1=k1, err=err)


# --------------------------------------------------------------------------- #
# 13-16. data parallelism, the rest of export and vis, the goldens harness
# --------------------------------------------------------------------------- #

def _param_samples(model) -> dict:
    """A strided sample (at most 4096 values, float64 on the host) of every
    trainable parameter."""
    out = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            flat = p.detach().reshape(-1)
            out[n] = flat[::max(1, flat.numel() // 4096)].double().cpu().numpy()
    return out


def _params_agree(a: dict, b: dict, before: dict, rel: float = 1e-3) -> float:
    """The largest |a - b| of the samples over `rel` x the largest change the
    steps made to that tensor plus 1e-6 x its magnitude (agreement: <= 1)."""
    worst = 0.0
    assert set(a) == set(b) == set(before)
    for n in b:
        tol = rel * np.abs(b[n] - before[n]).max() + 1e-6 * np.abs(b[n]).max()
        worst = max(worst, float(np.abs(a[n] - b[n]).max()) / max(tol, 1e-30))
    return worst


def _stage1_trainer(ims: int, grad_sync_dtype: str = "float32", **model_kw):
    """Phase 5's trainer (configs/step1_bbox.yaml, damped weights) at a
    global batch of `ims`, and phase 5's synthetic batch of `ims`."""
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import load_d2_state_dict
    cfg = _stage1_config(**model_kw)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, ims_per_batch=ims,
                                                 checkpoint_period=0,
                                                 grad_sync_dtype=grad_sync_dtype))
    batch = _train_batch(cfg, ims)
    trainer = Trainer(cfg, [batch])
    load_d2_state_dict(trainer.model, {k: v for k, v in _train_weights().items()
                                       if k in trainer.model.state_dict()})
    return trainer, batch


def _k2_err(rac, item, tag: str, what: str) -> float:
    """K2 against its plain version on a training step's own box-pool
    inputs and cotangent (`_record_train_pool`), at 1e-4 x max|plain|."""
    import torch
    feats, boxes, kw = item["features"], item["boxes"], item["kw"]
    g = item["g"].reshape(-1, *item["g"].shape[2:]).contiguous()
    opts = dict(strides=STRIDES, output_size=kw["output_size"],
                sampling_ratio=kw["sampling_ratio"], aligned=kw["aligned"])
    shapes = [f.shape for f in feats]
    pr = rac._prepare(shapes, boxes, valid=kw["valid"], **opts)
    _, record = rac._forward_kernel(feats, boxes, kw["valid"], dict(opts, min_level=2))
    got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **opts)
    want = rac.multilevel_roi_align_adjoint_separable(g, shapes, pr)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    _log(f"[{tag}] K2 against the plain version on {what} cotangent "
         f"({tuple(g.shape)}): err {err:.3e} (tol {1e-4 * scale:.3e})")
    assert err <= 1e-4 * scale, (err, scale)
    return err


def phase_ddp1(rac, card, phase5) -> dict:
    """"[ddp-1]": an NCCL process group of one and phase 5's full-width
    stage-1 step (ims 16) wrapped in DistributedDataParallel, against the
    unwrapped step from the same state: the first two steps' losses and
    the parameters after them, then 12 timed steps of each; K1 and K2 of
    the wrapped step against their plain versions on its own inputs.

    The bfloat16 trunk rounds its weight gradients to bfloat16 after sums
    whose order varies from run to run on the card (cuDNN's weight
    gradients, K2's atomics), so two unwrapped runs differ too: the
    parameters are held at phase 2's bfloat16 tolerance, 1e-2 x the change
    two steps make (+ 1e-6 x the magnitude), beside the spread of a second
    unwrapped run."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from articulation3d_tpu_torch.models import planercnn as pmod
    from articulation3d_tpu_torch.parallel import init_distributed, process_count

    store = tempfile.mktemp(prefix="ddp1_", dir=os.path.join(ROOT, ".chip_smoke"))
    assert init_distributed(f"file://{store}", 1, 0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl" and process_count() == 1
        plain, _ = _stage1_trainer(16)
        wrapped, _ = _stage1_trainer(16)
        wrapped.step_model = DistributedDataParallel(wrapped.model, device_ids=[0],
                                                     broadcast_buffers=False)
        before = _param_samples(plain.model)
        assert all(np.array_equal(v, before[n]) for n, v in
                   _param_samples(wrapped.model).items())
        recs_plain = plain.train(2)
        after_plain = _param_samples(plain.model)
        again, _ = _stage1_trainer(16)
        again.train(2)
        spread = _params_agree(_param_samples(again.model), after_plain, before, rel=1e-2)
        del again
        rac.multilevel_roi_align_cuda.launches = 0
        rac.multilevel_roi_align_adjoint_cuda.launches = 0
        pools = _record_pools(1)
        store_pool = []
        orig = _record_train_pool(pmod, store_pool)
        try:
            recs = wrapped.train(2)
        finally:
            pools.restore()
            pmod.multilevel_roi_align_train = orig
        after_wrapped = _param_samples(wrapped.model)
        recs += wrapped.train(14)
        torch.cuda.synchronize()
        k1 = rac.multilevel_roi_align_cuda.launches
        k2 = rac.multilevel_roi_align_adjoint_cuda.launches
        assert k1 == 14 and k2 == 14, (k1, k2)
        recs_plain += plain.train(14)
        loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                       for a, b in zip(recs[:2], recs_plain[:2]) for k in b
                       if k not in ("data_s", "wall_s"))
        param_ratio = _params_agree(after_wrapped, after_plain, before, rel=1e-2)
        sps_ddp, sps_plain = _rate(recs), _rate(recs_plain)
        _log(f"[ddp-1] NCCL group of 1, configs/step1_bbox.yaml at ims 16 (phase 5's "
             f"weights and batch, {wrapped.cfg.model.dtype} trunk), DistributedDataParallel "
             f"against the unwrapped step from the same state: two steps' losses within "
             f"{loss_err:.3e} relative (gate 1e-4), parameters after them at "
             f"{param_ratio:.4f} of the gate (1e-2 x the change + 1e-6 x the magnitude; a "
             f"second unwrapped run from the same state at {spread:.4f}); "
             f"12 timed steps wrapped {sps_ddp:.4f} steps/s, then unwrapped "
             f"{sps_plain:.4f} steps/s in this phase, phase 5 {phase5['steps_per_s']:.4f} "
             f"steps/s; K1 {k1}, K2 {k2} over 14 wrapped steps ({card})")
        assert loss_err <= 1e-4 and param_ratio <= 1.0, (loss_err, param_ratio)
        err1 = _main_path_err(rac, pools.calls, tag="ddp-pools")
        err2 = _k2_err(rac, store_pool[0], "ddp-pools", "the wrapped step's")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    del plain, wrapped, pools, store_pool
    torch.cuda.empty_cache()
    return dict(k1=k1, k2=k2, err1=err1, err2=err2, steps_per_s=sps_ddp,
                plain_steps_per_s=sps_plain, param_ratio=param_ratio, spread=spread)


def _tensor_gap(a: dict, b: dict) -> float:
    """The largest |a - b| of the parameter samples over each tensor's
    largest |b|."""
    return max(float(np.abs(a[n] - b[n]).max()) / max(float(np.abs(b[n]).max()), 1e-30)
               for n in b)


def phase_remat(rac, card, phase5) -> dict:
    """"[remat]": phase 5's cell (configs/step1_bbox.yaml, ims 16, 480x640,
    full width, bf16 trunk) with `resnet.remat` off and on from the same
    state, as alternating pairs (off, on, off, on): the first two steps'
    losses and the parameters after them, the peak memory of 12 steps and
    the steps/s of the last 10; then K1 and K2 of a remat step against
    their plain versions on its own inputs ("[remat-pools]").  The two
    off runs give the card's own spread between runs of one program
    (cuDNN's weight gradients and K2's atomics sum in varying orders)."""
    import torch

    from articulation3d_tpu_torch.models import planercnn as pmod

    base = _stage1_config().model.resnet
    runs = []
    rac.multilevel_roi_align_cuda.launches = 0
    rac.multilevel_roi_align_adjoint_cuda.launches = 0
    for remat in (False, True, False, True):
        trainer, _ = _stage1_trainer(16, resnet=dataclasses.replace(base, remat=remat))
        assert trainer.model.backbone.bottom_up.cfg.remat == remat
        before = _param_samples(trainer.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs = trainer.train(2)
        after = _param_samples(trainer.model)
        recs += trainer.train(12)
        torch.cuda.synchronize()
        runs.append(dict(remat=remat, before=before, after=after, records=_stage_records(recs),
                         peak=torch.cuda.max_memory_allocated(), steps_per_s=_rate(recs)))
        if remat and len(runs) == 4:
            pools = _record_pools(1)
            store_pool = []
            orig = _record_train_pool(pmod, store_pool)
            try:
                trainer.train(trainer.iter + 1)
            finally:
                pools.restore()
                pmod.multilevel_roi_align_train = orig
        del trainer
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    k1 = rac.multilevel_roi_align_cuda.launches
    k2 = rac.multilevel_roi_align_adjoint_cuda.launches
    off, on, off2 = runs[0], runs[1], runs[2]
    assert all(np.array_equal(r["before"][n], off["before"][n]) for r in runs[1:]
               for n in off["before"])
    loss_gap = lambda a, b: max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                                for x, y in zip(a["records"][:2], b["records"][:2]) for k in y)
    gap, spread = _tensor_gap(on["after"], off["after"]), _tensor_gap(off2["after"], off["after"])
    ratio = _params_agree(on["after"], off["after"], off["before"], rel=1e-2)
    peaks = [f"{r['peak'] / 2**30:.3f}" for r in runs]
    rates = [f"{r['steps_per_s']:.4f}" for r in runs]
    _log(f"[remat] configs/step1_bbox.yaml at ims 16, 480x640, {_stage1_config().model.dtype} "
         f"trunk (phase 5's weights and batch), resnet.remat off / on / off / on from the same "
         f"state: max_memory_allocated {peaks} GiB, 10 timed steps {rates} steps/s (phase 5 "
         f"{phase5['steps_per_s']:.4f}); remat against off after two steps: losses within "
         f"{loss_gap(on, off):.3e} relative, parameters within {gap:.3e} of each tensor's "
         f"largest value ({ratio:.4f} of 1e-2 x the change + 1e-6 x the magnitude); the two off "
         f"runs: losses {loss_gap(off2, off):.3e}, parameters {spread:.3e}; K1 {k1}, K2 {k2} "
         f"over {4 * 12 + 1} steps ({card})")
    assert all(np.isfinite(v) for r in runs for rec in r["records"] for v in rec.values())
    assert ratio <= 1.0 and loss_gap(on, off) <= 1e-4, (ratio, loss_gap(on, off))
    assert k1 == k2 == 4 * 12 + 1, (k1, k2)
    err1 = _main_path_err(rac, pools.calls, tag="remat-pools")
    err2 = _k2_err(rac, store_pool[0], "remat-pools", "the remat step's")
    del pools, store_pool
    torch.cuda.empty_cache()
    return dict(k1=k1, k2=k2, err1=err1, err2=err2, gap=gap, spread=spread,
                peak=[r["peak"] for r in runs], steps_per_s=[r["steps_per_s"] for r in runs])


def _eval_trainer():
    """A `Trainer` on configs/config.yaml (every head but refine, score
    threshold 0) with phase 3's weights, evaluating arti_val and
    scannet_val of phase 9's dataset at a batch of 8."""
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import load_d2_state_dict
    cfg = _parity_config()
    cfg = cfg.replace(datasets_test=("arti_val", "scannet_val"),
                      output_dir=os.path.join(ROOT, ".chip_smoke", "ranks_eval"),
                      solver=dataclasses.replace(cfg.solver, ims_per_batch=8))
    trainer = Trainer(cfg, [])
    load_d2_state_dict(trainer.model, _serving_weights(cfg))
    return trainer


def _val_frames():
    """The 32 frames of phase 9's first val clip."""
    from articulation3d_tpu_torch.video.io import read_frames
    clips = os.path.join(ROOT, ".chip_smoke", "datasets", "clips")
    frames, _ = read_frames(os.path.join(clips, sorted(os.listdir(clips))[0]), 480, 640)
    return frames


def _stage_records(recs) -> list:
    return [{k: v for k, v in r.items() if k not in ("data_s", "wall_s")} for r in recs]


def _rate(recs) -> float:
    """Steps/s of the records after the first two."""
    return len(recs[2:]) / sum(r["wall_s"] for r in recs[2:])


def _recording_bf16_hook(store: list):
    """`parallel.dist.bf16_grad_sync_hook` that also keeps each bucket as
    this rank had it and as the sync left it."""
    from articulation3d_tpu_torch.parallel import dist as pdist
    hook = pdist.bf16_grad_sync_hook

    def recording(group, bucket):
        local = bucket.buffer().clone()

        def keep(fut):
            store.append((local, fut.value().clone()))
            return fut.value()

        return hook(group, bucket).then(keep)

    return recording


def _check_bf16_buckets(store: list, world: int) -> dict:
    """Each recorded bucket's sync against JAX's order, from the ranks' own
    buckets (two ranks): bit-equal to ((g0/2).bf16 + (g1/2).bf16) in
    bfloat16; how many values differ from the float32 sync.  Also run by
    `tests/test_torch_sharded_step.py` on the CPU."""
    import torch
    import torch.distributed as dist
    assert world == 2, world
    exact, n, off_f32 = True, 0, 0
    for local, synced in store:
        both = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(both, local)
        want = ((both[0] / 2).bfloat16() + (both[1] / 2).bfloat16()).bfloat16().float()
        exact &= torch.equal(synced, want)
        n += synced.numel()
        off_f32 += int((synced != both[0] / 2 + both[1] / 2).sum())
    return {"buckets": len(store), "values": n, "exact": exact, "off_f32": off_f32}


def _emulated_sharded_steps(trainer, batch, steps: int) -> list:
    """The W = 2 sharded step (`sharded_train_step`) emulated in one
    process: per step, the gradients of each half of the global batch (the
    global batch's per-image generators, each half its own losses and
    normalisers and BatchNorm statistics), their mean, the mean of the two
    halves' new running statistics, then the clip and the update."""
    import torch

    from articulation3d_tpu_torch.train.targets import per_image_keys
    from articulation3d_tpu_torch.train.train_step import (_update, compute_losses,
                                                           running_statistics, to_device)
    model, dev = trainer.model, trainer.device
    b = batch["images"].shape[0]
    halves = [to_device({k: v[h * b // 2:(h + 1) * b // 2] for k, v in batch.items()}, dev)
              for h in range(2)]
    params = [p for p in model.parameters() if p.requires_grad]
    stats = running_statistics(model)
    recs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        gens = per_image_keys(trainer.generator, b)
        old = [s.clone() for s in stats]
        grads, new_stats, metrics = [], [], []
        for h, half in enumerate(halves):
            for s, o in zip(stats, old):
                s.copy_(o)
            trainer.optimizer.zero_grad(set_to_none=True)
            losses = compute_losses(model, half, gens[h * b // 2:(h + 1) * b // 2])
            total = sum(v.to(torch.float32) for v in losses.values())
            total.backward()
            grads.append([p.grad.clone() for p in params])
            new_stats.append([s.clone() for s in stats])
            metrics.append({**{k: float(v.detach()) for k, v in losses.items()},
                            "total_loss": float(total.detach())})
        with torch.no_grad():
            for p, g0, g1 in zip(params, *grads):
                p.grad.copy_(g0 / 2 + g1 / 2)
            for s, s0, s1 in zip(stats, *new_stats):
                s.copy_((s0 + s1) / 2)
        _update(model, trainer.optimizer, trainer.scheduler)
        trainer.iter += 1
        recs.append({k: (metrics[0][k] + metrics[1][k]) / 2 for k in metrics[0]})
        recs[-1]["wall_s"] = time.perf_counter() - t0
    return recs


def _ranks_payload(distributed: bool) -> dict:
    """What "[ddp-2]" and "[ddp-cards]" compare, from one process or from
    each rank, on float32 stage-1 steps at a global batch of 16 (each rank
    its share), then the two evaluators through `Trainer.test` and
    `VideoPipeline` on a val clip.

    Each rank: two steps of the `Trainer`'s own step (`sharded_train_step`)
    and 12 more, timed; two steps of the global-batch step (`train_step`,
    JAX's `make_train_step` over a mesh) from a fresh trainer; one step
    with `solver.grad_sync_dtype: bfloat16` whose buckets are held to JAX's
    order (two ranks), and 12 more, timed.  One process: two steps of the emulated
    sharded step, and two steps of `Trainer` at 16 (the global batch) and
    12 more, timed."""
    import torch
    import torch.distributed as dist

    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.parallel import dist as pdist
    from articulation3d_tpu_torch.train.train_step import train_step
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline

    out = {}
    trainer, batch = _stage1_trainer(16, dtype="float32")      # parity in float32
    out["before"] = _param_samples(trainer.model)
    if distributed:
        out["step_fn"] = trainer.step_fn.__name__
        rac.multilevel_roi_align_cuda.launches = 0
        rac.multilevel_roi_align_adjoint_cuda.launches = 0
        recs = trainer.train(2)
        torch.cuda.synchronize()
        out.update(k1=rac.multilevel_roi_align_cuda.launches,
                   k2=rac.multilevel_roi_align_adjoint_cuda.launches)
    else:
        recs = _emulated_sharded_steps(trainer, batch, 2)
    out["sharded"] = {"records": _stage_records(recs), "after": _param_samples(trainer.model)}
    if distributed:
        out["sharded"]["steps_per_s"] = _rate(trainer.train(14))
    del trainer
    torch.cuda.empty_cache()

    trainer, _ = _stage1_trainer(16, dtype="float32")
    trainer.step_fn = train_step                      # the global-batch step
    recs = trainer.train(2)
    out["global"] = {"records": _stage_records(recs), "after": _param_samples(trainer.model),
                     "wrapped": type(trainer.step_model).__name__}
    if not distributed:
        out["global"]["steps_per_s"] = _rate(trainer.train(14))
    del trainer
    torch.cuda.empty_cache()

    if distributed and dist.get_world_size() == 2:
        buckets: list = []
        hook = pdist.bf16_grad_sync_hook
        pdist.bf16_grad_sync_hook = _recording_bf16_hook(buckets)
        try:
            trainer, _ = _stage1_trainer(16, dtype="float32", grad_sync_dtype="bfloat16")
        finally:
            pdist.bf16_grad_sync_hook = hook
        trainer.train(1)
        out["bf16"] = _check_bf16_buckets(buckets, dist.get_world_size())
        del buckets
        out["bf16"]["steps_per_s"] = _rate(trainer.train(14)[1:])
        del trainer
        torch.cuda.empty_cache()
    out["device"] = str(torch.device("cuda", torch.cuda.current_device()))

    ev = _eval_trainer()
    t0 = time.perf_counter()
    out["eval"] = ev.test()
    out["eval_s"] = time.perf_counter() - t0
    pipe = VideoPipeline(ev.cfg, ev.model, batch_size=8, conf_threshold=0.0,
                         distributed=distributed)
    t0 = time.perf_counter()
    preds = pipe.run(_val_frames())
    out["pipeline_s"] = time.perf_counter() - t0
    out["preds"] = [{f: getattr(p, f) for f in ("boxes", "scores", "classes", "planes",
                                                 "rot_axis", "tran_axis")}
                    | {"mask_px": p.masks.sum(axis=(1, 2))} for p in preds]
    out["depths"] = pipe.depths
    del ev, pipe
    torch.cuda.empty_cache()
    return out


def ranks_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of "[ddp-2]" or "[ddp-cards]" (`chip_smoke.py --ddp-rank R
    WORLD STORE OUT`): `init_distributed` picks NCCL when every rank has
    its own card and gloo otherwise (NCCL refuses two ranks on one device);
    the payload is pickled to OUT/rank{R}.pkl."""
    import pickle

    import torch

    sys.path.insert(0, ROOT)
    from articulation3d_tpu_torch.data.catalog import register_builtin_datasets
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.parallel import barrier, init_distributed, process_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert init_distributed(f"file://{store}", world, rank, timeout_s=600)
    import torch.distributed as dist
    expected = "nccl" if world <= torch.cuda.device_count() else "gloo"
    assert dist.get_backend() == expected and process_count() == world
    rac.build_kernels()
    register_builtin_datasets(os.path.join(ROOT, ".chip_smoke", "datasets"))
    payload = _ranks_payload(distributed=True)
    payload["backend"] = dist.get_backend()
    barrier()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)
    dist.destroy_process_group()
    return 0


def _dicts_agree(a, b) -> float:
    """The largest difference between two evaluator dicts with the same
    keys in the same order (NaN equal to NaN)."""
    assert list(a) == list(b), (list(a), list(b))
    worst = 0.0
    for k in a:
        if isinstance(a[k], dict):
            worst = max(worst, _dicts_agree(a[k], b[k]))
            continue
        x, y = float(a[k]), float(b[k])
        if np.isnan(x) or np.isnan(y):
            assert np.isnan(x) and np.isnan(y), (k, x, y)
            continue
        worst = max(worst, abs(x - y))
    return worst


def phase_ranks(card, world: int, tag: str) -> dict:
    """`world` processes (`ranks_worker`) against this process: two float32
    stage-1 steps at a global batch of 16 split over the ranks, their
    steps/s over 10 more, the two evaluators through `Trainer.test` on phase
    9's arti_val and scannet_val, and `VideoPipeline` on a val clip of 32
    frames.  "[ddp-2]": two ranks on the one card over gloo; "[ddp-cards]":
    one rank per card over NCCL, with more than one card."""
    import pickle
    import shutil

    import torch

    from articulation3d_tpu_torch.data.catalog import register_builtin_datasets

    data_root = os.path.join(ROOT, ".chip_smoke", "datasets")
    if not os.path.isdir(data_root):          # phase 9 writes it in a whole run
        _write_recipe_dataset(data_root)
    out = os.path.join(ROOT, ".chip_smoke", tag)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    store = os.path.join(out, "store")
    env = dict(os.environ)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank",
                               str(r), str(world), store, out], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            _log(log[-8000:])
        assert p.returncode == 0, f"[{tag}] rank {r} exited {p.returncode}"
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    register_builtin_datasets(data_root)
    one = _ranks_payload(distributed=False)

    def agree(step: str) -> tuple:
        loss = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for t in ranks
                   for a, b in zip(t[step]["records"], one[step]["records"]) for k in b)
        params = max(_params_agree(t[step]["after"], one[step]["after"], one["before"])
                     for t in ranks)
        same = all(np.array_equal(ranks[0][step]["after"][n], t[step]["after"][n])
                   for t in ranks[1:] for n in ranks[0][step]["after"])
        return loss, params, same

    sharded, global_ = agree("sharded"), agree("global")
    assert all(t["step_fn"] == "sharded_train_step" for t in ranks)
    assert one["global"]["wrapped"] == "PlaneRCNN"
    assert all(t["global"]["wrapped"] == "DistributedDataParallel" for t in ranks)
    assert all(t["eval"] == {name: {} for name in one["eval"]} for t in ranks[1:])
    eval_err = {name: _dicts_agree(ranks[0]["eval"][name], one["eval"][name])
                for name in one["eval"]}
    n_frames = len(one["preds"])
    box_err = max(float(np.abs(a["boxes"] - b["boxes"]).max()) if len(b["boxes"]) else 0.0
                  for t in ranks for a, b in zip(t["preds"], one["preds"]))
    same_counts = all(len(a["boxes"]) == len(b["boxes"]) and
                      np.array_equal(a["classes"], b["classes"])
                      for t in ranks for a, b in zip(t["preds"], one["preds"]))
    depth_err = max(float(np.abs(a - b).max()) for t in ranks
                    for a, b in zip(t["depths"], one["depths"]))
    per = 16 // world
    where = ("on the one card" if world > torch.cuda.device_count()
             else f"on cards {[t['device'] for t in ranks]}")
    head = (f"[{tag}] {world} processes {where} over {ranks[0]['backend']} ({wall:.1f} s of "
            f"wall for all), configs/step1_bbox.yaml in float32 at a global batch of 16 "
            f"({per} per rank)")
    _log(f"{head}: the Trainer's sharded step against this process's emulation of it (the "
         f"mean of the two halves' gradients): two steps' losses within {sharded[0]:.3e} "
         f"relative (gate 1e-3), parameters after them at {sharded[1]:.4f} of the gate "
         f"(1e-3 x the change + 1e-6 x the magnitude), the replicas equal {sharded[2]}; K1 / "
         f"K2 per rank over the two steps {[(t['k1'], t['k2']) for t in ranks]}; 10 timed "
         f"steps {ranks[0]['sharded']['steps_per_s']:.4f} steps/s = "
         f"{16 * ranks[0]['sharded']['steps_per_s']:.3f} images/s ({card})")
    _log(f"{head}: the global-batch step (train_step) against one process at 16: two steps' "
         f"losses within {global_[0]:.3e} relative (gate 1e-3), parameters at "
         f"{global_[1]:.4f} of the gate, the replicas equal {global_[2]}; one process, 10 "
         f"timed steps {one['global']['steps_per_s']:.4f} steps/s = "
         f"{16 * one['global']['steps_per_s']:.3f} images/s ({card})")
    if world == 2:
        bf = [t["bf16"] for t in ranks]
        _log(f"{head}: solver.grad_sync_dtype bfloat16: the synced buckets bit-equal to "
             f"((g0/2).bfloat16() + (g1/2).bfloat16()).bfloat16().float() of the ranks' "
             f"own buckets {[b['exact'] for b in bf]} ({bf[0]['buckets']} buckets, "
             f"{bf[0]['values']} values; {[b['off_f32'] for b in bf]} of them differ from the "
             f"float32 sync); 10 timed steps {bf[0]['steps_per_s']:.4f} steps/s, float32 "
             f"sync {ranks[0]['sharded']['steps_per_s']:.4f} steps/s ({card})")
        assert all(b["exact"] and b["off_f32"] > 0 and b["buckets"] > 0 for b in bf), bf
    for loss_err, param_ratio, same_replicas in (sharded, global_):
        assert loss_err <= 1e-3 and param_ratio <= 1.0 and same_replicas, (loss_err,
                                                                            param_ratio)
    _log(f"[{tag}] Trainer.test with distributed evaluators (16 images each, split over the "
         f"ranks) against one process: "
         f"{', '.join(f'{n} max diff {e:.3e}' for n, e in eval_err.items())} (NaN where one "
         f"process has NaN); ranks 1.. returned empty dicts; walls: ranks "
         f"{['%.2f' % t['eval_s'] for t in ranks]} s, one process {one['eval_s']:.2f} s "
         f"({card})")
    _log(f"[{tag}] VideoPipeline over the ranks ({n_frames} frames split, batch 8) against one "
         f"process: detections per frame equal {same_counts}, box max err {box_err:.3e} px, "
         f"depth max err {depth_err:.3e} m; walls ranks "
         f"{['%.2f' % t['pipeline_s'] for t in ranks]} s, one process "
         f"{one['pipeline_s']:.2f} s ({card})")
    assert all(e <= 1e-6 for e in eval_err.values()), eval_err
    assert n_frames == 32 and same_counts and box_err <= 1e-3, (box_err, same_counts)
    torch.cuda.empty_cache()
    return dict(sharded=sharded, global_=global_, eval_err=eval_err, box_err=box_err,
                wall=wall, k1=sum(t["k1"] for t in ranks), k2=sum(t["k2"] for t in ranks))


def phase_export_extra(pipe, frames, card) -> dict:
    """"[export-extra]": the rest of export and vis on the CLI's detections
    (frame 0 and 1 of phase 8's clip, at most 10 detections each): the
    RLE-input plane meshes, world transforms, camera and axis primitives,
    the .ply/.obj writers, the webview tilt, `render_img` (render_0.png),
    the normal sphere, the affinity heatmap, the match and box drawing and
    the labelled overlays; the wall of each."""
    from PIL import Image

    from articulation3d_tpu_torch import export, vis
    from articulation3d_tpu_torch.utils.rle import rle_encode

    out = os.path.join(ROOT, ".chip_smoke", "export_extra")
    os.makedirs(out, exist_ok=True)
    preds = pipe.run(frames[:2])
    dets = [p for p in preds]
    top = [np.arange(min(10, len(p))) for p in dets]
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        walls[name] = time.perf_counter() - t0
        return res

    p0 = dets[0]
    segs = [rle_encode(m.astype(np.uint8)) for m in p0.masks[top[0]]]
    meshes, uv_maps = timed("get_single_image_mesh_plane", lambda: export.get_single_image_mesh_plane(
        p0.planes[top[0]], segs, frames[0]))
    cam = {"position": np.array([0.2, 1.5, -0.3]),
           "rotation": np.array([np.cos(0.35), 0.0, np.sin(0.35), 0.0])}
    world = timed("transform_meshes", lambda: export.transform_meshes(meshes, cam))
    planes_w = timed("get_plane_params_in_global",
                     lambda: export.get_plane_params_in_global(p0.planes[top[0]], cam))
    back = timed("get_plane_params_in_local",
                 lambda: export.get_plane_params_in_local(planes_w, cam))
    tilted = timed("rotate_mesh_for_webview", lambda: export.rotate_mesh_for_webview(world))
    cams = timed("get_camera_meshes", lambda: export.get_camera_meshes(
        [{"position": cam["position"], "lookat": [0.0, 0.0, 1.0], "vertical": [0, 1, 0]}]))
    axis = timed("get_axis_mesh", lambda: export.primitives.get_axis_mesh(
        0.02, [0, 0, 1], [0.3, 0.2, 2.0]))
    verts = np.concatenate([m.verts for m in tilted] + [cams[0][0].verts, axis.verts])
    offsets = np.cumsum([0] + [len(m.verts) for m in tilted] + [len(cams[0][0].verts)])
    faces = np.concatenate([m.faces + o for m, o in zip(tilted + [cams[0][0], axis], offsets)])
    colors = np.full((len(verts), 3), 128)
    timed("write_ply", lambda: export.write_ply(verts, colors, faces,
                                                os.path.join(out, "scene.ply")))
    timed("write_obj", lambda: export.write_obj(verts, None, faces,
                                                os.path.join(out, "scene.obj")))
    rendered = timed("render_img", lambda: vis.render_img(out, meshes, uv_maps))
    sphere = timed("get_normal_figure", lambda: vis.get_normal_figure(
        p0.planes[top[0][0]] / max(np.linalg.norm(p0.planes[top[0][0]]), 1e-9),
        [p0.planes[top[0][1:]] / np.maximum(
            np.linalg.norm(p0.planes[top[0][1:]], axis=1, keepdims=True), 1e-9)]))
    b0, b1 = dets[0].boxes[top[0]], dets[1].boxes[top[1]]
    lt = np.maximum(b0[:, None, :2], b1[None, :, :2])
    rb = np.minimum(b0[:, None, 2:], b1[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.maximum(area(b0)[:, None] + area(b1)[None] - inter, 1e-9)
    matching = [int(np.argmax(r)) if r.max() > 0.5 else -1 for r in iou]
    aff = timed("save_affinity_after_stitch", lambda: vis.save_affinity_after_stitch(
        iou, len(b0), len(b1), matching, out))
    pairs = np.asarray([[i, j] for i, j in enumerate(matching) if j >= 0]).reshape(-1, 2)
    match_img = timed("draw_match", lambda: vis.draw_match(
        frames[0][:, :, ::-1].copy(), frames[1][:, :, ::-1].copy(), dets[0].box_centers[top[0]],
        dets[1].box_centers[top[1]], pairs, [1] * len(pairs), factor=1))
    im1, im2 = timed("draw_bbox", lambda: vis.draw_bbox(
        Image.fromarray(frames[0][:, :, ::-1].copy()), Image.fromarray(frames[1][:, :, ::-1].copy()),
        b0.tolist(), b1.tolist(), matching))
    seg = timed("get_labeled_seg", lambda: vis.get_labeled_seg(
        p0, 0.0, vis.ArtiVisualizer(frames[0][:, :, ::-1])))
    gt = {"annotations": [{"bbox": b.tolist(), "bbox_mode": 0, "category_id": 0}
                          for b in b0[:3]]}
    gt_seg = timed("get_gt_labeled_seg", lambda: vis.get_gt_labeled_seg(
        gt, vis.ArtiVisualizer(frames[0][:, :, ::-1])))
    n_faces = sum(len(m.faces) for m in meshes)
    _log(f"[export-extra] on the CLI's detections of frames 0-1 ({len(top[0])} and "
         f"{len(top[1])} of {len(dets[0])} and {len(dets[1])}): {len(meshes)} plane meshes from "
         f"RLE ({n_faces} faces), scene .ply/.obj of {len(verts)} vertices and {len(faces)} "
         f"faces, render_0.png {rendered.shape} with {int((rendered < 255).any(-1).sum())} "
         f"covered pixels, affinity {iou.shape} with {len(pairs)} matches; planes global -> "
         f"local max err {float(np.abs(back - p0.planes[top[0]]).max()):.3e}; walls "
         f"{', '.join(f'{k} {v:.4f} s' for k, v in walls.items())} ({card})")
    assert len(meshes) == len(top[0]) and all(len(m.faces) > 0 for m in meshes)
    assert os.path.getsize(os.path.join(out, "scene.ply")) > 0
    assert os.path.getsize(os.path.join(out, "scene.obj")) > 0
    assert os.path.exists(os.path.join(out, "render_0.png")) and os.path.exists(aff)
    assert rendered.shape == (480, 640, 3) and (rendered < 255).any()
    assert sphere.shape == (480, 640, 3) and (sphere < 250).any()
    assert np.abs(back - p0.planes[top[0]]).max() <= 1e-3 * np.abs(p0.planes[top[0]]).max()
    assert match_img.height == 2 * 480 + 45 and im1.size == (640, 480)
    assert seg.shape == gt_seg.shape == (480, 640, 3)
    return dict(walls=walls)


def phase_goldens(rac, card) -> dict:
    """"[goldens]": a fixture that the port's `save_goldens` writes from its
    own probe on the CPU (configs/config.yaml's model at full width, 480x640,
    phase 3's weights, float32, 200 proposals and 20 detections as the
    fixture's meta config), then the port's `compare_goldens` CLI on the
    card with the gather pooler (the CPU's route) and with the kernel.
    Then the reference oracle's fixtures through both routes on the card,
    at the gates of `tests/test_torch_goldens.py::test_fixture_at_tight_gates`
    (`_oracle_goldens`)."""
    import torch

    from articulation3d_tpu_torch import compare_goldens as cli
    from articulation3d_tpu_torch.evaluation import goldens
    from articulation3d_tpu_torch.models.planercnn import build_model

    out = os.path.join(ROOT, ".chip_smoke", "goldens")
    os.makedirs(out, exist_ok=True)
    image = np.random.RandomState(11).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    meta = {"topk": 200, "dets": 20, "score_thresh": 0.0}
    cfg = cli._config_for({"image": image, **{f"meta_{k}": np.asarray(v)
                                              for k, v in meta.items()}}, "torch")
    sd = _serving_weights(_parity_config())
    t0 = time.perf_counter()
    model = build_model(cfg, device="cpu", state_dict=sd)
    fixture = goldens.goldens_from_probe(model, image, meta)
    t_cpu = time.perf_counter() - t0
    del model
    path = os.path.join(out, "port_480x640.npz")
    goldens.save_goldens(path, fixture)
    weights = os.path.join(out, "weights.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, weights)
    reports, walls = {}, {}
    for pooler in ("torch", "cuda"):
        rac.multilevel_roi_align_cuda.launches = 0
        t0 = time.perf_counter()
        reports[pooler] = cli.main(["--goldens", path, "--weights", weights,
                                    "--pooler", pooler])
        walls[pooler] = time.perf_counter() - t0
        reports[pooler]["k1"] = rac.multilevel_roi_align_cuda.launches
    r, k = reports["torch"], reports["cuda"]
    keys = ("det_match_frac", "det_box_max_err", "det_score_max_err", "masks_max_err",
            "planes_max_err", "feat_p2_max_err", "proposal_top100_match_frac")
    depth_rel = r["depth_max_err"] / max(float(np.abs(fixture["depth"]).max()), 1e-30)
    _log(f"[goldens] fixture from the port's probe on the CPU ({len(fixture['det_boxes'])} "
         f"detections, {len(fixture['proposal_boxes'])} proposals, {t_cpu:.2f} s) against "
         f"the compare_goldens CLI on the card: gather pooler "
         f"{ {key: round(r[key], 6) for key in keys} }, depth max err {depth_rel:.3e} of "
         f"its largest value ({walls['torch']:.2f} s); kernel pooler "
         f"{ {key: round(k[key], 6) for key in keys} } ({walls['cuda']:.2f} s, K1 "
         f"{k['k1']}) ({card})")
    assert r["k1"] == 0 and k["k1"] >= 2, (r["k1"], k["k1"])
    assert r["proposal_top100_match_frac"] == 1.0 and r["det_match_frac"] >= 0.99, r
    assert r["det_box_max_err"] < 0.01 and r["det_score_max_err"] < 1e-3, r
    assert r["masks_max_err"] < 1e-2 and r["planes_max_err"] < 1e-2 and depth_rel < 1e-4, r
    assert k["det_match_frac"] >= 0.9 and k["det_box_max_err"] < 2.0, k
    os.remove(weights)
    return dict(reports=reports, oracle=_oracle_goldens(rac, card, out))


def _oracle_goldens(rac, card, out) -> dict:
    """The committed oracle fixtures (the reference model's outputs on its
    biased weights, seed 0, which the port builds bit for bit as
    `bias_for_detections(random_state_dict(0))`) through the
    `compare_goldens` CLI on the card, with the kernel route and the gather
    route: every top-100 proposal matched, at least 99 % of the
    detections, boxes within 0.01 px, scores within 1e-3, masks and planes
    within 1e-2.  Then `_card_cpu_departure` on the 480x640 fixture."""
    import torch

    from articulation3d_tpu_torch import compare_goldens as cli
    from articulation3d_tpu_torch.weights import bias_for_detections, random_state_dict
    weights = os.path.join(out, "oracle_biased.pth")
    sd = bias_for_detections(random_state_dict(0))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, weights)
    reports = {}
    keys = ("proposal_top100_match_frac", "det_match_frac", "det_ref_count",
            "det_box_max_err", "det_score_max_err", "masks_max_err", "planes_max_err")
    try:
        for name in ("golden_oracle_biased_480x640.npz", "golden_oracle_biased_128x160.npz"):
            path = os.path.join(ROOT, "tests", "fixtures", name)
            for pooler in ("cuda", "torch"):
                rac.multilevel_roi_align_cuda.launches = 0
                t0 = time.perf_counter()
                r = cli.main(["--goldens", path, "--weights", weights, "--pooler", pooler])
                wall = time.perf_counter() - t0
                k1 = rac.multilevel_roi_align_cuda.launches
                _log(f"[goldens] oracle {name} through the {pooler} route on the card: "
                     f"{ {key: round(float(r[key]), 6) for key in keys} } ({wall:.2f} s, K1 "
                     f"{k1}) ({card})")
                assert (k1 >= 2) if pooler == "cuda" else (k1 == 0), (pooler, k1)
                assert r["proposal_top100_match_frac"] == 1.0 and r["det_ref_count"] >= 10, r
                assert r["det_match_frac"] >= 0.99 and r["det_box_max_err"] < 0.01, r
                assert r["det_score_max_err"] < 1e-3, r
                assert r["masks_max_err"] < 1e-2 and r["planes_max_err"] < 1e-2, r
                reports[f"{name}:{pooler}"] = r
    finally:
        os.remove(weights)
    reports["departure"] = _card_cpu_departure(
        os.path.join(ROOT, "tests", "fixtures", "golden_oracle_biased_480x640.npz"), sd, card)
    return reports


def _card_cpu_departure(path, sd, card) -> dict:
    """Where the card's float32 model (kernel route) departs from the
    CPU's on a fixture: per FPN level, max |card - CPU| / max |CPU|; the
    largest box difference of the matched top-100 proposals and of the
    matched detections; and each run's top-100 proposal and detection box
    errors against the fixture.  The card runs three times: with cuDNN's default algorithms
    (the CLI's run), with `cudnn.deterministic`, and with cuDNN off
    (PyTorch's own convolutions).  The features must agree within 1e-5 of
    their largest value (float32 sums in another order); the rest is
    reported, not gated."""
    import torch

    from articulation3d_tpu_torch import compare_goldens as cli
    from articulation3d_tpu_torch.evaluation.goldens import (FEATURE_KEYS, compare_goldens,
                                                             load_goldens, match_detections,
                                                             run_probe)
    from articulation3d_tpu_torch.models.planercnn import build_model

    def boxes(probe):
        d = probe["detections"]
        return (probe["proposal_boxes"][0][probe["proposal_valid"][0]][:100],
                d.boxes[0][d.valid[0]])

    def box_err(a, b, iou):
        ri, oi = match_detections(a, b, iou_thresh=iou)
        return float(np.abs(a[ri] - b[oi]).max()) if len(ri) else float("inf")

    g = load_goldens(path)
    cfg = cli._config_for(g, "cuda")
    model = build_model(cfg, device="cpu", state_dict=sd)
    cpu = run_probe(model, g["image"])
    cpu_err = compare_goldens(g, model)["det_box_max_err"]
    del model
    ref_props = g["proposal_boxes"][:100]
    cpu_prop = box_err(ref_props, boxes(cpu)[0], 0.9)
    _log(f"[goldens] departure on {os.path.basename(path)}: the CPU against the fixture, "
         f"top-100 proposals' boxes {cpu_prop:.6f} px, detections' boxes {cpu_err:.6f} px")
    model = build_model(cfg, device="cuda", state_dict=sd)
    out = {"cpu_proposal_box_max_err": cpu_prop, "cpu_det_box_max_err": cpu_err}
    for setting in ("cudnn default", "cudnn deterministic", "cudnn off"):
        torch.backends.cudnn.deterministic = setting == "cudnn deterministic"
        torch.backends.cudnn.enabled = setting != "cudnn off"
        try:
            probe = run_probe(model, g["image"])
            fix_err = compare_goldens(g, model)["det_box_max_err"]
        finally:
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.enabled = True
        feat = {k: float(np.abs(probe["features"][k] - cpu["features"][k]).max()
                         / np.abs(cpu["features"][k]).max()) for k in FEATURE_KEYS}
        (pc, dc), (pg, dg) = boxes(cpu), boxes(probe)
        row = dict(feat_rel_err=feat, proposal_box_err=box_err(pc, pg, 0.9),
                   det_box_err=box_err(dc, dg, 0.7), det_box_max_err=fix_err,
                   proposal_box_max_err=box_err(ref_props, pg, 0.9))
        _log(f"[goldens] departure, card ({setting}) against the CPU: features max abs err / "
             f"max|CPU| { {k: float('%.3e' % v) for k, v in feat.items()} }, top-100 "
             f"proposals' boxes {row['proposal_box_err']:.6f} px, detections' boxes "
             f"{row['det_box_err']:.6f} px; the card against the fixture, top-100 "
             f"proposals' boxes {row['proposal_box_max_err']:.6f} px, detections' boxes "
             f"{fix_err:.6f} px (gate 0.01) ({card})")
        assert all(v <= 1e-5 for v in feat.values()), (setting, feat)
        out[setting] = row
    return out


def _export_extra_alone(rac, card) -> dict:
    """"[export-extra]" on its own: phase 8's pipeline on the shifted clip."""
    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    cfg = _parity_config()
    pipe = VideoPipeline(cfg, build_model(cfg, state_dict=_serving_weights(cfg)),
                         batch_size=8, conf_threshold=0.0)
    return phase_export_extra(pipe, _shifted_clip(), card)


def _preset_config():
    """The deployment preset `serving_config()` (500 post-NMS proposals, 30
    detections per image) at score threshold 0, as `_parity_config` sets
    it."""
    from articulation3d_tpu_torch.config import serving_config
    cfg = serving_config()
    heads = dataclasses.replace(cfg.model.roi_heads, score_thresh_test=0.0)
    return cfg.replace(model=dataclasses.replace(cfg.model, roi_heads=heads))


def _with_rpn(cfg, **rpn_kw):
    return cfg.replace(model=dataclasses.replace(
        cfg.model, rpn=dataclasses.replace(cfg.model.rpn, **rpn_kw)))


def _contract(parity, preset, frames, card, tag: str) -> dict:
    """The `serving_config` contract on the card: both models on the same
    frames (batches of 8), the RPN survivors per frame and the regime they
    put it in (<= 500: both caps see the same proposals, so the preset's
    detections must be parity's top 30; 501-999: the preset's cap bites;
    >= 1000: both do), and the preset's detections matched against
    parity's at bench.py's on-chip gates (box 0.5 px, score 1e-3, mask
    5e-2): every one in a frame under 500, at least 90 % over the frames
    above it; the depth maps of the two equal within 1e-5."""
    import torch

    from articulation3d_tpu_torch.evaluation.serving_contract import match_detections
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    keys = ("boxes", "scores", "classes", "valid", "masks")
    got = {"parity": [], "preset": []}
    surv, depth_err = [], 0.0
    for i in range(0, len(frames), 8):
        images = preprocess_images(torch.from_numpy(np.stack(frames[i:i + 8])).cuda())
        outs = {}
        for name, model in (("parity", parity), ("preset", preset)):
            out = model.inference(images)
            d = out["detections"]
            got[name].append({k: (getattr(d, k).float() if k == "masks" else getattr(d, k))
                              .cpu().numpy() for k in keys})
            outs[name] = out
        surv += outs["parity"]["proposals"]["valid"].sum(1).tolist()
        s_surv = outs["preset"]["proposals"]["valid"].sum(1).tolist()
        want = [min(n, 500) for n in surv[-len(s_surv):]]
        assert s_surv == want, (s_surv, want)
        a, b = outs["preset"]["depth"], outs["parity"]["depth"]
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        depth_err = max(depth_err, float((a - b).abs().max()))
    cat = {n: {k: np.concatenate([c[k] for c in got[n]]) for k in keys} for n in got}
    regimes = ["fits" if n <= 500 else "preset-saturated" if n < 1000 else "both-saturated"
               for n in surv]
    fits = [f for f, r in enumerate(regimes) if r == "fits"]
    over = [f for f, r in enumerate(regimes) if r != "fits"]
    sel = lambda d, fs: {k: v[fs] for k, v in d.items()}
    gates = dict(box_tol=0.5, score_tol=1e-3, mask_tol=5e-2)
    m = match_detections(cat["preset"], cat["parity"], **gates)
    per_fit = {f: match_detections(sel(cat["preset"], [f]), sel(cat["parity"], [f]), **gates)
               for f in fits}
    m_over = match_detections(sel(cat["preset"], over), sel(cat["parity"], over), **gates) \
        if over else None
    fit_log = {f: f"{r['n_matched']}/{r['n_serving']} matched, {r['n_parity_extra']} left out"
               for f, r in per_fit.items()}
    _log(f"[{tag}] RPN survivors per frame {surv}; regimes {regimes}; matched / preset "
         f"detections {m['n_matched']}/{m['n_serving']} (box <= 0.5 px, score <= 1e-3, "
         f"mask <= 5e-2), max box / score / mask diff {m['max_box_diff']:.4g} / "
         f"{m['max_score_diff']:.3g} / {m['max_mask_diff']:.4g}, parity detections above "
         f"the weakest kept one left out {m['n_parity_extra']}; frames under 500, each: "
         f"{fit_log if fits else 'none'}; frames over: {m_over if m_over else 'none'}; "
         f"depth max diff {depth_err:.3g} ({card})")
    assert m["n_serving"] > 0, m
    for f, r in per_fit.items():
        assert r["n_matched"] == r["n_serving"] and r["n_parity_extra"] == 0, (f, r)
    if m_over:
        assert m_over["n_matched"] >= 0.9 * m_over["n_serving"], m_over
    return dict(survivors=surv, regimes=regimes, matched=m["n_matched"],
                serving=m["n_serving"], extra=m["n_parity_extra"], depth_err=depth_err)


def phase_serving_preset(rac, card) -> dict:
    """"[serving-preset]": the deployment preset `serving_config()` at score
    threshold 0 beside phase 3's parity cell, the same weights
    (`_serving_weights`), the same 16 noise frames, `VideoPipeline` at batch
    8 with the bf16 trunk and the kernel pooler: one warm run of each, then
    parity, preset, parity, preset, each a run of `PRESET_CHUNKS` chunks of
    8 frames (the 16 frames and more noise frames after them), with the
    frames/s of its warm chunks (all but the first), the spread of their
    walls, peak memory and K1 launches, and one warm step of each under the
    profiler (`_profile_step`).  Then, at the preset's own pool inputs
    (box 7x7 at 500 ROIs per image, mask and plane 14x14 at 30) and
    parity's (1000 and 100), K1's record against `_prepare`, K1 against
    its plain version, its time alone and the wrapper's beside the plain
    version and the bound.  Then the contract (`_contract`) on those frames,
    and once more with 100 proposals per level before NMS, where no frame
    can have more than 500 survivors."""
    import torch

    from articulation3d_tpu_torch.models.planercnn import build_model
    from articulation3d_tpu_torch.ops.preprocess import preprocess_images
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    cfgs = {"parity": _parity_config(), "preset": _preset_config()}
    sd = _serving_weights(cfgs["parity"])
    models = {n: build_model(c, state_dict=sd) for n, c in cfgs.items()}
    pipes = {n: VideoPipeline(cfgs[n], m, batch_size=8, conf_threshold=0.0)
             for n, m in models.items()}
    rs = np.random.RandomState(0)
    stream = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
              for _ in range(8 * PRESET_CHUNKS)]
    frames = stream[:16]
    for pipe in pipes.values():
        pipe.run(frames)
    runs = {"parity": [], "preset": []}
    launches = {"parity": 0, "preset": 0}
    for name in ("parity", "preset", "parity", "preset"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rac.multilevel_roi_align_cuda.launches = 0
        t0 = time.perf_counter()
        preds = pipes[name].run(stream)
        run_wall = time.perf_counter() - t0
        k1 = rac.multilevel_roi_align_cuda.launches
        assert k1 == 3 * PRESET_CHUNKS, (name, k1)
        assert len(preds) == len(stream) and all(len(p) > 0 for p in preds)
        cap = cfgs[name].model.roi_heads.detections_per_image
        assert all(len(p) <= cap for p in preds)
        for pr in preds:
            for a in (pr.boxes, pr.scores, pr.planes, pr.rot_axis, pr.tran_axis):
                assert np.isfinite(a).all()
        per_frame = [len(p) for p in preds[:4]]
        del preds
        warm = np.asarray(pipes[name].chunk_walls[1:])
        fps = 8 * len(warm) / float(warm.sum())
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[name] += k1
        runs[name].append(dict(fps=fps, wall_min=float(warm.min()),
                               wall_median=float(np.median(warm)), wall_max=float(warm.max()),
                               run_fps=len(stream) / run_wall, peak_gib=peak))
        _log(f"[serving-preset] {name}: {len(warm)} warm chunks of 8 frames, {fps:.2f} "
             f"frames/s; chunk wall min / median / max {warm.min():.4f} / "
             f"{np.median(warm):.4f} / {warm.max():.4f} s; the whole run of {len(stream)} "
             f"frames with the host's unpacking {len(stream) / run_wall:.2f} frames/s; "
             f"detections per frame {per_frame}..., peak {peak:.3f} GiB "
             f"({base / 2**30:.3f} GiB before the run), K1 launches {k1}, valid ROIs per "
             f"pool stage {pipes[name].pool_valid} ({card})")

    for name, pipe in pipes.items():
        _profile_step(pipe, frames[:8], card, f"serving-preset-profile-{name}")

    pools = {}
    for name, model in models.items():
        captured = []
        pool = model._pool

        def recording_pool(roi_feats, boxes, _pool=pool, _into=captured, **kw):
            _into.append((roi_feats, boxes, kw))
            return _pool(roi_feats, boxes, **kw)

        model._pool = recording_pool
        try:
            with torch.no_grad():
                model.inference(preprocess_images(torch.from_numpy(np.stack(frames[8:])).cuda()))
        finally:
            del model._pool
        err = _main_path_err(rac, captured, f"serving-preset-{name}-pools")
        for (roi_feats, boxes, kw), stage in zip(captured, ("box", "mask", "plane")):
            p, sr, al, valid = kw["resolution"], kw["sampling_ratio"], kw["aligned"], kw["valid"]
            args = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=al,
                        valid=valid)
            n_rec, cells = _check_record(rac, roi_feats, boxes, valid, p, sr, al)
            ms = _time_ms(lambda: rac.multilevel_roi_align_cuda(roi_feats, boxes, **args))
            kern = _time_kernel(rac, roi_feats, boxes, valid, p, sr, al)
            plain = _time_ms(lambda: rac.multilevel_roi_align_separable(roi_feats, boxes,
                                                                        **args),
                             iters=3, warmup=1)
            bound, by = _bound(rac, roi_feats, boxes, valid, p, sr, al)
            _log(f"[serving-preset] {name} {stage:5s} pool P={p:2d} rois="
                 f"{boxes.shape[0] * boxes.shape[1]} valid={int(valid.sum())} "
                 f"{str(roi_feats[0].dtype)[6:]}: wrapper {ms:.4f} ms (kernel alone "
                 f"{kern:.4f} ms), plain {plain:.4f} ms, bound {bound:.4f} ms by {by}; "
                 f"kernel/bound {kern / bound:.2f}x; record == _prepare on {n_rec} ROIs; "
                 f"{cells} ({card})")
            pools[f"{name}_{stage}"] = dict(ms=ms, kernel_ms=kern, plain_ms=plain,
                                            bound_ms=bound, bound_by=by, err=err,
                                            rois=int(boxes.shape[0] * boxes.shape[1]))
        del captured

    contract = _contract(models["parity"], models["preset"], frames, card,
                         "serving-preset-contract")
    del models, pipes
    small = {n: build_model(_with_rpn(c, pre_nms_topk_test=100), state_dict=sd)
             for n, c in cfgs.items()}
    fits = _contract(small["parity"], small["preset"], frames, card,
                     "serving-preset-contract-pre100")
    assert set(fits["regimes"]) == {"fits"}, fits["regimes"]
    del small
    torch.cuda.empty_cache()
    fps = {n: [r["fps"] for r in runs[n]] for n in runs}
    spread = {n: (max(v) - min(v)) / min(v) for n, v in fps.items()}
    ratios = [b / a for a, b in zip(fps["parity"], fps["preset"])]
    _log(f"[serving-preset] frames/s over {PRESET_CHUNKS - 1} warm chunks per turn, in turns "
         f"parity {fps['parity']} / preset {fps['preset']}: spread between a side's turns "
         f"parity {100 * spread['parity']:.1f} % / preset {100 * spread['preset']:.1f} %; "
         f"preset/parity per pair {['%.3f' % r for r in ratios]}; "
         f"K1 preset box / mask / plane kernel {pools['preset_box']['kernel_ms']:.4f} / "
         f"{pools['preset_mask']['kernel_ms']:.4f} / {pools['preset_plane']['kernel_ms']:.4f} ms "
         f"against parity {pools['parity_box']['kernel_ms']:.4f} / "
         f"{pools['parity_mask']['kernel_ms']:.4f} / {pools['parity_plane']['kernel_ms']:.4f} "
         f"ms ({card})")
    return dict(k1=launches["preset"], k1_parity=launches["parity"], runs=runs, pools=pools,
                err=max(v["err"] for v in pools.values()), contract=contract,
                contract_pre100=fits)


PROFILE_BATCH = 8                   # frames per batch of the inference and depth tables
PROFILE_TRAIN = ((1, 16), (3, 8))   # (stage, ims) of the training tables


def _expected_calls(table: str, name: str) -> tuple:
    """(K1 called, K2 called) in a run of the row `name` of a
    "[profile-stages]" table: K1 in every pool of the kernel route, K2 in
    its backward where gradient reaches the features (stage 3 freezes the
    trunk, so its loss and step rows send none)."""
    if "gather" in name or table == "depth":
        return (False, False)
    if table.startswith("inference"):
        return (name not in ("backbone+fpn", "+rpn (proposals)"), False)
    k1 = "kernel" in name or name.startswith(("loss", "full step"))
    k2 = "fwd+bwd (kernel)" in name or (
        table == "train-1" and name.startswith(("loss fwd+bwd", "full step")))
    return (k1, k2)


class _StageProbe:
    """The `around` hook that "[profile-stages]" hands a profiler's `main()`
    (`profiling.time_rows`).  For each row: K1's and K2's calls per timed
    run (their wrappers' counters), then one more run under torch.profiler
    (kernel launches, device busy time, K1's and K2's device time, as far
    as the profiler records them: on the card it has dropped every kernel
    of some runs of a few milliseconds, so these are lower bounds) that
    also keeps the row's pool inputs (`_record_pools`).  K1 is held against
    its plain version on those inputs (`_pools`), and the training
    pool rows' kernel route against their gather route: the pooled ROIs
    within 1e-5 x max|gather| (K1's float32 tolerance), the gradients to
    p2..p5 within 1e-4 x max|gather| per level (K2's)."""

    def __init__(self, rac, card, tag: str, steps: int):
        self.rac, self.card, self.tag = rac, card, tag
        self.runs = steps + 2                   # `time_fn`'s two warm runs and `steps`
        self.rows, self.k1, self.k2, self.err1, self.err2 = {}, 0, 0, 0.0, 0.0
        self.kernel_pool = {}                   # train pool outputs of the kernel route

    def __call__(self, name, fn, timed) -> float:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from articulation3d_tpu_torch.profiling import reduce_sum
        fwd, adj = self.rac.multilevel_roi_align_cuda, self.rac.multilevel_roi_align_adjoint_cuda
        c1, c2 = fwd.launches, adj.launches
        dt = timed()
        d1, d2 = fwd.launches - c1, adj.launches - c2
        assert d1 % self.runs == 0 and d2 % self.runs == 0, (self.tag, name, d1, d2)
        pools = _record_pools(16)
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                reduce_sum(out).item()
                wall_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
        finally:
            pools.restore()
        self.k1 += fwd.launches - c1
        self.k2 += adj.launches - c2
        busy, by_name, n = _device_time(prof)
        k_ms = {k: sum(v for key, v in by_name.items() if f"roi_align_{k}" in key) / 1e3
                for k in ("fwd", "adj")}
        row = dict(name=name, ms=dt * 1e3, k1=d1 // self.runs, k2=d2 // self.runs,
                   kernels=n, busy_ms=busy / 1e3, profiled_wall_ms=wall_ms,
                   k1_ms=k_ms["fwd"], k2_ms=k_ms["adj"], pools=len(pools.calls))
        _log(f"[{self.tag}] {name:<36} {row['ms']:10.3f} ms/step; one more run under the "
             f"profiler: {n} kernels, device busy {row['busy_ms']:.3f} ms of "
             f"{wall_ms:.3f} ms, K1 {row['k1_ms']:.3f} ms, K2 {row['k2_ms']:.3f} ms; "
             f"calls per run K1 {row['k1']} K2 {row['k2']} ({self.card})")
        if d1 and pools.calls:
            self.err1 = max(self.err1, self._pools(name, pools.calls))
        if name.startswith("train pool fwd+bwd"):
            self.err2 = max(self.err2, self._pool_routes(name, out))
        elif name.startswith("train pool"):
            self.err1 = max(self.err1, self._pool_routes(name, out))
        self.rows[name] = row
        return dt

    def _pools(self, name: str, calls) -> float:
        """K1 against its plain version on the row's pool inputs, then on
        those of them with an invalid slot once more with every slot valid:
        the cascade pools the detections above the score threshold, and at
        the profilers' weights there may be none."""
        valid = [None if kw.get("valid") is None else int(kw["valid"].sum())
                 for _, _, kw in calls]
        _log(f"[{self.tag}] {name}: valid ROIs per pool {valid} of "
             f"{[int(b.shape[0] * b.shape[1]) for _, b, _ in calls]}")
        err = _main_path_err(self.rac, calls, f"{self.tag} {name}")
        partial = [(f, b, dict(kw, valid=None)) for f, b, kw in calls
                   if kw.get("valid") is not None and not bool(kw["valid"].all())]
        if partial:
            err = max(err, _main_path_err(self.rac, partial,
                                          f"{self.tag} {name}, every slot valid"))
        return err

    def _pool_routes(self, name: str, out) -> float:
        key = "fwd+bwd" if "fwd+bwd" in name else "fwd"
        if "(kernel" in name:
            self.kernel_pool[key] = out
            return 0.0
        got = self.kernel_pool.pop(key)
        pairs = [(got, out)] if key == "fwd" else list(zip(got, out))
        tol = 1e-5 if key == "fwd" else 1e-4
        errs = []
        for a, b in pairs:
            e, scale = float((a - b).abs().max()), float(b.abs().max())
            assert e <= tol * scale, (self.tag, name, e, tol * scale)
            errs.append(e)
        _log(f"[{self.tag}] {name}: the kernel route against this gather route, max abs "
             f"err {['%.3e' % e for e in errs]} (tol {tol} x max|gather|: "
             f"{['%.3e' % (tol * float(b.abs().max())) for _, b in pairs]})")
        return max(errs)


def phase_profile_stages(rac, card) -> dict:
    """18. "[profile-stages]": the port's three stage profilers on the card
    through their CLIs' `main()` (module docstring), each with a
    `_StageProbe` around its rows; the tables are the CLIs' own, headed
    with the card's name and power limit.  Returns the phase's K1 and K2
    launches (the timed and profiled runs, not the comparisons) and their
    largest errors against the plain versions."""
    import torch

    from articulation3d_tpu_torch import profile_depth, profile_inference, profile_train

    t0 = time.perf_counter()
    b = str(PROFILE_BATCH)
    runs = [("inference-parity", profile_inference, ["--preset", "parity", "--batch", b], 5),
            ("inference-serving", profile_inference, ["--preset", "serving", "--batch", b], 5),
            ("depth", profile_depth, ["--batch", b], 5)]
    runs += [(f"train-{stage}", profile_train, ["--stage", str(stage), "--ims", str(ims)], 3)
             for stage, ims in PROFILE_TRAIN]
    k1 = k2 = 0
    err1 = err2 = 0.0
    for table, cli, argv, steps in runs:
        tag = f"profile-stages {table}"
        probe = _StageProbe(rac, card, tag, steps)
        t_table = time.perf_counter()
        rows = cli.main(argv + ["--steps", str(steps)], around=probe)
        torch.cuda.empty_cache()
        missing = [(name, why) for name, dt, why in rows if dt is None]
        assert not missing, (tag, missing, card)
        assert [r[0] for r in rows] == list(probe.rows), (tag, rows, list(probe.rows))
        for name, r in probe.rows.items():
            calls = (r["k1"] > 0, r["k2"] > 0)
            assert calls == _expected_calls(table, name), (tag, name, r["k1"], r["k2"])
        assert not probe.kernel_pool, (tag, list(probe.kernel_pool))
        k1, k2 = k1 + probe.k1, k2 + probe.k2
        err1, err2 = max(err1, probe.err1), max(err2, probe.err2)
        _log(f"[{tag}] table wall {time.perf_counter() - t_table:.1f} s")
    _log(f"[profile-stages] K1 {k1} and K2 {k2} launches in the phase's timed and profiled "
         f"runs; largest error K1 {err1:.3e}, K2 {err2:.3e}; phase wall {time.perf_counter() - t0:.1f} s "
         f"({card})")
    return dict(k1=k1, k2=k2, err1=err1, err2=err2)


PHASES = {"parity": lambda rac, card: (phase_kernel_parity(rac), phase_adjoint_parity(rac)),
          "oracle-rois": phase_oracle_rois, "f1": lambda rac, card: phase_f1(rac),
          "train-parity": lambda rac, card: phase_training_parity(
              rac, {"batch": _train_batch(_stage1_config(), 16)}),
          "refine-serve": phase_refine_serve,
          "refine-train": phase_refine_train, "drpn": phase_drpn,
          "ddp-1": lambda rac, card: phase_ddp1(rac, card, {"steps_per_s": float("nan")}),
          "ddp-2": lambda rac, card: phase_ranks(card, 2, "ddp-2"),
          "remat": lambda rac, card: phase_remat(rac, card, {"steps_per_s": float("nan")}),
          "ddp-cards": lambda rac, card: phase_ranks(card, _cards(), "ddp-cards"),
          "export-extra": _export_extra_alone, "goldens": phase_goldens,
          "serving-preset": phase_serving_preset, "profile-stages": phase_profile_stages}


def _cards() -> int:
    """The number of cards "[ddp-cards]" spreads its ranks over (two or
    more)."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit("chip_smoke.py: [ddp-cards] needs more than one card")
    return n


def _only_phases() -> list:
    """The phases named by `--only a,b,...` (none: the whole script)."""
    args = sys.argv[1:]
    if not args:
        return []
    if len(args) != 2 or args[0] != "--only":
        raise SystemExit("usage: chip_smoke.py [--only parity,oracle-rois,f1,train-parity,"
                         "refine-serve,refine-train,drpn,ddp-1,ddp-2,remat,ddp-cards,"
                         "export-extra,goldens,serving-preset,profile-stages]")
    names = args[1].split(",")
    bad = [n for n in names if n not in PHASES]
    if bad:
        raise SystemExit(f"chip_smoke.py: unknown phases {bad}; known {sorted(PHASES)}")
    return names


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ranks_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
