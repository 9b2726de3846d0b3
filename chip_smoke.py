#!/usr/bin/env python3
"""The port's kernel bench: each hand-written CUDA kernel of
`articulation3d_tpu_torch` timed alone on one NVIDIA GPU, beside its plain
torch version and its least time on an H100.  Run from the root of a
checkout, on a machine with a card; it takes no arguments:

    python3 chip_smoke.py

It builds K1 (csrc/roi_align_fwd.cu), K2 (csrc/roi_align_adj.cu) and K4
(csrc/nms.cu), one nvcc each, and prints ptxas's report of each one it
builds (a fresh checkout builds all three); then
times, with CUDA events over 10 calls after 2 warm ones (3 after 1 for the
plain versions), the kernel alone (its launch into preallocated outputs),
its wrapper (`multilevel_roi_align_cuda`, `multilevel_roi_align_adjoint_cuda`,
`nms_mask`) and its plain version, and holds the wrapper's answer against
the plain version's on the same tensors (`max_abs_err`; K1 within 1e-5,
or 1e-2 on bfloat16 maps, of max |plain|, K2 within 1e-4, K4's keep masks
bit-equal: the card tests' limits), at:

  * K1's serving pools at a batch of 8 (box 7x7 over 1000 proposals an
    image, mask and plane 14x14 over 100 detections), and the same pools
    of the serving preset `serving_config()` (500 and 30): the pool inputs
    of the `infer_stream_b1` cell's model, drawn by portbench from seed 0,
    on 8 of the cell's frames, through the cell's entry `VideoPipeline.run`;
  * K1 and K2 at the training box pool (16 x 512 ROIs, float32 maps): its
    inputs in one step of the `train_s1_ims16` cell (seed 0), with a random
    cotangent;
  * K1 (bfloat16 maps) and K2 (float32) at the reference oracle's 1000
    proposals on its 480x640 fixture (mostly slivers), repeated over 8
    images, at each pool's options;
  * K4 at the training RPN's sets (16 x 5 of 2000, from that step), the
    inference RPN's (5 of 1000) and the class NMS's (one of 2000), from one
    frame of the inference cell.

Bounds are the benchmark's: `portbench/counts/roi_align.py` for K1,
`portbench/counts/roi_align_adj.py` for K2, and for K4 the boxes read and
the keep mask written once at the HBM rate of `portbench/peaks.py` (its
real bound is the serial walk over each set's rows).  The runs it takes
the inputs from are recorded (`tracing.recording()`): each kernel's
launches on each path ("inference", "serving_preset": one `run` of 8
frames; "inference_b1": one of the cell's own calls of one frame;
"training": one step), and each path must launch its kernels.  The card
tests (`tests/test_torch_roi_align_cuda.py`, `tests/test_torch_nms_cuda.py`,
with `-m cuda --noconftest`) check the kernels at many more shapes.  TF32
is off.  The last line is the kernels' JSON; a failed check exits 1 after
it.  Exits 2 without a result where there is no CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STRIDES = (4, 8, 16, 32)
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


@contextlib.contextmanager
def _calls(owner, name: str):
    """The arguments of every call of `owner.name` inside the block."""
    orig, seen = getattr(owner, name), []

    def rec(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    setattr(owner, name, rec)
    try:
        yield seen
    finally:
        setattr(owner, name, orig)


def _gap(got, want, rel: float) -> tuple:
    """(max |got - want| over the tensor pairs, `rel` x max |want|)."""
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    return err, rel * max(float(b.abs().max()) for b in want)


def _row(tag: str, shape: str, card: str, **t) -> dict:
    bound = t["bound_ms"]
    _log(f"[{tag}] {shape:13s} " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in t.items())
        + f"; kernel/bound {t['kernel_ms'] / bound:.2f}x ({card})")
    return t


def _k1(rac, feats, boxes, valid, p, sr, aligned) -> dict:
    """K1 alone, its wrapper and its plain version on one pool's inputs,
    and the pool's bound (`counts/roi_align.py`)."""
    import torch

    from portbench.counts import roi_align as counts
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    kboxes, kvalid = rac._kernel_boxes(boxes, valid, p)
    total = boxes.shape[0] * boxes.shape[1]
    c = feats[0].shape[-1]
    out = torch.empty((total, p, p, c), dtype=torch.float32, device=boxes.device)
    record = torch.empty((total, 5), dtype=torch.int32, device=boxes.device)
    launch = dict(opts, min_level=2)
    kernel = _time_ms(lambda: rac._launch(feats, kboxes, kvalid, launch, record, out))
    wrapper = _time_ms(lambda: rac.multilevel_roi_align_cuda(feats, boxes, valid=valid, **opts))
    plain = _time_ms(lambda: rac.multilevel_roi_align_separable(feats, boxes, valid=valid,
                                                                **opts), iters=3, warmup=1)
    err, tol = _gap([rac.multilevel_roi_align_cuda(feats, boxes, valid=valid, **opts)],
                    [rac.multilevel_roi_align_separable(feats, boxes, valid=valid, **opts)],
                    1e-5 if feats[0].dtype == torch.float32 else 1e-2)
    v = (np.ones(boxes.shape[:2], bool) if valid is None else valid.cpu().numpy())
    bound, by = counts.bound_seconds([f.shape[1:3] for f in feats], boxes.cpu().numpy(), v, p,
                                     sr, aligned, channels=c, in_bytes=feats[0].element_size())
    return dict(rois=total, valid=int(v.sum()), dtype=str(feats[0].dtype)[6:],
                kernel_ms=kernel, wrapper_ms=wrapper, plain_ms=plain, bound_ms=bound * 1e3,
                bound_by=by, max_abs_err=err, tol=tol)


def _k2(rac, feats, boxes, valid, g, p, sr, aligned) -> dict:
    """K2 alone, its wrapper and its plain version on one pool's inputs and
    cotangent `g` (T, P, P, C), and the pool's bound
    (`counts/roi_align_adj.py`)."""
    import torch

    from portbench.counts import roi_align_adj as counts
    opts = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    shapes = [f.shape for f in feats]
    _, record = rac._forward_kernel(feats, boxes, valid, dict(opts, min_level=2))
    kboxes, _ = rac._kernel_boxes(boxes, None, p)
    grads = [torch.zeros(s, dtype=torch.float32, device=boxes.device) for s in shapes]
    launch = dict(opts, min_level=2)
    kernel = _time_ms(lambda: rac._launch_adj(g, kboxes, record, launch, grads))
    wrapper = _time_ms(lambda: rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record,
                                                                     **opts))
    pr = rac._prepare(shapes, boxes, valid=valid, **opts)
    plain = _time_ms(lambda: rac.multilevel_roi_align_adjoint_separable(g, shapes, pr),
                     iters=3, warmup=1)
    err, tol = _gap(rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **opts),
                    rac.multilevel_roi_align_adjoint_separable(g, shapes, pr), 1e-4)
    v = (np.ones(boxes.shape[:2], bool) if valid is None else valid.cpu().numpy())
    bound, by = counts.bound_seconds([s[1:3] for s in shapes], boxes.cpu().numpy(), v, p, sr,
                                     aligned, channels=shapes[0][-1])
    return dict(rois=int(record.shape[0]), valid=int(v.sum()), kernel_ms=kernel,
                wrapper_ms=wrapper, plain_ms=plain, bound_ms=bound * 1e3, bound_by=by,
                max_abs_err=err, tol=tol)


def _k4(nms, boxes, scores, valid, t) -> dict:
    """K4's pair of kernels alone (the sort done), its wrapper (sort and
    kernels) and its plain version on one call's sets, and the bound of
    reading 16 B of box and writing a byte of keep mask per row."""
    from portbench.peaks import HBM_BYTES_PER_S
    order = nms._order(scores, valid)
    kernel = _time_ms(lambda: nms._nms_cuda(boxes, valid, order, t))
    wrapper = _time_ms(lambda: nms.nms_mask(boxes, scores, valid, t))
    plain = _time_ms(lambda: nms.nms_mask_sweep(boxes, scores, valid, t), iters=3, warmup=1)
    keep = nms.nms_mask(boxes, scores, valid, t)
    differ = int((keep != nms.nms_mask_sweep(boxes, scores, valid, t)).sum())
    n = boxes.shape[-2]
    sets = valid.numel() // n
    return dict(sets=sets, n=n, valid=int(valid.sum()), kept=int(keep.sum()), kernel_ms=kernel,
                wrapper_ms=wrapper, plain_ms=plain,
                bound_ms=sets * n * (16 + 1) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                differ=differ, max_abs_err=float(differ > 0), tol=0.0)


def _pool_args(call) -> tuple:
    """(features, boxes, valid, P, ratio, aligned) of a `PlaneRCNN._pool`
    call."""
    (_, feats, boxes), kw = call
    return ([f.detach() for f in feats], boxes.detach(), kw["valid"], kw["resolution"],
            kw["sampling_ratio"], kw["aligned"])


def _inference_cell(dev):
    """The `infer_stream_b1` cell's model (its configuration, portbench's
    weights from seed 0, calibrated on the cell's first frames) behind
    `VideoPipeline`s: the cell's own (a batch of 1), one at a batch of 8,
    and one of the same weights under the serving preset's caps at a batch
    of 8; and 8 of the cell's frames."""
    import torch

    from articulation3d_tpu_torch.config import serving_config
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    from portbench import spec
    from portbench.drivers import video_infer
    ctx = spec.context(spec.benchmark(), "infer_stream_b1", 0, 0.0, False, dev,
                       time.perf_counter())
    st = video_infer.build(ctx)
    cfg, model = st["cfg"], st["model"]
    caps = serving_config().model
    preset_cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, rpn=dataclasses.replace(cfg.model.rpn,
                                           post_nms_topk_test=caps.rpn.post_nms_topk_test),
        roi_heads=dataclasses.replace(cfg.model.roi_heads,
                                      detections_per_image=caps.roi_heads.detections_per_image)))
    with torch.device(dev):
        preset = PlaneRCNN(preset_cfg)
    preset.load_state_dict(model.state_dict())
    pipes = {"inference_b1": st["pipeline"],
             "inference": VideoPipeline(cfg, model, batch_size=8, device=dev),
             "serving_preset": VideoPipeline(preset_cfg, preset, batch_size=8, device=dev)}
    return pipes, list(st["pool"][:8])


def _training_cell(dev, out: str):
    """One step of the `train_s1_ims16` cell (seed 0), recorded: the box
    pool's inputs, the RPN's NMS call and the step's counters."""
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.models import rpn as rpn_mod
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from portbench import spec
    from portbench.drivers import train_step
    ctx = spec.context(spec.benchmark(), "train_s1_ims16", 0, 0.0, False, dev,
                       time.perf_counter())
    trainer = train_step.build(ctx, out)["trainer"]
    trainer.train(1)                                        # warm: cuDNN, the kernels
    with _calls(PlaneRCNN, "_pool") as pools, _calls(rpn_mod, "nms_mask") as sets, \
            tracing.recording() as rec:
        trainer.train(2)
    return _pool_args(pools[0]), sets[0], rec.counters


def main() -> int:
    if sys.argv[1:]:
        print("chip_smoke.py takes no arguments", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.models import rpn as rpn_mod
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from articulation3d_tpu_torch.ops import cuda_build, nms
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.profiling import device_label

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = device_label(dev)
    _log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = cuda_build.build_kernels(verbose=True)
    _log(f"[build] {[os.path.relpath(v, ROOT) for v in libs.values()]} in "
         f"{time.perf_counter() - t0:.1f}s")
    k1, k2, k4 = {}, {}, {}
    launches = {}                       # path -> the recorder's counters

    pipes, frames = _inference_cell(dev)
    for name in ("inference", "serving_preset"):
        with _calls(PlaneRCNN, "_pool") as pools, tracing.recording() as rec:
            pipes[name].run(frames)
        launches[name] = rec.counters
        for stage, call in zip(("box", "mask", "plane"), pools):
            k1[f"{name}_{stage}"] = _row("k1", f"{name}_{stage}", card,
                                         **_k1(rac, *_pool_args(call)))
    with _calls(rpn_mod, "nms_mask") as rpn_sets, _calls(nms, "nms_mask") as class_sets, \
            tracing.recording() as rec:
        pipes["inference_b1"].run(frames[:1])
    launches["inference_b1"] = rec.counters
    del pipes, frames
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        (feats, boxes, valid, p, sr, al), train_rpn, launches["training"] = \
            _training_cell(dev, out)
    k1["training_box"] = _row("k1", "training_box", card, **_k1(rac, feats, boxes, valid, p,
                                                                sr, al))
    g = torch.randn((boxes.shape[0] * boxes.shape[1], p, p, feats[0].shape[-1]), device=dev)
    k2["training_box"] = _row("k2", "training_box", card, **_k2(rac, feats, boxes, valid, g, p,
                                                                sr, al))
    del feats, boxes, valid, g
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(3)
    feats32 = [torch.randn((8, h, w, 256), generator=gen, device=dev)
               for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    oracle = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_oracle_biased_480x640.npz"))
    boxes = torch.from_numpy(np.repeat(oracle["proposal_boxes"].astype(np.float32)[None], 8,
                                       axis=0)).to(dev)
    for pool, (p, sr, al) in POOLS.items():
        k1[f"oracle_{pool}"] = _row("k1", f"oracle_{pool}", card,
                                    **_k1(rac, feats16, boxes, None, p, sr, al))
        g = torch.randn((8 * boxes.shape[1], p, p, 256), generator=gen, device=dev)
        k2[f"oracle_{pool}"] = _row("k2", f"oracle_{pool}", card,
                                    **_k2(rac, feats32, boxes, None, g, p, sr, al))
    del feats32, feats16, g
    torch.cuda.empty_cache()

    for name, (args, _) in (("train_rpn", train_rpn), ("infer_rpn", rpn_sets[0]),
                            ("class_nms", class_sets[0])):
        k4[name] = _row("k4", name, card, **_k4(nms, *args))

    kernels = []
    for name, counter, shapes, src, replaces in (
            ("roi_align_fwd", "k1", k1, "roi_align_fwd.cu", "roi_align_pallas.py:184"),
            ("roi_align_adj", "k2", k2, "roi_align_adj.cu", "roi_align_pallas.py:519"),
            ("nms", "nms", k4, "nms.cu", None)):
        by_path = {path: c.get(f"{counter}.launches", 0) for path, c in launches.items()}
        _log(f"[launches] {counter}: {by_path}")
        kernels.append({
            "name": name, "source": f"articulation3d_tpu_torch/csrc/{src}",
            "replaces": replaces and f"articulation3d_tpu/ops/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(t["max_abs_err"] for t in shapes.values()),
            "library_ms": None, "shapes": shapes})
    # each main path launches its kernels; each wrapper agrees with its plain version
    failed = [f"{k}:{s}" for k, shapes in (("k1", k1), ("k2", k2), ("k4", k4))
              for s, t in shapes.items() if not t["max_abs_err"] <= t["tol"]]
    failed += [f"{c} not launched on {path}" for c, paths in (
        ("k1", ("inference", "serving_preset", "inference_b1", "training")),
        ("k2", ("training",)), ("nms", ("inference_b1", "training")))
        for path in paths if not launches[path].get(f"{c}.launches", 0)]
    for f in failed:
        print(f"chip_smoke: FAILED {f}", file=sys.stderr, flush=True)
    print(json.dumps({"device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "label": card, "count": torch.cuda.device_count()},
                      "ok": not failed, "kernels": kernels}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
