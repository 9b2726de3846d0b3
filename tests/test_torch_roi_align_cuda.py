"""The ROIAlign CUDA kernels (K1 forward, K2 adjoint) and the training
pooler built from them (K3) against their plain torch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit (from the repository root):

    python -m pytest tests/test_torch_roi_align_cuda.py --noconftest -m cuda -q

Elsewhere each test skips itself.  K1's record (level, y0, x0, ny, nx),
computed on the card by its fused prologue, must equal torch `_prepare`
and `_roi_record` on the card exactly, with every ROI on detectron2's
level (the 9:1 sliver that the JAX Pallas kernel moves to p3 stays on p2).  Tolerances: float32 1e-5 x max |out|
(the same float32 sums in another order); bfloat16 1e-2 x max |out| (the
stated bf16 budget; kernel and plain version read the same bf16 features
with float32 weights).  Invalid ROIs must give exact zeros.  K2 adds with
float32 atomics in a varying order: within 1e-4 x max |plain|, and the
transpose identity <K1(F), G> = <F, K2(G)> summed in float64 within 1e-5
relative.

Cases (`CASES`): 64 random boxes and the two 9:1 slivers on one 480x640
pyramid (C 256) at each pool; the main path's sizes, a pyramid of two
images with 1000 box-pool ROIs (7x7, V2, ratio 0) or 100 mask (14x14,
ratio 2) or plane (14x14, ratio 0) ROIs per image, a fifth of them
invalid; the 5:1 and 9:1 box sets; the reference oracle's 1000 proposals
on its 480x640 fixture (mostly slivers) at each pool; and ROIs whose bins
take 5 to 23 samples (uncapped, as served), at the box and plane pools.
"""

import os

import numpy as np
import pytest
import torch

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.ops import roi_align_cuda as rac
from articulation3d_tpu_torch.ops.roi_align import sample_counts
from torch_checks import POOLS, STRIDES, check_record

LEVELS = ((120, 160), (60, 80), (30, 40), (15, 20))          # p2..p5 at 480x640
CASES = ([("random64", pool) for pool in POOLS]
         + [("full", pool) for pool in POOLS]
         + [("aspect5", "box"), ("aspect9", "box")]
         + [("oracle", pool) for pool in POOLS]
         + [("f1", "box"), ("f1", "plane")])
NINE = [[10.0, 200.0, 344.0, 237.0], [200.0, 10.0, 237.0, 444.0]]
# slivers and tall boxes whose bins take 5 to 23 samples (found on the CPU
# with `_roi_record`, adaptive_cap None against 4)
F1_MOVED = {
    "box": [[82.84113311767578, 7.598225116729736, 639.9981689453125, 262.3997802734375],
            [75.51812744140625, 27.29754066467285, 131.4962158203125, 246.4310760498047],
            [264.30316162109375, 183.0899658203125, 300.2140197753906, 418.6983947753906],
            [441.3808898925781, 7.159747123718262, 495.7129821777344, 232.71519470214844]],
    "plane": [[31.255233764648438, 85.14908599853516, 636.3790283203125, 130.50636291503906],
              [7.546128749847412, 255.8233184814453, 636.2803344726562, 312.2767639160156],
              [64.69647216796875, 187.70018005371094, 622.1502685546875, 208.90760803222656]],
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False


def _random_boxes(rs, b, n):
    sizes = rs.uniform(20, 480, (b, n, 1))
    x1 = rs.uniform(0, 600, (b, n, 1))
    y1 = rs.uniform(0, 440, (b, n, 1))
    return np.concatenate([x1, y1, np.minimum(x1 + sizes, 640),
                           np.minimum(y1 + sizes * 0.7, 480)], 2)


def _aspect5():
    """bench.py's aspect5 set: 5:1 and 1:5 boxes just under each level's
    largest area, at the corner and the centre."""
    adv = []
    for max_sqrt_area in (112.0, 224.0, 448.0):
        s = max_sqrt_area * 0.99
        for aspect in (5.0, 1.0 / 5.0):
            w, h = s * np.sqrt(aspect), s / np.sqrt(aspect)
            for cx, cy in ((w / 2 + 1, h / 2 + 1), (320, 240)):
                adv.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    adv = np.asarray(adv)[None]
    adv[..., 0::2] = adv[..., 0::2].clip(0, 640)
    adv[..., 1::2] = adv[..., 1::2].clip(0, 480)
    return adv


def _f1_boxes(pool):
    """p2 slivers up to the full 640-px width (23 samples per bin at 7x7),
    the 120x360 door (7 samples per bin at p3), `F1_MOVED` and 2000 random
    boxes of 20-640 px."""
    rs = np.random.RandomState(0)
    slivers = [[0.0, 100.0, 640.0, 112.0], [5.0, 30.0, 637.0, 40.0],
               [300.0, 0.0, 310.0, 480.0], [20.0, 200.0, 500.0, 215.0]]
    door = [[100.0, 50.0, 220.0, 410.0]]
    w, h = rs.uniform(20, 640, 2000), rs.uniform(20, 480, 2000)
    x1, y1 = rs.uniform(0, 640 - w), rs.uniform(0, 480 - h)
    rand = np.stack([x1, y1, x1 + w, y1 + h], 1)
    return np.concatenate([slivers, door, F1_MOVED[pool], rand])[None]


def _oracle():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_oracle_biased_480x640.npz")
    return np.load(path)["proposal_boxes"][None]


def _case(name, pool, seed, dtype=torch.float32):
    """(generator, features, boxes, valid or None, pool options) of a case."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rs = np.random.RandomState(seed)
    b = 2 if name == "full" else 1
    feats = [torch.randn((b, h, w, 256), generator=gen, device="cuda").to(dtype)
             for h, w in LEVELS]
    valid = None
    if name == "random64":
        boxes = np.concatenate([_random_boxes(rs, 1, 64), [NINE]], 1)
        valid = torch.rand(boxes.shape[:2], generator=gen, device="cuda") > 0.2
        valid[0, -2:] = True                       # the two 9:1 boxes
    elif name == "full":
        boxes = _random_boxes(rs, 2, 1000 if pool == "box" else 100)
        valid = torch.from_numpy(rs.rand(*boxes.shape[:2]) > 0.2).cuda()
    else:
        boxes = {"aspect5": _aspect5, "aspect9": lambda: np.asarray([NINE]),
                 "oracle": _oracle, "f1": lambda: _f1_boxes(pool)}[name]()
    p, sr, aligned = POOLS[pool]
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    return gen, feats, torch.from_numpy(boxes.astype(np.float32)).cuda(), valid, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case,pool", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(case, pool, dtype):
    _card()
    _, feats, boxes, valid, kw = _case(case, pool, 0, dtype)
    with tracing.recording() as rec:
        got = rac.multilevel_roi_align_cuda(feats, boxes, valid=valid, **kw)
    assert rec.counter("k1.launches") == 1
    assert rec.counter("k1.roi_slots") == boxes.shape[0] * boxes.shape[1]
    want = rac.multilevel_roi_align_separable(feats, boxes, valid=valid, **kw)
    check_record(rac, feats, boxes, valid, kw["output_size"], kw["sampling_ratio"],
                 kw["aligned"])
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    if valid is not None:
        assert bool((got[~valid] == 0).all())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    feats = [torch.zeros((1, h, w, 8), device="cuda", dtype=torch.float16)
             for h, w in ((64, 80), (32, 40), (16, 20), (8, 10))]
    boxes = torch.zeros((1, 2, 4), device="cuda")
    with pytest.raises(TypeError):
        rac.multilevel_roi_align_cuda(feats, boxes, strides=STRIDES, output_size=7,
                                      sampling_ratio=0, aligned=True)
    with pytest.raises(ValueError):
        rac.multilevel_roi_align_cuda([f.float() for f in feats], boxes,
                                      strides=STRIDES, output_size=20,
                                      sampling_ratio=0, aligned=True)
    with pytest.raises(ValueError):     # bf16 loads take 8 channels at a time
        rac.multilevel_roi_align_cuda([f[..., :4].bfloat16().contiguous() for f in feats],
                                      boxes, strides=STRIDES, output_size=7,
                                      sampling_ratio=0, aligned=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case,pool", CASES)
def test_cuda_adjoint_matches_plain_version_and_transposes_k1(case, pool):
    _card()
    gen, feats, boxes, valid, kw = _case(case, pool, 1)
    p = kw["output_size"]
    shapes = [f.shape for f in feats]
    pr = rac._prepare(shapes, boxes, valid=valid, **kw)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(kw, min_level=2))
    levels = pr["levels"].long()
    base = rac.assign_boxes_to_levels(boxes.reshape(-1, 4)) - 2
    assert bool((record[:, 0].long() == base).all())
    if case == "random64":
        assert record[-2:, 0].tolist() == [0, 1]   # the wide 9:1 sliver stays on p2
    g = torch.randn((levels.numel(), p, p, 256), generator=gen, device="cuda")
    with tracing.recording() as rec:
        got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **kw)
    assert rec.counter("k2.launches") == 1
    assert rec.counter("k2.roi_slots") == boxes.shape[0] * boxes.shape[1]
    want = rac.multilevel_roi_align_adjoint_separable(g, shapes, pr)
    fwd = rac.multilevel_roi_align_cuda(feats, boxes, valid=valid, **kw)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-4 * scale
    if valid is not None:
        # invalid ROIs send nothing: a cotangent only on them gives zero gradients
        only_invalid = g * (~valid).reshape(-1, 1, 1, 1)
        assert all(float(d.abs().max()) == 0.0
                   for d in rac.multilevel_roi_align_adjoint_cuda(only_invalid, shapes, boxes,
                                                                  record, **kw))
    lhs = float((fwd.double() * g.reshape(fwd.shape).double()).sum())
    rhs = float(sum((f.double() * d.double()).sum() for f, d in zip(feats, got)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(POOLS))
def test_cuda_train_pool_matches_plain_versions(pool):
    """K3 with impl "cuda": K1 forward and K2 backward through autograd
    against the plain forward and adjoint on the same card tensors."""
    _card()
    gen, feats, boxes, valid, kw = _case("random64", pool, 2)
    p = kw["output_size"]
    g = torch.randn((*boxes.shape[:2], p, p, 256), generator=gen, device="cuda")
    fs = [f.clone().requires_grad_(True) for f in feats]
    bx = boxes.clone().requires_grad_(True)
    with tracing.recording() as rec:
        out = rac.multilevel_roi_align_train(fs, bx, valid=valid, impl="cuda", **kw)
        out.backward(g)
    assert rec.counter("k1.launches") == 1
    assert rec.counter("k2.launches") == 1
    shapes = [f.shape for f in feats]
    pr = rac._prepare(shapes, boxes, valid=valid, **kw)
    ref_out = rac.multilevel_roi_align_separable(feats, boxes, valid=valid, **kw)
    g_valid = torch.where(valid[..., None, None, None], g, torch.zeros_like(g))
    ref_dfeats = rac.multilevel_roi_align_adjoint_separable(g_valid, shapes, pr)
    torch.cuda.synchronize()
    assert float((out.detach() - ref_out).abs().max()) <= 1e-5 * float(ref_out.abs().max())
    assert bool((out.detach()[~valid] == 0).all())
    scale = max(float(d.abs().max()) for d in ref_dfeats)
    for f, ref in zip(fs, ref_dfeats):
        assert float((f.grad - ref).abs().max()) <= 1e-4 * scale
    assert bx.grad is not None and float(bx.grad.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("pool", list(POOLS))
def test_cuda_record_equals_prepare(pool):
    """The fused prologue's integers equal torch `_prepare` and `_roi_record`
    on the card, the 9:1 boxes (on detectron2's levels) and invalid rows
    included."""
    _card()
    _, feats, boxes, valid, kw = _case("random64", pool, 3)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(kw, min_level=2))
    shapes = [f.shape for f in feats]
    want = rac._record_of(rac._prepare(shapes, boxes, valid=valid, **kw))
    twin = rac._roi_record(shapes, boxes, valid=valid, **kw)
    torch.cuda.synchronize()
    assert record.dtype == torch.int32 and tuple(record.shape) == (boxes.shape[1], 5)
    assert torch.equal(record, want) and torch.equal(twin, want)
    base = rac.assign_boxes_to_levels(boxes.reshape(-1, 4)) - 2
    assert bool((record[:, 0].long() == base).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["box", "plane"])
def test_cuda_kernels_sample_above_four_and_at_the_cap_of_four(pool):
    """On ROIs whose bins take more than 4 samples the uncapped kernels
    (the default) move records off the capped ones; with the kernels'
    run-time cap at 4 (JAX's count) both equal the capped plain versions
    and the capped `_roi_record`."""
    _card()
    gen, feats, boxes, _, kw = _case("f1", pool, 2)
    p = kw["output_size"]
    flat = boxes.reshape(-1, 4)
    scale = torch.tensor([1.0 / s for s in STRIDES], device="cuda")[
        rac.assign_boxes_to_levels(flat) - 2]
    counts = sample_counts(flat, scale, p, kw["sampling_ratio"], kw["aligned"])
    shapes = [f.shape for f in feats]
    capped = rac._roi_record(shapes, boxes, adaptive_cap=4, **kw)
    _, record = rac._forward_kernel(feats, boxes, None, dict(kw, min_level=2))
    assert int(counts.max()) >= (23 if p == 7 else 12) and bool((record != capped).any(1).any())
    cap4 = dict(kw, adaptive_cap=4)
    record4 = check_record(rac, feats, boxes, None, p, kw["sampling_ratio"], kw["aligned"],
                           adaptive_cap=4)
    fwd4, _ = rac._forward_kernel(feats, boxes, None, dict(cap4, min_level=2))
    want4 = rac.multilevel_roi_align_separable(feats, boxes, **cap4).reshape(fwd4.shape)
    g = torch.randn((boxes.shape[1], p, p, 256), generator=gen, device="cuda")
    got4 = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record4, **cap4)
    plain4 = rac.multilevel_roi_align_adjoint_separable(g, shapes,
                                                        rac._prepare(shapes, boxes, **cap4))
    torch.cuda.synchronize()
    assert torch.equal(record4, capped)
    assert float((fwd4 - want4).abs().max()) <= 1e-5 * float(want4.abs().max())
    ref2 = max(float(b.abs().max()) for b in plain4)
    assert max(float((a - b).abs().max()) for a, b in zip(got4, plain4)) <= 1e-4 * ref2
