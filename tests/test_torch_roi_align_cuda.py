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
"""

import numpy as np
import pytest
import torch

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.ops import roi_align_cuda as rac

STRIDES = (4, 8, 16, 32)
POOLS = [(7, 0, True), (14, 2, False), (14, 0, False)]   # box, mask, plane


def _boxes(rs, n):
    sizes = rs.uniform(20, 480, (1, n, 1))
    x1 = rs.uniform(0, 600, (1, n, 1))
    y1 = rs.uniform(0, 440, (1, n, 1))
    boxes = np.concatenate([x1, y1, np.minimum(x1 + sizes, 640),
                            np.minimum(y1 + sizes * 0.7, 480)], 2)
    nine = [[[10.0, 200.0, 344.0, 237.0], [200.0, 10.0, 237.0, 444.0]]]
    return np.concatenate([boxes, nine], 1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("p,sr,aligned", POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(p, sr, aligned, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = [torch.randn((1, h, w, 256), generator=gen, device="cuda").to(dtype)
             for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
    boxes = torch.from_numpy(_boxes(np.random.RandomState(0), 64)).cuda()
    valid = torch.rand(boxes.shape[:2], generator=gen, device="cuda") > 0.2
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned,
              valid=valid)
    with tracing.recording() as rec:
        got = rac.multilevel_roi_align_cuda(feats, boxes, **kw)
    assert rec.counter("k1.launches") == 1
    assert rec.counter("k1.roi_slots") == boxes.shape[0] * boxes.shape[1]
    want = rac.multilevel_roi_align_separable(feats, boxes, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert bool((got[~valid] == 0).all())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
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


def _cuda_case(p, sr, aligned, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feats = [torch.randn((1, h, w, 256), generator=gen, device="cuda")
             for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
    boxes = torch.from_numpy(_boxes(np.random.RandomState(seed), 64)).cuda()
    valid = torch.rand(boxes.shape[:2], generator=gen, device="cuda") > 0.2
    valid[0, -2:] = True                       # the two 9:1 boxes
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    return gen, feats, boxes, valid, kw


@pytest.mark.cuda
@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_cuda_adjoint_matches_plain_version_and_transposes_k1(p, sr, aligned):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, feats, boxes, valid, kw = _cuda_case(p, sr, aligned)
    shapes = [f.shape for f in feats]
    pr = rac._prepare(shapes, boxes, valid=valid, **kw)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(kw, min_level=2))
    levels = pr["levels"].long()
    base = rac.assign_boxes_to_levels(boxes.reshape(-1, 4)) - 2
    assert bool((record[:, 0].long() == base).all())
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
    # invalid ROIs send nothing: a cotangent only on them gives zero gradients
    only_invalid = g * (~valid).reshape(-1, 1, 1, 1)
    assert all(float(d.abs().max()) == 0.0
               for d in rac.multilevel_roi_align_adjoint_cuda(only_invalid, shapes, boxes,
                                                              record, **kw))
    lhs = float((fwd.double() * g.reshape(fwd.shape).double()).sum())
    rhs = float(sum((f.double() * d.double()).sum() for f, d in zip(feats, got)))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.cuda
@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_cuda_train_pool_matches_plain_versions(p, sr, aligned):
    """K3 with impl "cuda": K1 forward and K2 backward through autograd
    against the plain forward and adjoint on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen, feats, boxes, valid, kw = _cuda_case(p, sr, aligned, seed=2)
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
@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_cuda_record_equals_prepare(p, sr, aligned):
    """The fused prologue's integers equal torch `_prepare` and `_roi_record`
    on the card, the 9:1 boxes (on detectron2's levels) and invalid rows
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, feats, boxes, valid, kw = _cuda_case(p, sr, aligned, seed=3)
    _, record = rac._forward_kernel(feats, boxes, valid, dict(kw, min_level=2))
    shapes = [f.shape for f in feats]
    want = rac._record_of(rac._prepare(shapes, boxes, valid=valid, **kw))
    twin = rac._roi_record(shapes, boxes, valid=valid, **kw)
    torch.cuda.synchronize()
    assert record.dtype == torch.int32 and tuple(record.shape) == (boxes.shape[1], 5)
    assert torch.equal(record, want) and torch.equal(twin, want)
    base = rac.assign_boxes_to_levels(boxes.reshape(-1, 4)) - 2
    assert bool((record[:, 0].long() == base).all())
