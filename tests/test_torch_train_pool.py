"""Port vs JAX: the training pooler (K3) and the ROIAlign adjoint (K2).

  * the plain adjoint `multilevel_roi_align_adjoint_separable` equals the
    JAX Pallas adjoint kernel run in interpret mode on the cases of
    `tests/test_pallas_interpret.py` (ROI counts that pad the kernel's ROI
    groups, valid masks), within 1e-4 rtol and atol (float32 sums in
    another order, the tolerance those tests hold the kernel to);
  * it equals the JAX corner-scatter adjoint `multilevel_roi_align_adjoint`
    at detectron2's levels on a 480x640 pyramid with the 5:1 set, the 9:1
    set, whose wide sliver the JAX Pallas kernel pools (and scatters) from
    p3, and p2 slivers up to 640 px, within 1e-4 rtol and atol;
  * uncapped (the port's default), it equals the autograd of the port's
    gather `ops/roi_align.py::multilevel_roi_align` on those sets within
    1e-4 x max|grad|;
  * forward and adjoint are a transpose pair: <K1(F), G> = <F, K2(G)>,
    summed in float64, within 1e-6 relative (float32 products);
  * K3 (`multilevel_roi_align_train`, impl "cuda", plain versions on the
    CPU) matches JAX `multilevel_roi_align_train(use_pallas=True,
    interpret=True)` in forward (1e-5) and feature gradients (1e-4), and
    impl "torch" under torch autograd matches JAX `use_pallas=False`
    (1e-5, the same linear map summed in another order);
  * K3 saves the boxes, `valid` and the (T, 5) int32 record for its
    backward, not the Ry/Rx weights;
  * boxes get a zero gradient, invalid rows pool to exact zeros and send
    nothing to the features, and the wrappers take their plain versions
    for CPU tensors without counting a launch.

Where the port is held against JAX it runs with `adaptive_cap=4`, JAX's
sample cap; its default is uncapped (ROADMAP.md section 3, F1).

The compiled K2 is held against its plain version on the card by
`tests/test_torch_roi_align_cuda.py`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from articulation3d_tpu.ops import roi_align_pallas as jpal
from articulation3d_tpu.ops.roi_align import (assign_boxes_to_levels,
                                              multilevel_roi_align_adjoint)

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.ops import roi_align_cuda as rac
from articulation3d_tpu_torch.ops.roi_align import multilevel_roi_align

STRIDES = (4, 8, 16, 32)
KW7 = dict(strides=STRIDES, output_size=7, sampling_ratio=0, aligned=True)
CAP = dict(adaptive_cap=4)   # the JAX package's sample cap (ROADMAP.md, F1)


def _pyramid(rs, b=2, c=8, shapes=((64, 80), (32, 40), (16, 20), (8, 16))):
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in shapes]


def _boxes(rs, b=2, n=6):
    x1 = rs.uniform(0, 200, (b, n, 1))
    y1 = rs.uniform(0, 150, (b, n, 1))
    sz = rs.uniform(10, 100, (b, n, 1))
    return np.concatenate([x1, y1, np.minimum(x1 + sz, 320),
                           np.minimum(y1 + sz * 0.8, 256)], 2).astype(np.float32)


def _adversarial_boxes():
    """The bench's aspect5 set and two 9:1 slivers (the wide one at p2
    overflows the JAX Pallas kernel's window)."""
    adv = []
    for max_sqrt_area in (112.0, 224.0, 448.0):
        s = max_sqrt_area * 0.99
        for aspect in (5.0, 1.0 / 5.0):
            w, h = s * np.sqrt(aspect), s / np.sqrt(aspect)
            for cx, cy in ((w / 2 + 1, h / 2 + 1), (320, 240)):
                adv.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])
    adv = np.asarray(adv, np.float32)
    adv[:, 0::2] = adv[:, 0::2].clip(0, 640)
    adv[:, 1::2] = adv[:, 1::2].clip(0, 480)
    nine = np.asarray([[10.0, 200.0, 344.0, 237.0], [200.0, 10.0, 237.0, 444.0]],
                      np.float32)
    return np.concatenate([adv, nine])[None]


# p2 slivers up to the full 640-px width (23 samples per bin at 7x7)
SLIVERS = np.asarray([[[0.0, 100.0, 640.0, 112.0], [5.0, 30.0, 637.0, 40.0],
                       [300.0, 0.0, 310.0, 480.0], [20.0, 200.0, 500.0, 215.0]]],
                     np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _plain_adjoint(g, shapes, boxes, valid=None, **kw):
    pr = rac._prepare(shapes, _t(boxes), valid=None if valid is None else _t(valid),
                      adaptive_cap=4, **kw)
    return [d.numpy() for d in rac.multilevel_roi_align_adjoint_separable(_t(g), shapes, pr)]


@pytest.fixture(scope="module")
def interp():
    """JAX interpret-mode runs at one shape (b=2, n=6, P=7, C=8; 6 ROIs pad
    the adjoint kernel's groups of 8): the adjoint kernel without a valid
    mask, and K3's value and gradients with one, whose backward is the
    adjoint kernel on the valid rows (roi_align_pallas.py:797-812)."""
    rs = np.random.RandomState(2)
    feats = _pyramid(rs)
    shapes = [f.shape for f in feats]
    boxes = _boxes(rs)
    g = rs.randn(2, 6, 7, 7, 8).astype(np.float32)
    valid = np.asarray([[True, False, True, True, False, True],
                        [False, True, True, True, True, False]])
    adj = jpal.multilevel_roi_align_adjoint_pallas(
        jnp.asarray(g), jnp.asarray(boxes), shapes, interpret=True, **KW7)

    def k3_loss(fs):
        out = jpal.multilevel_roi_align_train(
            fs, jnp.asarray(boxes), use_pallas=True, interpret=True,
            valid=jnp.asarray(valid), **KW7)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, k3_out), k3_grads = jax.value_and_grad(k3_loss, has_aux=True)(
        tuple(jnp.asarray(f) for f in feats))
    return dict(feats=feats, shapes=shapes, boxes=boxes, g=g, valid=valid,
                adj=[np.asarray(a) for a in adj], k3_out=np.asarray(k3_out),
                k3_grads=[np.asarray(x) for x in k3_grads])


def test_plain_adjoint_matches_pallas_interpret(interp):
    got = _plain_adjoint(interp["g"], interp["shapes"], interp["boxes"], **KW7)
    assert float(np.abs(got[0]).max()) > 0
    for a, w in zip(got, interp["adj"]):
        assert a.shape == w.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4)


def test_plain_adjoint_valid_mask_matches_pallas_interpret(interp):
    got = _plain_adjoint(interp["g"], interp["shapes"], interp["boxes"],
                         valid=interp["valid"], **KW7)
    for a, w in zip(got, interp["k3_grads"]):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4)
    # an invalid ROI sends nothing: the same as its cotangent rows zeroed
    # (1e-6: the skipped rows change how the sums are chunked)
    g0 = np.where(interp["valid"][..., None, None, None], interp["g"], 0.0)
    ref = _plain_adjoint(g0.astype(np.float32), interp["shapes"], interp["boxes"], **KW7)
    for a, w in zip(got, ref):
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-6)


def test_k3_matches_jax_pallas_interpret(interp):
    feats = [_t(f).requires_grad_() for f in interp["feats"]]
    out = rac.multilevel_roi_align_train(feats, _t(interp["boxes"]), impl="cuda",
                                         valid=_t(interp["valid"]), **KW7, **CAP)
    assert out.shape == interp["k3_out"].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), interp["k3_out"], rtol=1e-5, atol=1e-5)
    (out * _t(interp["g"])).sum().backward()
    for f, w in zip(feats, interp["k3_grads"]):
        np.testing.assert_allclose(f.grad.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p,sr,aligned", [(7, 0, True), (14, 2, False), (14, 0, False)])
def test_plain_adjoint_matches_xla_adjoint_with_bumped_levels(p, sr, aligned):
    rs = np.random.RandomState(3)
    feats = _pyramid(rs, b=1, c=4, shapes=((120, 160), (60, 80), (30, 40), (15, 20)))
    shapes = [f.shape for f in feats]
    boxes = np.concatenate([_adversarial_boxes(), _boxes(rs, b=1, n=10) * 2, SLIVERS], 1)
    n = boxes.shape[1]
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    g = rs.randn(1, n, p, p, 4).astype(np.float32)
    lvl = assign_boxes_to_levels(jnp.asarray(boxes[0])) - 2
    assert np.asarray(lvl)[12:14].tolist() == [0, 1]
    assert (np.asarray(lvl)[n - 4:] == 0).all()
    if (p, sr) == (7, 0):   # the Pallas kernel takes the wide one from p3
        bumped = jpal.pallas_level_idx(jnp.asarray(boxes[0]), n_levels=4, **kw)
        assert np.asarray(bumped)[12:14].tolist() == [1, 1]
    want = multilevel_roi_align_adjoint(jnp.asarray(g[0]), jnp.asarray(boxes[0]),
                                        [s[1:] for s in shapes], chunk=32,
                                        level_idx=lvl, **kw)
    got = _plain_adjoint(g, shapes, boxes, **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a[0], np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p,sr,aligned", [(7, 0, True), (14, 2, False), (14, 0, False)])
def test_plain_adjoint_equals_gather_autograd(p, sr, aligned):
    rs = np.random.RandomState(6)
    feats = _pyramid(rs, b=1, c=4, shapes=((120, 160), (60, 80), (30, 40), (15, 20)))
    shapes = [f.shape for f in feats]
    boxes = np.concatenate([_adversarial_boxes(), SLIVERS, _boxes(rs, b=1, n=10) * 2], 1)
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    g = rs.randn(1, boxes.shape[1], p, p, 4).astype(np.float32)
    fs = [_t(f[0]).requires_grad_() for f in feats]
    out = multilevel_roi_align(fs, _t(boxes[0]), chunk=8, **kw)
    want = torch.autograd.grad(out, fs, grad_outputs=_t(g[0]))
    pr = rac._prepare(shapes, _t(boxes), **kw)
    got = rac.multilevel_roi_align_adjoint_separable(_t(g), shapes, pr)
    scale = max(float(w.abs().max()) for w in want)
    assert float(want[0].abs().max()) > 0
    for a, w in zip(got, want):
        assert float((a[0] - w).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("p,sr,aligned", [(7, 0, True), (14, 2, False)])
def test_transpose_identity_float64(p, sr, aligned):
    rs = np.random.RandomState(4)
    feats = _pyramid(rs, b=1, c=4, shapes=((120, 160), (60, 80), (30, 40), (15, 20)))
    boxes = np.concatenate([_adversarial_boxes(), _boxes(rs, b=1, n=10) * 2], 1)
    valid = rs.rand(*boxes.shape[:2]) > 0.2
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned,
              valid=_t(valid))
    fwd = rac.multilevel_roi_align_separable([_t(f) for f in feats], _t(boxes), **kw)
    g = rs.randn(*fwd.shape).astype(np.float32)
    pr = rac._prepare([f.shape for f in feats], _t(boxes), **kw)
    adj = rac.multilevel_roi_align_adjoint_separable(_t(g), [f.shape for f in feats], pr)
    lhs = float((fwd.double() * _t(g).double()).sum())
    rhs = float(sum((_t(f).double() * d.double()).sum() for f, d in zip(feats, adj)))
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_torch_impl_matches_jax_gather_autodiff():
    rs = np.random.RandomState(5)
    feats = _pyramid(rs)
    boxes = _boxes(rs)
    valid = rs.rand(2, 6) > 0.3
    g = rs.randn(2, 6, 7, 7, 8).astype(np.float32)
    kw = dict(strides=STRIDES, output_size=7, sampling_ratio=2, aligned=False)

    def loss(fs):
        out = jpal.multilevel_roi_align_train(fs, jnp.asarray(boxes), use_pallas=False,
                                              valid=jnp.asarray(valid), **kw)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), wgrads = jax.value_and_grad(loss, has_aux=True)(
        tuple(jnp.asarray(f) for f in feats))
    ft = [_t(f).requires_grad_() for f in feats]
    out = rac.multilevel_roi_align_train(ft, _t(boxes), impl="torch", valid=_t(valid), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (out * _t(g)).sum().backward()
    for f, w in zip(ft, wgrads):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_zero_box_gradient_and_invalid_rows(impl):
    rs = np.random.RandomState(6)
    feats = [_t(f).requires_grad_() for f in _pyramid(rs, b=2)]
    boxes = _t(_boxes(rs)).requires_grad_()
    valid = _t(np.asarray([[True, False, True, False, True, True],
                           [False, True, True, True, False, True]]))
    out = rac.multilevel_roi_align_train(feats, boxes, impl=impl, valid=valid, **KW7)
    assert bool((out[~valid] == 0).all()) and float(out.detach()[valid].abs().max()) > 0
    g = _t(rs.randn(*out.shape).astype(np.float32))
    (out * g).sum().backward()
    if impl == "cuda":
        assert bool((boxes.grad == 0).all())      # an explicit zero cotangent
    else:
        assert boxes.grad is None                 # boxes are detached
    # the invalid rows' cotangent reaches no feature (1e-6: the skipped
    # rows change how the float32 sums are chunked)
    f2 = [f.detach().clone().requires_grad_() for f in feats]
    out2 = rac.multilevel_roi_align_train(f2, boxes.detach(), impl=impl, valid=valid, **KW7)
    (out2 * torch.where(valid[..., None, None, None], g, torch.zeros_like(g))).sum().backward()
    for a, b in zip(feats, f2):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_k3_casts_gradients_to_the_feature_dtype():
    rs = np.random.RandomState(7)
    feats = [_t(f).to(torch.bfloat16).requires_grad_() for f in _pyramid(rs, b=1)]
    out = rac.multilevel_roi_align_train(feats, _t(_boxes(rs, b=1, n=3)), impl="cuda",
                                         **KW7)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert all(f.grad.dtype == torch.bfloat16 for f in feats)


def test_adjoint_wrapper_takes_plain_version_on_cpu():
    rs = np.random.RandomState(8)
    feats = _pyramid(rs)
    shapes = [f.shape for f in feats]
    boxes = _t(_boxes(rs))
    g = _t(rs.randn(12, 7, 7, 8).astype(np.float32))
    pr = rac._prepare(shapes, boxes, **KW7)
    record = rac._roi_record(shapes, boxes, **KW7)
    with tracing.recording() as rec:
        got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **KW7)
    assert rec.counter("k2.launches") == 0
    for a, w in zip(got, rac.multilevel_roi_align_adjoint_separable(g, shapes, pr)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_k3_saves_the_compact_record(interp):
    """K3 keeps boxes, valid and the (T, 5) int32 record for its backward,
    not the (T, P, ny) and (T, P, nx) weights, and still matches JAX's
    interpret-mode `_train_pool` in value and feature gradients."""
    feats = [_t(f).requires_grad_() for f in interp["feats"]]
    boxes, valid = _t(interp["boxes"]), _t(interp["valid"])
    out = rac.multilevel_roi_align_train(feats, boxes, impl="cuda", valid=valid, **KW7,
                                         **CAP)
    saved = out.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [(2, 6, 4), (2, 6), (12, 5)]
    record = saved[2]
    assert record.dtype == torch.int32
    np.testing.assert_array_equal(
        record.numpy(),
        rac._roi_record(interp["shapes"], boxes, valid=valid, **KW7, **CAP).numpy())
    assert ((record[:, 3] > 0).numpy() == interp["valid"].reshape(-1)).all()
    np.testing.assert_allclose(out.detach().numpy(), interp["k3_out"], rtol=1e-5, atol=1e-5)
    (out * _t(interp["g"])).sum().backward()
    for f, w in zip(feats, interp["k3_grads"]):
        np.testing.assert_allclose(f.grad.numpy(), w, rtol=1e-4, atol=1e-4)
