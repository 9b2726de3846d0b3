"""Port vs JAX: multilevel ROIAlign, the kernel's prologue and its plain
version.

The port pools every ROI from detectron2's level, as the reference and
JAX's XLA gather do; JAX's Pallas kernel pools an ROI whose samples
overflow its 64x80-cell window from a coarser level (ROADMAP.md section
3, F2).  So the port is held against the Pallas prologue and kernel on
the ROIs inside that window contract, and against the gather on all:

  * the port's prologue (`_prepare`) gives the Pallas prologue's dense
    Ry/Rx, to 1e-6 absolute (weights in [0, 1], float32 arithmetic in the
    same order), its level, batch ids and valid rows, on in-contract ROIs;
  * the plain separable version equals the Pallas kernel run in interpret
    mode on in-contract ROIs, for the three pool configurations, odd ROI
    counts and valid predication, at 1e-5 relative to max |out| (float32
    sums in another order); with bfloat16 features at 1e-2 relative, since
    the Pallas kernel rounds its weights and its intermediate product to
    bfloat16 (about 2^-9 each) and the port keeps both in float32;
  * it equals the gather formulation (port's and JAX's) on every ROI, 9:1
    slivers and p2 slivers up to the full 640-px width included, and pools
    the 9:1 slivers at p2 where the Pallas kernel takes p3;
  * the wrapper takes the plain version for CPU tensors.

JAX's multilevel functions cap the adaptive sample count at 4, so the port
runs here with `adaptive_cap=4`; its default is uncapped, the reference's
count (ROADMAP.md section 3, F1; `tests/test_torch_goldens.py`).

The kernel itself is held against the plain version on the card by
`tests/test_torch_roi_align_cuda.py`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from articulation3d_tpu.ops import roi_align_pallas as jpal
from articulation3d_tpu.ops.roi_align import assign_boxes_to_levels as jassign
from articulation3d_tpu.ops.roi_align import multilevel_roi_align as jgather

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.ops import roi_align_cuda as rac
from articulation3d_tpu_torch.ops.roi_align import multilevel_roi_align

STRIDES = (4, 8, 16, 32)
POOLS = [(7, 0, True), (14, 2, False), (14, 0, False)]   # box, mask, plane
CAP = dict(adaptive_cap=4)   # the JAX package's sample cap (ROADMAP.md, F1)


def _pyramid(rs, b=2, c=8, shapes=((64, 80), (32, 40), (16, 20), (8, 16))):
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in shapes]


def _boxes(rs, b=2, n=6):
    x1 = rs.uniform(0, 200, (b, n, 1))
    y1 = rs.uniform(0, 150, (b, n, 1))
    sz = rs.uniform(10, 100, (b, n, 1))
    return np.concatenate([x1, y1, np.minimum(x1 + sz, 320),
                           np.minimum(y1 + sz * 0.8, 256)], 2).astype(np.float32)


def _full_pyramid(rs, c=8):
    return _pyramid(rs, b=1, c=c, shapes=((120, 160), (60, 80), (30, 40), (15, 20)))


def _adversarial_boxes():
    """The bench's aspect5 set (5:1 at the max sqrt-area of each level)."""
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
    return adv


NINE = np.asarray([[[10.0, 200.0, 344.0, 237.0],
                    [200.0, 10.0, 237.0, 444.0]]], np.float32)
# p2 slivers up to the full 640-px width (23 samples per bin at 7x7)
SLIVERS = np.asarray([[[0.0, 100.0, 640.0, 112.0], [5.0, 30.0, 637.0, 40.0],
                       [300.0, 0.0, 310.0, 480.0], [20.0, 200.0, 500.0, 215.0]]],
                     np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _in_contract(boxes, n_levels=4, **kw):
    """(T,) bool: the ROIs that the Pallas prologue keeps on detectron2's
    level (their samples fit its 64x80-cell window)."""
    flat = jnp.asarray(boxes.reshape(-1, 4))
    return np.asarray(jpal.pallas_level_idx(flat, n_levels=n_levels, **kw)
                      == jassign(flat) - 2)


def _dense(w, origin, size):
    """(T, P, span) weights from per-ROI origins -> (T, P, size) on the
    level's cells (cells past the level's end dropped; their weights are
    zero)."""
    t, p, span = w.shape
    out = np.zeros((t, p, size + span), np.float32)
    for r in range(t):
        out[r, :, origin[r]:origin[r] + span] = w[r]
    return out[:, :, :size]


@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_prepare_matches_jax(p, sr, aligned):
    rs = np.random.RandomState(0)
    feats = _full_pyramid(rs, c=4)
    boxes = np.concatenate([_adversarial_boxes(), NINE,
                            _boxes(rs, b=1, n=20) * 2], axis=1)
    valid = np.random.RandomState(1).rand(*boxes.shape[:2]) > 0.2
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    want = jpal._prepare([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                         valid=jnp.asarray(valid), **kw)
    got = rac._prepare([f.shape for f in feats], _t(boxes), valid=_t(valid), **kw, **CAP)
    inside = _in_contract(boxes, **kw)
    n_adv = _adversarial_boxes().shape[1]
    if (p, sr) == (7, 0):     # the wide 9:1 box leaves the window contract at p2
        assert inside.sum() == inside.size - 1 and not inside[n_adv]
    np.testing.assert_array_equal(got["levels"].numpy(),
                                  np.asarray(jassign(jnp.asarray(boxes[0]))) - 2)
    for k in ("levels", "batch_ids"):
        np.testing.assert_array_equal(got[k].numpy()[inside], np.asarray(want[k])[inside],
                                      err_msg=k)
    np.testing.assert_array_equal(got["ny"].numpy() > 0, np.asarray(want["nty"]) > 0)
    t = boxes.shape[0] * boxes.shape[1]
    levels = got["levels"].numpy()
    for k, o_port, o_jax, span, dim in (("ry", "y0", "y0", 64, 1), ("rx", "x0", "x0", 80, 2)):
        size = np.asarray([feats[lv].shape[dim] for lv in levels])
        jw = np.swapaxes(np.asarray(want[k]), 1, 2).reshape(t, p, span)
        for r in np.nonzero(inside)[0]:
            mine = _dense(got[k].numpy()[r:r + 1], got[o_port].numpy()[r:r + 1], size[r])
            theirs = _dense(jw[r:r + 1], np.asarray(want[o_jax])[r:r + 1], size[r])
            np.testing.assert_allclose(mine, theirs, atol=1e-6, err_msg=f"{k} roi {r}")


@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_separable_matches_pallas_interpret(p, sr, aligned):
    rs = np.random.RandomState(0)
    feats = _pyramid(rs)
    boxes = _boxes(rs, n=5)                    # odd ROI count
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    want = np.asarray(jpal.multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), interpret=True, **kw))
    got = rac.multilevel_roi_align_separable([_t(f) for f in feats], _t(boxes), **kw,
                                             **CAP)
    assert got.shape == want.shape and got.dtype == torch.float32
    inside = _in_contract(boxes, **kw).reshape(boxes.shape[:2])
    assert inside.sum() >= 8, inside
    assert _rel_err(got.numpy()[inside], want[inside]) < 1e-5


def test_separable_valid_predication_matches_pallas():
    rs = np.random.RandomState(1)
    feats = _pyramid(rs, b=1)
    boxes = _boxes(rs, b=1, n=4)
    valid = np.asarray([[True, False, True, False]])
    kw = dict(strides=STRIDES, output_size=7, sampling_ratio=0, aligned=True)
    want = np.asarray(jpal.multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        valid=jnp.asarray(valid), interpret=True, **kw))
    got = rac.multilevel_roi_align_separable([_t(f) for f in feats], _t(boxes),
                                             valid=_t(valid), **kw, **CAP).numpy()
    assert np.all(got[0, 1] == 0) and np.all(got[0, 3] == 0)
    assert np.abs(got[0, 0]).max() > 0
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_separable_equals_gather_in_contract(p, sr, aligned):
    """On every ROI, in the Pallas window contract or not: capped against
    JAX's gather, uncapped against the port's."""
    rs = np.random.RandomState(2)
    feats = _full_pyramid(rs)
    boxes = np.concatenate([_adversarial_boxes(), NINE, SLIVERS,
                            _boxes(rs, b=1, n=10) * 2], 1)
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    assert not _in_contract(boxes, **kw).all()
    tf = [_t(f) for f in feats]
    sep = rac.multilevel_roi_align_separable(tf, _t(boxes), **kw, **CAP)
    gat = multilevel_roi_align([f[0] for f in tf], _t(boxes[0]), chunk=8, **kw, **CAP)
    jg = np.asarray(jgather([jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes[0]),
                            **kw))
    assert _rel_err(sep[0].numpy(), jg) < 1e-5
    assert _rel_err(gat.numpy(), jg) < 1e-5
    sep = rac.multilevel_roi_align_separable(tf, _t(boxes), **kw)
    gat = multilevel_roi_align([f[0] for f in tf], _t(boxes[0]), chunk=8, **kw)
    assert _rel_err(sep[0].numpy(), gat.numpy()) < 1e-5


def test_bumped_level_matches_jax():
    """The wide 9:1 sliver overflows the Pallas window on p2: the port pools
    it at detectron2's level p2 exactly as JAX's XLA gather does, and no
    longer as the Pallas kernel (interpret mode), which takes p3.  The tall
    one is at p3 by its area, and all three agree on it."""
    rs = np.random.RandomState(3)
    feats = _full_pyramid(rs)
    kw = dict(strides=STRIDES, output_size=7, sampling_ratio=0, aligned=True)
    got = rac.multilevel_roi_align_separable([_t(f) for f in feats], _t(NINE), **kw,
                                             **CAP)[0].numpy()
    assert rac._roi_record([f.shape for f in feats], _t(NINE), **kw)[:, 0].tolist() == [0, 1]
    ref = np.asarray(jgather([jnp.asarray(f[0]) for f in feats], jnp.asarray(NINE[0]),
                             **kw))
    assert _rel_err(got, ref) < 1e-5
    p2 = np.asarray(jgather([jnp.asarray(feats[0][0])], jnp.asarray(NINE[0, :1]),
                            strides=(4,), output_size=7, sampling_ratio=0, aligned=True))
    assert _rel_err(got[:1], p2) < 1e-5                       # the wide one at p2
    pallas = np.asarray(jpal.multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(NINE), interpret=True, **kw))[0]
    assert _rel_err(got[:1], pallas[:1]) > 0.1                # Pallas: p3
    assert _rel_err(got[1:], pallas[1:]) < 1e-5
    port_ref = multilevel_roi_align([_t(f[0]) for f in feats], _t(NINE[0]), **kw, **CAP)
    assert _rel_err(port_ref.numpy(), ref) < 1e-5


def test_bf16_features_match_pallas_interpret():
    rs = np.random.RandomState(4)
    feats = _pyramid(rs, b=1)
    boxes = _boxes(rs, b=1, n=3)
    kw = dict(strides=STRIDES, output_size=7, sampling_ratio=0, aligned=True)
    want = np.asarray(jpal.multilevel_roi_align_pallas(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(boxes),
        interpret=True, **kw))
    got = rac.multilevel_roi_align_separable(
        [_t(f).to(torch.bfloat16) for f in feats], _t(boxes), **kw, **CAP)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < 1e-2


def test_wrapper_takes_plain_version_on_cpu():
    rs = np.random.RandomState(5)
    feats = [_t(f) for f in _pyramid(rs)]
    boxes = _t(_boxes(rs))
    kw = dict(strides=STRIDES, output_size=7, sampling_ratio=0, aligned=True)
    with tracing.recording() as rec:
        got = rac.multilevel_roi_align_cuda(feats, boxes, **kw)
    assert rec.counter("k1.launches") == 0
    torch.testing.assert_close(got, rac.multilevel_roi_align_separable(feats, boxes, **kw),
                               rtol=0, atol=0)
