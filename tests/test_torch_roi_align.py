"""Port vs JAX: multilevel ROIAlign, the kernel's prologue and its plain
version.

  * the port's prologue (`_prepare`, `pallas_level_idx`) equals the JAX
    Pallas prologue: integers exactly, Ry/Rx to 1e-6 absolute (weights in
    [0, 1], float32 arithmetic in the same order);
  * the plain separable version equals the Pallas kernel run in interpret
    mode, for the three pool configurations, odd ROI counts and valid
    predication, at 1e-5 relative to max |out| (float32 sums in another
    order); with bfloat16 features at 1e-2 relative, since the Pallas
    kernel rounds its weights and its intermediate product to bfloat16
    (about 2^-9 each) and the port keeps both in float32;
  * it equals the gather formulation (port's and JAX's) for in-contract
    boxes, and pools out-of-contract 9:1 boxes from the bumped level;
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
from articulation3d_tpu.ops.roi_align import multilevel_roi_align as jgather

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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


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
    for k in ("levels", "batch_ids", "y0", "x0", "nty", "ntx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    t = boxes.shape[0] * boxes.shape[1]
    for k, span in (("ry", rac.SPAN_Y), ("rx", rac.SPAN_X)):
        w = np.swapaxes(np.asarray(want[k]), 1, 2).reshape(t, p, span)
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6, err_msg=k)
    assert list(got["hp"]) == list(want["hp"]) and list(got["wp"]) == list(want["wp"])
    lv = rac.pallas_level_idx(_t(boxes[0]), n_levels=4, **kw, **CAP)
    jlv = jpal.pallas_level_idx(jnp.asarray(boxes[0]), n_levels=4, **kw)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    n_adv = _adversarial_boxes().shape[1]
    assert lv.numpy()[n_adv:n_adv + 2].tolist() == [1, 1]   # 9:1 boxes: p2 -> p3


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
    assert _rel_err(got.numpy(), want) < 1e-5


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
    rs = np.random.RandomState(2)
    feats = _full_pyramid(rs)
    boxes = np.concatenate([_adversarial_boxes(), _boxes(rs, b=1, n=10) * 2], 1)
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    sep = rac.multilevel_roi_align_separable([_t(f) for f in feats], _t(boxes), **kw,
                                             **CAP)
    gat = multilevel_roi_align([_t(f[0]) for f in feats], _t(boxes[0]), chunk=8, **kw,
                               **CAP)
    jg = np.asarray(jgather([jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes[0]),
                            **kw))
    assert _rel_err(sep[0].numpy(), jg) < 1e-5
    assert _rel_err(gat.numpy(), jg) < 1e-5


def test_bumped_level_matches_jax():
    """9:1 boxes overflow the window on p2 and pool exactly from p3."""
    rs = np.random.RandomState(3)
    feats = _full_pyramid(rs)
    kw = dict(strides=STRIDES, output_size=7, sampling_ratio=0, aligned=True)
    got = rac.multilevel_roi_align_separable([_t(f) for f in feats], _t(NINE), **kw,
                                             **CAP)
    ref = np.asarray(jgather([jnp.asarray(feats[1][0])], jnp.asarray(NINE[0]),
                             strides=(8,), output_size=7, sampling_ratio=0,
                             aligned=True, min_level=3))
    assert _rel_err(got[0].numpy(), ref) < 1e-5
    port_ref = multilevel_roi_align([_t(feats[1][0])], _t(NINE[0]), strides=(8,),
                                    output_size=7, sampling_ratio=0, aligned=True,
                                    min_level=3, **CAP)
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
    before = rac.multilevel_roi_align_cuda.launches
    got = rac.multilevel_roi_align_cuda(feats, boxes, **kw)
    assert rac.multilevel_roi_align_cuda.launches == before
    torch.testing.assert_close(got, rac.multilevel_roi_align_separable(feats, boxes, **kw),
                               rtol=0, atol=0)
