"""Port vs JAX: the per-ROI record of the kernels' fused prologue.

`ops/roi_align_cuda.py::_roi_record` is the torch twin of
`csrc/roi_align_prologue.cuh` (the prologue K1 and K2 run on the card):
the same operations in the same order, extremes in closed form, constant
divisions as reciprocal multiplications.  Its record (level, y0, x0, nty,
ntx) must equal the JAX Pallas prologue `roi_align_pallas._prepare` and the
port's `_prepare` exactly, integer for integer, for the box, mask and
plane pools on:

  * the 5:1 set (the max sqrt-area of each level, both orientations);
  * the 9:1 slivers whose window overflows p2 and bumps them to p3;
  * random boxes with a `valid` mask (invalid ROIs get nty = 0);
  * degenerate boxes: zero area, negative extent, outside the image.

The JAX prologue caps the adaptive sample count at 4, so the port runs
here with `adaptive_cap=4`; the uncapped record is pinned in
`tests/test_torch_goldens.py`.  The kernel's own record is held against
`_prepare` on the card by
`tests/test_torch_roi_align_cuda.py` and `chip_smoke.py`.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from articulation3d_tpu.ops import roi_align_pallas as jpal

from articulation3d_tpu_torch.ops import roi_align_cuda as rac

STRIDES = (4, 8, 16, 32)
POOLS = [(7, 0, True), (14, 2, False), (14, 0, False)]   # box, mask, plane
SHAPES = [(2, 120, 160, 4), (2, 60, 80, 4), (2, 30, 40, 4), (2, 15, 20, 4)]


def _aspect5(rs):
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
    return np.stack([adv, adv[::-1]]), None


def _nine(rs):
    nine = np.asarray([[10.0, 200.0, 344.0, 237.0], [200.0, 10.0, 237.0, 444.0],
                       [300.0, 100.0, 639.0, 140.0], [600.0, 20.0, 630.0, 470.0]],
                      np.float32)
    return np.stack([nine, nine[::-1]]), None


def _random_valid(rs):
    n = 300
    size = rs.uniform(2, 600, (2, n, 1))
    aspect = np.exp(rs.uniform(-2.3, 2.3, (2, n, 1)))
    x1 = rs.uniform(-50, 640, (2, n, 1))
    y1 = rs.uniform(-50, 480, (2, n, 1))
    boxes = np.concatenate([x1, y1, x1 + size * aspect, y1 + size / aspect], 2)
    return boxes.astype(np.float32), rs.rand(2, n) > 0.3


def _degenerate(rs):
    pts = rs.uniform(-100, 700, (2, 40, 2)).astype(np.float32)
    zero = np.concatenate([pts[:, :10], pts[:, :10]], 2)              # zero area
    flipped = np.concatenate([pts[:, 10:20], pts[:, 10:20] - 5.0], 2)  # x2 < x1
    outside = np.concatenate([pts[:, 20:30] + 900.0, pts[:, 20:30] + 960.0], 2)
    above = np.concatenate([pts[:, 30:] - 900.0, pts[:, 30:] - 890.0], 2)
    return np.concatenate([zero, flipped, outside, above], 1), None


SETS = {"aspect5": _aspect5, "aspect9_bumped": _nine, "random_valid": _random_valid,
        "degenerate": _degenerate}


@pytest.mark.parametrize("set_name", list(SETS))
@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_roi_record_equals_jax_prepare(p, sr, aligned, set_name):
    boxes, valid = SETS[set_name](np.random.RandomState(0))
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    jv = None if valid is None else jnp.asarray(valid)
    want = jpal._prepare([jnp.zeros(s, jnp.float32) for s in SHAPES], jnp.asarray(boxes),
                         valid=jv, pad_features=False, **kw)
    want = np.stack([np.asarray(want[k]) for k in rac.RECORD], 1)
    tv = None if valid is None else torch.from_numpy(valid)
    got = rac._roi_record(SHAPES, torch.from_numpy(boxes), valid=tv, adaptive_cap=4, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (boxes.shape[0] * boxes.shape[1], 5)
    np.testing.assert_array_equal(got.numpy(), want)
    pr = rac._prepare(SHAPES, torch.from_numpy(boxes), valid=tv, adaptive_cap=4, **kw)
    np.testing.assert_array_equal(rac._record_of(pr).numpy(), want)
    if set_name == "aspect9_bumped" and (p, sr) == (7, 0):
        # the slivers leave their sqrt-area level for a coarser one
        base = rac.assign_boxes_to_levels(torch.from_numpy(boxes.reshape(-1, 4))) - 2
        assert bool((got[:, 0].long() > base).any())
    if valid is not None:
        assert bool((got[:, 3][torch.from_numpy(~valid.reshape(-1))] == 0).all())
        assert bool((got[:, 3][torch.from_numpy(valid.reshape(-1))] > 0).all())
