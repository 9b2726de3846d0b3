"""Port vs JAX: the per-ROI record of the kernels' fused prologue.

`ops/roi_align_cuda.py::_roi_record` is the torch twin of
`csrc/roi_align_prologue.cuh` (the prologue K1 and K2 run on the card):
the same operations in the same order, extremes in closed form, constant
divisions as reciprocal multiplications.  Its record (level, y0, x0, ny,
nx) must equal the record of the port's plain weights (`_prepare`)
exactly, integer for integer; the level must be JAX's
`assign_boxes_to_levels` (detectron2's, which the reference pools from);
and the record's cells must hold every non-zero plain weight, the first
cell carrying weight wherever all samples lie in the map.  For the box,
mask and plane pools on:

  * the 5:1 set (the max sqrt-area of each level, both orientations);
  * 9:1 slivers, one of which overflows the JAX Pallas kernel's 64x80-cell
    window on p2 (that kernel pools it from p3; the port stays on p2);
  * random boxes with a `valid` mask (invalid ROIs get ny = 0);
  * degenerate boxes: zero area, negative extent, outside the image.

The JAX prologue caps the adaptive sample count at 4, so the port runs
here with `adaptive_cap=4`; the uncapped record is pinned in
`tests/test_torch_goldens.py`.  The kernel's own record is held against
`_prepare` on the card by
`tests/test_torch_roi_align_cuda.py`.

The card tests count the ROIs that the JAX Pallas kernel pools from a
coarser level with their own copy of that kernel's rule
(`torch_checks.pallas_moved`; the card has no JAX); the copy equals
`pallas_level_idx`, ROI for ROI, on these sets and the oracle's 1000
proposals.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from articulation3d_tpu.ops import roi_align_pallas as jpal
from articulation3d_tpu.ops.roi_align import assign_boxes_to_levels as jassign

from articulation3d_tpu_torch.ops import roi_align_cuda as rac
from torch_checks import pallas_moved

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
    tv = None if valid is None else torch.from_numpy(valid)
    got = rac._roi_record(SHAPES, torch.from_numpy(boxes), valid=tv, adaptive_cap=4, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (boxes.shape[0] * boxes.shape[1], 5)
    pr = rac._prepare(SHAPES, torch.from_numpy(boxes), valid=tv, adaptive_cap=4, **kw)
    np.testing.assert_array_equal(got.numpy(), rac._record_of(pr).numpy())
    flat = jnp.asarray(boxes.reshape(-1, 4))
    base = np.asarray(jassign(flat)) - 2
    np.testing.assert_array_equal(got[:, 0].numpy(), base)
    # the record's cells hold the plain weights (of invalid ROIs too: the
    # record without `valid`): none beyond (ny, nx), and where every sample
    # of an axis is in the map its first cell has weight
    whole = rac._roi_record(SHAPES, torch.from_numpy(boxes), adaptive_cap=4, **kw).long()
    for w, n in ((pr["ry"], whole[:, 3]), (pr["rx"], whole[:, 4])):
        beyond = torch.arange(w.shape[-1])[None, :] >= n[:, None]
        assert bool((w.abs().amax(1)[beyond] == 0).all())
        full = (w.sum(-1) - 1.0).abs().amax(-1) < 1e-5
        assert bool((w[:, :, 0].abs().amax(-1)[full] > 0).all())
    if set_name == "aspect9_bumped" and (p, sr) == (7, 0):
        # a sliver the JAX Pallas prologue moves to a coarser level
        moved = np.asarray(jpal.pallas_level_idx(flat, n_levels=4, **kw)) > base
        assert moved.any() and (got[:, 0].numpy()[moved] == base[moved]).all()
    if valid is not None:
        assert bool((got[:, 3][torch.from_numpy(~valid.reshape(-1))] == 0).all())
        assert bool((got[:, 3][torch.from_numpy(valid.reshape(-1))] > 0).all())


def _oracle(rs):
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_oracle_biased_480x640.npz")
    return np.load(path)["proposal_boxes"].astype(np.float32)[None], None


@pytest.mark.parametrize("set_name", list(SETS) + ["oracle"])
@pytest.mark.parametrize("p,sr,aligned", POOLS)
def test_smoke_move_rule_equals_pallas_level_idx(p, sr, aligned, set_name):
    boxes, valid = (SETS.get(set_name) or _oracle)(np.random.RandomState(0))
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned)
    flat = jnp.asarray(boxes.reshape(-1, 4))
    want = (np.asarray(jpal.pallas_level_idx(flat, n_levels=4, **kw))
            != np.asarray(jassign(flat)) - 2)
    if valid is not None:
        want &= valid.reshape(-1)
    got = pallas_moved(torch.from_numpy(boxes), None if valid is None
                       else torch.from_numpy(valid), p, sr, aligned)
    np.testing.assert_array_equal(got.numpy(), want)
    if set_name == "oracle":
        assert int(want.sum()) == (891 if (p, sr) == (14, 0) else 821)
