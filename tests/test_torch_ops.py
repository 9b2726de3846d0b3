"""Port vs JAX: preprocessing, box ops, NMS, mask pasting, plane offsets.

The same seeded numpy inputs go through the JAX function and its
counterpart in `articulation3d_tpu_torch`, both on the CPU in float32.
Tolerances: integer and boolean outputs (indices, keep masks, pasted
masks) must be equal; float outputs agree to 1e-5 relative / 1e-4
absolute, the float32 rounding of the same arithmetic in another order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from articulation3d_tpu.ops import box_ops as jbox
from articulation3d_tpu.ops import nms as jnms
from articulation3d_tpu.ops.mask_paste import paste_masks as jpaste
from articulation3d_tpu.ops.preprocess import preprocess_images as jpre
from articulation3d_tpu.ops.preprocess import resize_bilinear as jresize
from articulation3d_tpu.utils.camera import get_k_inv_dot_xy_1_eval as jrays
from articulation3d_tpu.video.pipeline import override_plane_offsets as joverride
from articulation3d_tpu.video.pipeline import pack_masks_bits as jpack

from articulation3d_tpu_torch.ops import box_ops, nms
from articulation3d_tpu_torch.ops.mask_paste import paste_masks
from articulation3d_tpu_torch.ops.preprocess import preprocess_images, resize_bilinear
from articulation3d_tpu_torch.utils.camera import get_k_inv_dot_xy_1_eval
from articulation3d_tpu_torch.video.pipeline import (override_plane_offsets,
                                                     pack_masks_bits)

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _boxes(rs, n, h=64.0, w=80.0, lo=2.0, hi=40.0):
    x1 = rs.uniform(0, w - 4, n)
    y1 = rs.uniform(0, h - 4, n)
    return np.stack([x1, y1, x1 + rs.uniform(lo, hi, n),
                     y1 + rs.uniform(lo, hi, n)], 1).astype(np.float32)


@pytest.mark.parametrize("shape,out", [((2, 30, 50, 3), (64, 80)),
                                       ((1, 64, 80, 3), (64, 80))])
def test_preprocess_matches_jax(shape, out):
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, shape).astype(np.uint8)
    kw = dict(height=out[0], width=out[1], size_divisibility=32)
    got = preprocess_images(_t(frames), **kw).numpy()
    want = np.asarray(jpre(jnp.asarray(frames), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_preprocess_pads_to_divisibility():
    frames = np.full((1, 50, 70, 3), 200, np.uint8)
    kw = dict(height=50, width=70, size_divisibility=32)
    got = preprocess_images(_t(frames), **kw).numpy()
    want = np.asarray(jpre(jnp.asarray(frames), **kw))
    assert got.shape == want.shape == (1, 64, 96, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resize_bilinear_matches_jax():
    img = np.random.RandomState(1).rand(17, 23, 3).astype(np.float32)
    np.testing.assert_allclose(resize_bilinear(_t(img), 31, 11).numpy(),
                               np.asarray(jresize(jnp.asarray(img), 31, 11)),
                               rtol=RTOL, atol=1e-6)


def test_box_ops_match_jax():
    rs = np.random.RandomState(2)
    a, b = _boxes(rs, 12), _boxes(rs, 9)
    a[3] = [5, 5, 5, 9]                              # zero-area box
    np.testing.assert_allclose(box_ops.pairwise_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jbox.pairwise_iou(a, b)), atol=1e-6)
    deltas = rs.randn(12, 4).astype(np.float32) * 3   # dw/dh past the clamp
    for wts in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = box_ops.decode_deltas(_t(deltas), _t(a), wts).numpy()
        np.testing.assert_allclose(got, np.asarray(jbox.decode_deltas(deltas, a, wts)),
                                   rtol=RTOL, atol=ATOL)
    big = (a * 3 - 40).astype(np.float32)
    got = box_ops.clip_boxes(_t(big), 64, 80).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbox.clip_boxes(big, 64, 80)))
    np.testing.assert_array_equal(box_ops.nonempty(_t(got)).numpy(),
                                  np.asarray(jbox.nonempty(got)))


def _nms_case(seed, n=48):
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, n, lo=8.0, hi=30.0)
    # ties: quantized scores, duplicated boxes, degenerate boxes
    scores = np.round(rs.rand(n), 1).astype(np.float32)
    boxes[5] = boxes[4]
    scores[5] = scores[4]
    boxes[7] = [10, 10, 10, 30]
    valid = rs.rand(n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_nms_mask_matches_jax(seed, thr):
    boxes, scores, valid = _nms_case(seed)
    got = nms.nms_mask(_t(boxes), _t(scores), _t(valid), thr).numpy()
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), thr))
    np.testing.assert_array_equal(got, want)


def test_nms_mask_batched_rows_and_all_invalid():
    cases = [_nms_case(s) for s in (3, 4, 5)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    valid = np.stack([c[2] for c in cases])
    valid[1] = False                                  # an all-invalid row
    got = nms.nms_mask(_t(boxes), _t(scores), _t(valid), 0.5).numpy()
    for i in range(3):
        want = np.asarray(jnms.nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                        jnp.asarray(valid[i]), 0.5))
        np.testing.assert_array_equal(got[i], want)
    assert not got[1].any()


def test_batched_nms_and_select_top_match_jax():
    boxes, scores, valid = _nms_case(6, n=40)
    classes = np.random.RandomState(6).randint(0, 2, 40).astype(np.int32)
    got = nms.batched_nms_mask(_t(boxes), _t(scores), _t(classes).long(),
                               _t(valid), 0.5).numpy()
    want = np.asarray(jnms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                            jnp.asarray(classes),
                                            jnp.asarray(valid), 0.5))
    np.testing.assert_array_equal(got, want)
    idx, ok = nms.select_top(_t(scores), _t(got), 32)
    jidx, jok = jnms.select_top(jnp.asarray(scores), jnp.asarray(want), 32)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()],
                                  np.asarray(jidx)[np.asarray(jok)])


def test_top_k_ties_to_lowest_index():
    x = np.asarray([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    vals, idx = nms.top_k(_t(x), 4)
    jvals, jidx = jnms.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), [1, 3, 0, 2])
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("mask_nms", [False, True])
def test_paste_masks_matches_jax(mask_nms):
    rs = np.random.RandomState(7)
    n, m, h, w = 6, 28, 48, 64
    masks = rs.rand(n, m, m).astype(np.float32)
    boxes = _boxes(rs, n, h=h, w=w, lo=4.0, hi=40.0)
    boxes[2] = [20, 20, 20, 20]                      # degenerate box
    valid = np.asarray([True, True, True, False, True, True])
    for thr in (0.5, -1.0):
        got = paste_masks(_t(masks), _t(boxes), _t(valid), h, w, threshold=thr,
                          nms=mask_nms).numpy()
        want = np.asarray(jpaste(jnp.asarray(masks), jnp.asarray(boxes),
                                 jnp.asarray(valid), h, w, threshold=thr,
                                 nms=mask_nms))
        if thr >= 0:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == bool and not got[3].any()
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_override_plane_offsets_matches_jax():
    rs = np.random.RandomState(8)
    h, w, d = 48, 64, 5
    rays = get_k_inv_dot_xy_1_eval(h, w).reshape(3, h, w).astype(np.float32)
    np.testing.assert_array_equal(rays, np.asarray(
        jrays(h, w).reshape(3, h, w).astype(np.float32)))
    planes = rs.randn(d, 3).astype(np.float32)
    masks = rs.rand(d, h, w) > 0.6
    masks[3] = False                                 # empty mask keeps its plane
    depth = rs.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    got = override_plane_offsets(_t(planes), _t(masks), _t(depth), _t(rays)).numpy()
    want = np.asarray(joverride(jnp.asarray(planes), jnp.asarray(masks),
                                jnp.asarray(depth), jnp.asarray(rays)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(got[3], planes[3])


def test_pack_masks_bits_matches_jax():
    masks = np.random.RandomState(9).rand(2, 3, 5, 21) > 0.5
    got = pack_masks_bits(_t(masks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpack(jnp.asarray(masks))))
    np.testing.assert_array_equal(np.unpackbits(got, axis=-1, count=21).astype(bool),
                                  masks)


def test_safe_unit_and_double_angle_match_jax():
    from articulation3d_tpu.models.heads import double_angle as jdouble
    from articulation3d_tpu.models.heads import safe_unit as junit
    from articulation3d_tpu_torch.models.heads import double_angle, safe_unit

    v = np.random.RandomState(10).randn(6, 3).astype(np.float32)
    v[2] = 0.0                                       # zero rows stay zero
    np.testing.assert_allclose(safe_unit(_t(v)).numpy(), np.asarray(junit(jnp.asarray(v))),
                               rtol=RTOL, atol=1e-6)
    assert not safe_unit(_t(v)).numpy()[2].any()
    sc = v[:, :2]
    np.testing.assert_allclose(double_angle(_t(sc)).numpy(),
                               np.asarray(jdouble(jnp.asarray(sc))), rtol=RTOL, atol=1e-6)
