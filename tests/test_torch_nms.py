"""The RPN's one NMS call over every FPN level, and the NMS wrapper's
contract, on the CPU.

`select_proposals` stacks each level's top-k as (B, L, N) sets, padded
with invalid rows, and makes one `nms_mask` call.  It must give what the
former loop (one `nms_mask` call per level, here `_select_per_level`)
gives, bit for bit, and what the JAX package's `select_proposals_single`
gives image by image (boxes to float32 rounding of the same decode, the
keep decisions equal).  The card's kernel against the plain version is
`tests/test_torch_nms_cuda.py`.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from articulation3d_tpu.models import rpn as jrpn

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.models.rpn import anchors_for_level, select_proposals
from articulation3d_tpu_torch.ops import nms
from articulation3d_tpu_torch.ops.box_ops import clip_boxes, decode_deltas, nonempty

H, W = 64, 96
STRIDES, SIZES = (4, 8, 16, 32, 64), (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)


def _select_per_level(level_logits, level_deltas, level_anchors, *, image_height,
                      image_width, pre_nms_topk, post_nms_topk, nms_thresh, min_size):
    """`select_proposals` as it was before the levels shared one NMS call."""
    all_boxes, all_scores, all_valid = [], [], []
    for scores, deltas, anchors in zip(level_logits, level_deltas, level_anchors):
        k = min(pre_nms_topk, anchors.shape[0])
        top_scores, idx = nms.top_k(scores.to(torch.float32), k)
        d = torch.gather(deltas.to(torch.float32), 1, idx[..., None].expand(-1, -1, 4))
        boxes = clip_boxes(decode_deltas(d, anchors[idx]), image_height, image_width)
        valid = nonempty(boxes, min_size) & torch.isfinite(boxes).all(dim=-1)
        all_boxes.append(boxes)
        all_scores.append(top_scores)
        all_valid.append(nms.nms_mask(boxes, top_scores, valid, nms_thresh))
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    idx, out_valid = nms.select_top(scores, torch.cat(all_valid, dim=1), post_nms_topk)
    top_scores = torch.gather(scores, 1, idx)
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
            torch.where(out_valid, top_scores, torch.full_like(top_scores, nms.NEG_INF)),
            out_valid)


def _levels(seed: int, b: int, delta_scale: float, tied: bool):
    """Per level: logits (B, n), deltas (B, n, 4) in (y, x, anchor) order,
    anchors (n, 4), for a 64x96 image (p6 holds 6 anchors: a level shorter
    than the others' top-k)."""
    rs = np.random.RandomState(seed)
    out = []
    for stride, size in zip(STRIDES, SIZES):
        fh, fw = -(-H // stride), -(-W // stride)
        anchors = anchors_for_level(fh, fw, stride, size, RATIOS)
        n = anchors.shape[0]
        logits = rs.randn(b, n).astype(np.float32)
        if tied:
            logits = np.round(logits, 0)            # many equal scores
        deltas = (rs.randn(b, n, 4) * delta_scale).astype(np.float32)
        out.append((logits, deltas, anchors))
    return out


CASES = [(0, 2, 0.3, False, 40), (1, 1, 1.0, False, 300), (2, 3, 0.5, True, 64),
         (3, 2, 3.0, True, 200)]


def _kw(pre_k):
    return dict(image_height=H, image_width=W, pre_nms_topk=pre_k, post_nms_topk=50,
                nms_thresh=0.7, min_size=0.0)


@pytest.mark.parametrize("seed,b,scale,tied,pre_k", CASES)
def test_one_stacked_nms_call_equals_the_per_level_loop(seed, b, scale, tied, pre_k):
    lv = _levels(seed, b, scale, tied)
    args = ([torch.from_numpy(l) for l, _, _ in lv], [torch.from_numpy(d) for _, d, _ in lv],
            [torch.from_numpy(a) for _, _, a in lv])
    assert min(a.shape[0] for a in args[2]) < pre_k    # a level shorter than N
    with tracing.recording() as rec:
        got = select_proposals(*args, **_kw(pre_k))
    assert rec.counter("nms.calls") == 1
    want = _select_per_level(*args, **_kw(pre_k))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any())


@pytest.mark.parametrize("seed,b,scale,tied,pre_k", CASES[2:3])
def test_stacked_selection_matches_jax_image_by_image(seed, b, scale, tied, pre_k):
    lv = _levels(seed, b, scale, tied)
    boxes, scores, valid = select_proposals(
        [torch.from_numpy(l) for l, _, _ in lv], [torch.from_numpy(d) for _, d, _ in lv],
        [torch.from_numpy(a) for _, _, a in lv], **_kw(pre_k))
    select_single = jax.jit(functools.partial(jrpn.select_proposals_single, **_kw(pre_k)))
    for i in range(b):
        jb, js, jv = select_single(
            [jnp.asarray(l[i].reshape(-1, 1, 1)) for l, _, _ in lv],
            [jnp.asarray(d[i].reshape(-1, 1, 4)) for _, d, _ in lv],
            [jnp.asarray(a) for _, _, a in lv])
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        ok = valid[i].numpy()
        np.testing.assert_allclose(boxes[i].numpy()[ok], np.asarray(jb)[ok],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(scores[i].numpy(), np.asarray(js))


@pytest.mark.parametrize("pad", [0, 1, 63, 200])
def test_padding_with_invalid_rows_leaves_the_keep_mask_unchanged(pad):
    rs = np.random.RandomState(pad)
    n = 70
    x1, y1 = rs.uniform(0, 80, (2, n)), rs.uniform(0, 50, (2, n))
    boxes = torch.from_numpy(np.stack([x1, y1, x1 + rs.uniform(2, 30, (2, n)),
                                       y1 + rs.uniform(2, 30, (2, n))], -1).astype(np.float32))
    scores = torch.from_numpy(np.round(rs.rand(2, n), 1).astype(np.float32))
    valid = torch.from_numpy(rs.rand(2, n) > 0.1)
    want = nms.nms_mask(boxes, scores, valid, 0.5)
    got = nms.nms_mask(torch.cat([boxes, torch.full((2, pad, 4), 7.0)], 1),
                       torch.cat([scores, torch.full((2, pad), 9.0)], 1),
                       torch.cat([valid, torch.zeros((2, pad), dtype=torch.bool)], 1), 0.5)
    assert torch.equal(got[:, :n], want) and not got[:, n:].any()


def _good():
    return torch.zeros((2, 5, 4)), torch.zeros((2, 5)), torch.ones((2, 5), dtype=torch.bool)


@pytest.mark.parametrize("bad,exc", [
    ("boxes_float64", TypeError), ("scores_float16", TypeError), ("valid_uint8", TypeError),
    ("boxes_not_xyxy", ValueError), ("scores_short", ValueError), ("valid_other_sets", ValueError),
    ("boxes_1d", ValueError)])
def test_nms_wrapper_rejects_wrong_dtypes_and_shapes(bad, exc):
    boxes, scores, valid = _good()
    if bad == "boxes_float64":
        boxes = boxes.double()
    elif bad == "scores_float16":
        scores = scores.half()
    elif bad == "valid_uint8":
        valid = valid.to(torch.uint8)
    elif bad == "boxes_not_xyxy":
        boxes = torch.zeros((2, 5, 5))
    elif bad == "scores_short":
        scores = scores[:, :4]
    elif bad == "valid_other_sets":
        valid = valid[:1]
    elif bad == "boxes_1d":
        boxes = torch.zeros(4)
    with tracing.recording() as rec, pytest.raises(exc):
        nms.nms_mask(boxes, scores, valid, 0.5)
    assert rec.counters == {}
    nms.nms_mask(*_good(), 0.5)                      # the good inputs pass
