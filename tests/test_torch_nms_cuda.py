"""The NMS CUDA kernel (K4, `csrc/nms.cu`) against its plain torch version
(`ops/nms.py::nms_mask_sweep`), on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit (from the repository root):

    python -m pytest tests/test_torch_nms_cuda.py --noconftest -m cuda -q

Elsewhere each test skips itself.  The keep masks must be equal bit for
bit: both visit each set in the order of one stable sort and compute
`box_ops.pairwise_iou` with the same float32 operations.  Cases: the main
path's sets as `select_proposals` builds them (training 16 x 5 x 2000,
inference 1 x 5 x 1000, from anchors and random deltas at 480x640), the
class NMS over 1000 proposals x 2 classes with its class offsets, and
adversarial sets: IoUs within a few ulps of 0.7 and 0.5 (some exactly at
the threshold), equal scores, all-invalid sets, N not a multiple of 64,
zero-area and duplicated boxes, non-finite boxes marked invalid, valid
boxes with coordinates near 3e12 (past the kernel's division-free path).
"""

import numpy as np
import pytest
import torch

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.models import rpn as rpn_mod
from articulation3d_tpu_torch.models.rpn import anchors_for_level, select_proposals
from articulation3d_tpu_torch.ops import nms
from articulation3d_tpu_torch.ops.box_ops import clip_boxes, decode_deltas, pairwise_iou

LEVELS = ((120, 160), (60, 80), (30, 40), (15, 20), (8, 10))   # p2..p6 at 480x640
STRIDES, SIZES = (4, 8, 16, 32, 64), (32, 64, 128, 256, 512)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _equal_to_plain(boxes, scores, valid, t):
    """K4's keep mask (one launch, no host wait) equals the plain version's."""
    with tracing.recording() as rec:
        got = nms.nms_mask(boxes, scores, valid, t)
    sets = valid.numel() // valid.shape[-1] if valid.numel() else 0
    assert rec.counter("nms.launches") == (1 if sets else 0)
    assert rec.counter("nms.sets") == sets and "sync.nms" not in rec.counters
    want = nms.nms_mask_sweep(boxes, scores, valid, t)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == valid.shape
    assert torch.equal(got, want), int((got != want).sum())
    assert not bool((got & ~valid).any())
    return got


def _rpn_sets(monkeypatch, b: int, pre_k: int, seed: int, scale: float = 0.3):
    """The (B, 5, N) sets `select_proposals` hands to `nms_mask` for random
    logits and deltas on 480x640 anchors."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits, deltas, anchors = [], [], []
    for (h, w), stride, size in zip(LEVELS, STRIDES, SIZES):
        a = torch.from_numpy(anchors_for_level(h, w, stride, size, (0.5, 1.0, 2.0))).cuda()
        logits.append(torch.randn((b, a.shape[0]), generator=gen, device="cuda"))
        deltas.append(torch.randn((b, a.shape[0], 4), generator=gen, device="cuda") * scale)
        anchors.append(a)
    seen = []
    monkeypatch.setattr(rpn_mod, "nms_mask", lambda *a: seen.append(a) or nms.nms_mask(*a))
    out = select_proposals(logits, deltas, anchors, image_height=480, image_width=640,
                           pre_nms_topk=pre_k, post_nms_topk=pre_k // 2, nms_thresh=0.7,
                           min_size=0.0)
    assert len(seen) == 1
    return seen[0], out


@pytest.mark.cuda
@pytest.mark.parametrize("b,pre_k,n", [(16, 2000, 2000), (1, 1000, 1000)],
                         ids=["train", "infer"])
def test_rpn_sets_match_the_plain_version(monkeypatch, b, pre_k, n):
    _card()
    (boxes, scores, valid, t), _ = _rpn_sets(monkeypatch, b, pre_k, seed=b)
    assert boxes.shape == (b, 5, n, 4)
    assert valid[:, 4, 240:].sum() == 0 and valid[:, 3, 900:].sum() == 0   # padded rows
    keep = _equal_to_plain(boxes, scores, valid, t)
    assert 0 < int(keep.sum()) < int(valid.sum())


@pytest.mark.cuda
def test_class_nms_with_class_offsets_matches_the_plain_version(monkeypatch):
    _card()
    _, (prop, _, prop_valid) = _rpn_sets(monkeypatch, 1, 2000, seed=5)   # 1000 proposals
    gen = torch.Generator(device="cuda").manual_seed(6)
    r, c = prop.shape[1], 2
    probs = torch.softmax(torch.randn((1, r, c + 1), generator=gen, device="cuda") * 2,
                          -1)[..., :c]
    d = torch.randn((1, r, c, 4), generator=gen, device="cuda")
    boxes = clip_boxes(decode_deltas(d, prop[:, :, None, :], (10.0, 10.0, 5.0, 5.0)),
                       480, 640).reshape(1, r * c, 4)
    scores = probs.reshape(1, r * c)
    classes = torch.arange(c, device="cuda").repeat(r)[None]
    valid = prop_valid.repeat_interleave(c, dim=1) & (scores > 0.05)
    with tracing.recording() as rec:
        got = nms.batched_nms_mask(boxes, scores, classes, valid, 0.5)
    assert rec.counter("nms.launches") == 1 and rec.counter("nms.sets") == 1
    monkeypatch.setattr(nms, "nms_mask", nms.nms_mask_sweep)
    want = nms.batched_nms_mask(boxes, scores, classes, valid, 0.5)
    assert got.shape == (1, 2000) and torch.equal(got, want)
    assert 0 < int(got.sum()) < int(valid.sum())


def _near_threshold(t: float, sets: int, seed: int):
    """Pairs of boxes (one set each) whose IoU lies within a few ulps of t:
    unit boxes [0, 0, 1, y] inside [0, 0, 1, 1] with y stepped by single
    ulps around t, and random boxes with one edge moved so the IoU is about
    t, then nudged by -3..3 ulps."""
    rs = np.random.RandomState(seed)
    y = np.float32(t)
    ys = [y]
    for _ in range(8):
        ys = [np.nextafter(ys[0], np.float32(0))] + ys + [np.nextafter(ys[-1], np.float32(1))]
    unit = [[[0, 0, 1, 1], [0, 0, 1, v]] for v in ys]
    x1, y1 = rs.uniform(0, 500, sets), rs.uniform(0, 400, sets)
    w, h = rs.uniform(5, 120, sets), rs.uniform(5, 120, sets)
    a = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    bb = a.copy()
    bb[:, 3] = (a[:, 1] + np.float32(t) * (a[:, 3] - a[:, 1])).astype(np.float32)
    for i, k in enumerate(rs.randint(-3, 4, sets)):
        for _ in range(abs(k)):
            bb[i, 3] = np.nextafter(bb[i, 3], np.float32(np.inf if k > 0 else -np.inf))
    pairs = np.concatenate([np.asarray(unit, np.float32), np.stack([a, bb], 1)], 0)
    return torch.from_numpy(pairs).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.7, 0.5])
def test_ious_within_ulps_of_the_threshold(t):
    _card()
    boxes = _near_threshold(t, 400, seed=int(t * 10))
    iou = pairwise_iou(boxes, boxes)[:, 0, 1]
    ft = torch.tensor(t, dtype=torch.float32)
    # the cases straddle the threshold, some exactly on it
    assert bool((iou == ft).any() and (iou > ft).any() and (iou < ft).any())
    s = boxes.shape[0]
    scores = torch.tensor([1.0, 0.5], device="cuda").expand(s, 2).contiguous()
    valid = torch.ones((s, 2), dtype=torch.bool, device="cuda")
    keep = _equal_to_plain(boxes, scores, valid, t)
    assert torch.equal(keep[:, 1], iou <= ft)
    # the same pairs as one set of N = 2 x S, far apart from each other
    shift = torch.arange(s, device="cuda", dtype=torch.float32)[:, None, None] * 2000.0
    flat = (boxes + shift).reshape(1, 2 * s, 4)
    _equal_to_plain(flat, scores.reshape(1, -1), valid.reshape(1, -1), t)


def _random_sets(rs, s, n, *, spread=200.0, tie=False, p_valid=0.8):
    x1, y1 = rs.uniform(0, spread, (s, n)), rs.uniform(0, spread, (s, n))
    w, h = rs.uniform(0, 60, (s, n)), rs.uniform(0, 60, (s, n))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    scores = (np.full((s, n), 0.5) if tie else np.round(rs.rand(s, n), 2)).astype(np.float32)
    valid = rs.rand(s, n) < p_valid
    return boxes, scores, valid


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 127, 129, 1000, 2001])
def test_set_sizes_that_are_not_multiples_of_64(n):
    _card()
    rs = np.random.RandomState(n)
    boxes, scores, valid = _random_sets(rs, 3, n)
    valid[1] = False                                          # an all-invalid set
    cuda = [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]
    for t in (0.7, 0.5, 0.3):
        keep = _equal_to_plain(*cuda, t)
        assert not bool(keep[1].any())


@pytest.mark.cuda
def test_equal_scores_keep_the_stable_order():
    _card()
    rs = np.random.RandomState(11)
    boxes, scores, valid = _random_sets(rs, 4, 300, spread=60.0, tie=True)
    cuda = [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]
    keep = _equal_to_plain(*cuda, 0.5)
    # with every score equal the first valid box of each set is kept
    first = valid.argmax(1)
    assert all(bool(keep[i, first[i]]) for i in range(4))


@pytest.mark.cuda
def test_degenerate_boxes_and_invalid_non_finite_ones():
    _card()
    rs = np.random.RandomState(12)
    boxes, scores, valid = _random_sets(rs, 2, 500, spread=100.0)
    boxes[:, ::5, 2] = boxes[:, ::5, 0]                        # zero width
    boxes[:, 1::5, 3] = boxes[:, 1::5, 1]                      # zero height
    boxes[:, 2::5] = boxes[:, 3::5]                            # duplicates
    scores[:, 2::5] = scores[:, 3::5]
    boxes[:, 4::25] = np.nan                                   # non-finite, invalid
    boxes[:, 9::25, 2] = np.inf
    valid[:, 4::25] = valid[:, 9::25] = False
    boxes[:, 14::25] *= np.float32(3e12)                       # huge, finite, valid
    boxes[:, 19::25] = boxes[:, 14::25] * np.float32(1.01)
    valid[:, 0::5] = True
    cuda = [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]
    for t in (0.0, 1e-7, 0.5, 0.7):
        _equal_to_plain(*cuda, t)


@pytest.mark.cuda
def test_all_invalid_and_empty_calls():
    _card()
    boxes = torch.rand((3, 5, 70, 4), device="cuda")
    scores = torch.rand((3, 5, 70), device="cuda")
    keep = _equal_to_plain(boxes, scores, torch.zeros((3, 5, 70), dtype=torch.bool,
                                                      device="cuda"), 0.7)
    assert not bool(keep.any())
    _equal_to_plain(boxes[:, :, :0], scores[:, :, :0],
                    torch.zeros((3, 5, 0), dtype=torch.bool, device="cuda"), 0.7)
