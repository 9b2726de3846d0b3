"""Port vs JAX: target assignment, sampling and losses (`train/targets.py`).

The same numpy inputs go through both packages.  Sampling draws differ
between `jax.random` and `torch.Generator`, so the port's one draw function
`targets._uniform` is replaced by the JAX package's uniforms for the same
keys (per image: the positive priorities, then the negative ones, as JAX
`subsample_labels` splits its key).  Tolerances: integer outputs (matches,
labels, sampled masks, classes, thresholded mask crops) exactly; losses
within 1e-5 relative (float32 reductions in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.train import targets as jt

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.train import targets as pt

H, W = 64, 80
OVERRIDES = {"model": {"roi_heads": {"batch_size_per_image": 16},
                       "rpn": {"batch_size_per_image": 32}},
             "input": {"height": H, "width": W}}


def _cfgs(overrides=OVERRIDES):
    return jcfg.load_config(overrides=overrides), pcfg.load_config(overrides=overrides)


def _t(a):
    return torch.from_numpy(np.asarray(a))


class _Draws:
    """Stands in for `targets._uniform`: hands out the JAX draws in order."""

    def __init__(self, arrays):
        self.queue = [np.array(a, np.float32) for a in arrays]

    def __call__(self, generator, n, device):
        a = self.queue.pop(0)
        assert a.shape == (n,), (a.shape, n)
        return torch.from_numpy(a).to(device)


def _jax_draws(image_keys, n):
    """What JAX `subsample_labels` draws for each per-image key."""
    out = []
    for k in image_keys:
        kp, kn = jax.random.split(k)
        out += [jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))]
    return out


def _gens(b):
    return pt.per_image_keys(torch.Generator().manual_seed(0), b)


def _gt(rs, b=2, g=4):
    x1 = rs.uniform(0, W - 30, (b, g))
    y1 = rs.uniform(0, H - 30, (b, g))
    boxes = np.stack([x1, y1, x1 + rs.uniform(8, 30, (b, g)),
                      y1 + rs.uniform(8, 30, (b, g))], -1).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[0, -1] = False                 # a padded GT row
    classes = rs.randint(0, 2, (b, g)).astype(np.int32)
    return boxes, classes, valid


def _proposals(rs, gt_boxes, k=24):
    """Jittered GT boxes (foreground) and random boxes (background)."""
    b, g = gt_boxes.shape[:2]
    jit = gt_boxes[:, rs.randint(0, g, k // 2)] + rs.uniform(-4, 4, (b, k // 2, 4))
    x1 = rs.uniform(0, W - 20, (b, k - k // 2))
    y1 = rs.uniform(0, H - 20, (b, k - k // 2))
    rnd = np.stack([x1, y1, x1 + rs.uniform(4, 20, x1.shape),
                    y1 + rs.uniform(4, 20, y1.shape)], -1)
    boxes = np.concatenate([jit, rnd], 1).astype(np.float32)
    valid = rs.rand(b, k) > 0.15
    return boxes, valid


@pytest.mark.parametrize("low_quality", [True, False])
def test_match_anchors_matches_jax(low_quality):
    rs = np.random.RandomState(0)
    iou = rs.uniform(0, 1, (3, 40, 5)).astype(np.float32)
    iou[0, 7] = iou[0, 9]                 # tied rows
    iou[1, :, 2] = 0.4                    # a GT whose best IoU is shared
    gt_valid = np.asarray([[1, 1, 1, 0, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], bool)
    idx, labels = pt.match_anchors(_t(iou), _t(gt_valid), 0.3, 0.7, low_quality)
    for i in range(3):
        jidx, jlab = jt.match_anchors(jnp.asarray(iou[i]), jnp.asarray(gt_valid[i]),
                                      0.3, 0.7, low_quality)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jlab))


def test_subsample_labels_matches_jax(monkeypatch):
    rs = np.random.RandomState(1)
    labels = rs.choice([-1, 0, 1], size=(3, 200), p=[0.2, 0.7, 0.1]).astype(np.int64)
    labels[2, :] = np.where(labels[2] == 1, 0, labels[2])      # no positives
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    monkeypatch.setattr(pt, "_uniform", _Draws(_jax_draws(keys, 200)))
    pos, neg = pt.subsample_labels(_t(labels), 64, 0.25, _gens(3))
    for i in range(3):
        jp, jn = jt.subsample_labels(jnp.asarray(labels[i]), 64, 0.25, keys[i])
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(jn))
    assert int(pos[0].sum()) == 16 and int((pos | neg)[0].sum()) == 64


def test_per_image_keys_are_distinct_and_reproducible():
    a = [torch.rand(4, generator=g) for g in _gens(3)]
    b = [torch.rand(4, generator=g) for g in _gens(3)]
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])


def test_rpn_losses_match_jax(monkeypatch):
    jc, pc = _cfgs()
    rs = np.random.RandomState(2)
    gt_boxes, _, gt_valid = _gt(rs)
    gt_valid[1] = False                  # an image without GT: all negatives
    levels = [(16, 20), (8, 10)]
    a = 3
    anchors, logits, deltas = [], [], []
    for h, w in levels:
        cx = rs.uniform(0, W, (h * w * a, 1))
        cy = rs.uniform(0, H, (h * w * a, 1))
        sz = rs.uniform(6, 40, (h * w * a, 2))
        anchors.append(np.concatenate([cx - sz[:, :1] / 2, cy - sz[:, 1:] / 2,
                                       cx + sz[:, :1] / 2, cy + sz[:, 1:] / 2],
                                      1).astype(np.float32))
        logits.append(rs.randn(2, h, w, a).astype(np.float32))
        deltas.append(0.1 * rs.randn(2, h, w, 4 * a).astype(np.float32))
    n = sum(x.shape[0] for x in anchors)
    key = jax.random.PRNGKey(5)
    monkeypatch.setattr(pt, "_uniform", _Draws(_jax_draws(jax.random.split(key, 2), n)))
    want = jt.rpn_losses({"logits": [jnp.asarray(x) for x in logits],
                          "deltas": [jnp.asarray(x) for x in deltas],
                          "anchors": [jnp.asarray(x) for x in anchors]},
                         jnp.asarray(gt_boxes), jnp.asarray(gt_valid), key, jc)
    raw = {"logits": [_t(x.reshape(2, -1)) for x in logits],
           "deltas": [_t(x.reshape(2, -1, 4)) for x in deltas],
           "anchors": [_t(x) for x in anchors]}
    got = pt.rpn_losses(raw, _t(gt_boxes), _t(gt_valid), _gens(2), pc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _sampled(monkeypatch, rs, jc, pc, key):
    gt_boxes, gt_classes, gt_valid = _gt(rs)
    props, pvalid = _proposals(rs, gt_boxes)
    n = props.shape[1] + gt_boxes.shape[1]
    monkeypatch.setattr(pt, "_uniform", _Draws(_jax_draws(jax.random.split(key, 2), n)))
    want = jt.sample_rois(jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt_boxes),
                          jnp.asarray(gt_classes), jnp.asarray(gt_valid), key, jc)
    got = pt.sample_rois(_t(props), _t(pvalid), _t(gt_boxes), _t(gt_classes),
                         _t(gt_valid), _gens(2), pc)
    return got, want, (gt_boxes, gt_classes, gt_valid)


def test_sample_rois_match_jax(monkeypatch):
    jc, pc = _cfgs()
    got, want, _ = _sampled(monkeypatch, np.random.RandomState(3), jc, pc,
                            jax.random.PRNGKey(7))
    assert got.boxes.shape == (2, 16, 4)
    for name in ("classes", "matched_idx", "is_sampled", "is_fg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    assert 0 < int(got.is_fg.sum()) <= 2 * 4 and bool(got.is_sampled.all())


def test_crop_gt_masks_match_jax():
    rs = np.random.RandomState(4)
    masks = np.zeros((3, H, W), np.float32)
    for i in range(3):
        y, x = rs.randint(0, H - 20), rs.randint(0, W - 20)
        masks[i, y:y + rs.randint(5, 20), x:x + rs.randint(5, 20)] = 1.0
    masks[2] = rs.rand(H, W) > 0.5
    boxes, _ = _proposals(rs, _gt(rs, b=1, g=3)[0], k=20)
    idx = rs.randint(0, 3, 20)
    want = np.asarray(jt.crop_gt_masks(jnp.asarray(masks), jnp.asarray(idx),
                                       jnp.asarray(boxes[0]), 28, chunk=8))
    got = pt.crop_gt_masks(_t(masks), _t(idx), _t(boxes[0]), 28, chunk=8)
    assert got.shape == (20, 28, 28) and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_detection_losses_match_jax(monkeypatch):
    jc, pc = _cfgs()
    rs = np.random.RandomState(5)
    got_rois, want_rois, (gt_boxes, gt_classes, gt_valid) = _sampled(
        monkeypatch, rs, jc, pc, jax.random.PRNGKey(9))
    b, s, g, m, nc = 2, 16, gt_boxes.shape[1], 28, 2
    gt = {"boxes": gt_boxes, "classes": gt_classes, "valid": gt_valid,
          "masks": (rs.rand(b, g, H, W) > 0.5).astype(np.float32),
          "planes": rs.randn(b, g, 3).astype(np.float32),
          "rot_axis": np.concatenate([rs.randn(b, g, 3), rs.rand(b, g, 1) > 0.3],
                                     -1).astype(np.float32),
          "tran_axis": np.concatenate([rs.randn(b, g, 3), rs.rand(b, g, 1) > 0.3],
                                      -1).astype(np.float32),
          "depth": np.where(rs.rand(b, H, W) > 0.2, rs.uniform(0.5, 5, (b, H, W)),
                            0.0).astype(np.float32)}
    mask_logits = rs.randn(b, s, m, m, 1).astype(np.float32)
    outputs = {"box_scores": rs.randn(b, s, nc + 1), "box_deltas": rs.randn(b, s, 4 * nc),
               "plane_pred": rs.randn(b, s, 3), "rot_pred": rs.randn(b, s, 3),
               "tran_pred": rs.randn(b, s, 2), "depth_pred": rs.uniform(0.5, 5, (b, H, W))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    want = jt.detection_losses(
        {**{k: jnp.asarray(v) for k, v in outputs.items()},
         "mask_logits": jnp.asarray(mask_logits)},
        want_rois, {k: jnp.asarray(v) for k, v in gt.items()}, jc)
    got = pt.detection_losses(
        {**{k: _t(v) for k, v in outputs.items()},
         "mask_logits": _t(mask_logits.transpose(0, 1, 4, 2, 3))},   # NCHW heads
        got_rois, {k: _t(v) for k, v in gt.items()}, pc)
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg", "loss_mask", "loss_plane",
                                     "loss_rot_axis", "loss_tran_axis", "depth_loss"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
