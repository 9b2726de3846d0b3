"""The port's temporal stage against the JAX package, on the CPU.

Same seeded inputs through `articulation3d_tpu.temporal` and
`articulation3d_tpu_torch.temporal` (device="cpu"):

  * `track_planes` gives equal track dicts;
  * the rotation and translation sweeps at 60x80 give equal masks up to
    1e-3 of the pixels (float32 sums in another order can move a pixel
    that sits on a boundary);
  * planes that put pixels behind the camera and at z ~ 0 give the same
    masks: JAX truncates to int32 with saturation and then clips, the port
    clamps in float first; a port that casts first puts such a pixel in
    column 0 instead of W-1;
  * `iou_matrix` equals JAX's bucketed call within 1e-6, NaN rows included;
  * `optimize_planes('3dc')` under one `random.seed` gives the same
    `has_rot`, `std_axis`, scores, axes and cluster inliers on the clips of
    `tests/test_temporal.py` and on a rotating door at 120x160.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from articulation3d_tpu.data.axis_codec import axis_to_angle_offset as jax_encode
from articulation3d_tpu.structures import FramePrediction as JaxFramePrediction
from articulation3d_tpu.temporal import iou_matrix as jax_iou
from articulation3d_tpu.temporal import optimize_planes as jax_optimize
from articulation3d_tpu.temporal import rotation_sweep as jax_rotation_sweep
from articulation3d_tpu.temporal import track_planes as jax_track
from articulation3d_tpu.temporal import translation_sweep as jax_translation_sweep
from articulation3d_tpu.temporal import optimizer as jax_opt
from articulation3d_tpu.temporal.kernels import iou_matrix_bucketed
from articulation3d_tpu.utils.camera import FOCAL_OPT, intrinsics
from articulation3d_tpu.utils.coords import camera_to_plane
from articulation3d_tpu_torch.structures import FramePrediction
from articulation3d_tpu_torch.temporal import (iou_matrix, optimize_planes, rotation_sweep,
                                               track_planes, transform_normals,
                                               translation_sweep)
from articulation3d_tpu_torch.temporal import kernels as port_kernels
from articulation3d_tpu_torch.temporal import optimizer as port_opt
from test_temporal import H, W, base_mask, make_frame, seed_geometry, _rot_sequence

PIXEL_TOL = 1e-3        # share of sweep pixels that may differ from JAX
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _port(p) -> FramePrediction:
    return FramePrediction(p.boxes, p.scores, p.classes, p.masks, p.planes,
                           p.rot_axis, p.tran_axis)


def _jax_rot(mask, normal, offset, p0, dvec, angles, h, w):
    return np.asarray(jax_rotation_sweep(
        jnp.asarray(mask, jnp.float32), jnp.asarray(normal, jnp.float32), jnp.float32(offset),
        jnp.asarray(p0, jnp.float32), jnp.asarray(dvec, jnp.float32),
        jnp.asarray(angles, jnp.float32), h=h, w=w))


def _jax_trans(mask, normal, offset, dvec, steps, h, w):
    return np.asarray(jax_translation_sweep(
        jnp.asarray(mask, jnp.float32), jnp.asarray(normal, jnp.float32), jnp.float32(offset),
        jnp.asarray(dvec, jnp.float32), jnp.asarray(steps, jnp.float32), h=h, w=w))


def _port_rot(mask, normal, offset, p0, dvec, angles, h, w):
    return rotation_sweep(_t(mask), _t(normal), _t(offset), _t(p0), _t(dvec), _t(angles),
                          h=h, w=w).numpy()


def _port_trans(mask, normal, offset, dvec, steps, h, w):
    return translation_sweep(_t(mask), _t(normal), _t(offset), _t(dvec), _t(steps),
                             h=h, w=w).numpy()


def _differing(a, b) -> int:
    assert a.shape == b.shape
    return int(((a > 0.5) != (b > 0.5)).sum())


def _random_mask(rs, h, w):
    m = np.zeros((h, w), np.float32)
    y0, x0 = rs.randint(0, h // 2), rs.randint(0, w // 2)
    m[y0:y0 + rs.randint(5, h // 2), x0:x0 + rs.randint(5, w // 2)] = 1.0
    return m * (rs.rand(h, w) > 0.1)


ROT_ANGLES = np.arange(-np.pi / 2, np.pi, np.pi / 30)
TRANS_STEPS = np.arange(-1.0, 1.0, 0.1)


# --------------------------------------------------------------------------- #
# tracker
# --------------------------------------------------------------------------- #

def _equal_tracks(a, b):
    assert a.keys() == b.keys()
    for cat in a:
        assert len(a[cat]) == len(b[cat]), cat
        for ta, tb in zip(a[cat], b[cat]):
            assert ta["ids"] == tb["ids"] and ta["latest_frame"] == tb["latest_frame"]
            np.testing.assert_array_equal(ta["bbox"], tb["bbox"])


def test_track_planes_matches_jax():
    rs = np.random.RandomState(0)
    preds = _rot_sequence()
    for t in range(14):                    # a jittered box of each class
        m = np.zeros((H, W), np.float32)
        y0, x0 = 5 + rs.randint(0, 3), 45 + rs.randint(0, 3)
        m[y0:y0 + 15, x0:x0 + 20] = 1.0
        f = make_frame(m)
        f.classes[:] = t % 2
        preds.append(f)
    preds += [make_frame(_random_mask(rs, H, W)) for _ in range(6)]
    _equal_tracks(jax_track(preds), track_planes([_port(p) for p in preds]))


# --------------------------------------------------------------------------- #
# sweeps and IoU
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_sweep_matches_jax(seed):
    rs = np.random.RandomState(seed)
    normal, offset, p0, dvec = seed_geometry()
    mask = base_mask() if seed == 0 else _random_mask(rs, H, W)
    if seed == 2:                          # a tilted plane and a tilted axis
        normal = np.array([0.2, -0.3, 0.93])
        normal /= np.linalg.norm(normal)
        dvec = np.array([0.1, 0.98, 0.2])
        dvec /= np.linalg.norm(dvec)
    want = _jax_rot(mask, normal, offset, p0, dvec, ROT_ANGLES, H, W)
    got = _port_rot(mask, normal, offset, p0, dvec, ROT_ANGLES, H, W)
    assert got.shape == (len(ROT_ANGLES), H, W)
    assert _differing(got, want) <= PIXEL_TOL * want.size
    assert np.array_equal(got > 0.5, want > 0.5) or seed != 0


@pytest.mark.parametrize("seed", [0, 1])
def test_translation_sweep_matches_jax(seed):
    rs = np.random.RandomState(seed)
    normal, offset, _, dvec = seed_geometry(np.array([0.0, 20.0, 0.0], np.float32))
    mask = base_mask() if seed == 0 else _random_mask(rs, H, W)
    want = _jax_trans(mask, normal, offset, dvec, TRANS_STEPS, H, W)
    got = _port_trans(mask, normal, offset, dvec, TRANS_STEPS, H, W)
    assert got.shape == (len(TRANS_STEPS), H, W)
    assert _differing(got, want) <= PIXEL_TOL * want.size


def test_sweep_behind_camera_matches_jax():
    """A plane through the camera's horizon: the rows above it lift to
    points behind the camera, the rows next to it to points far away; the
    rotations carry some of them across z = 0."""
    mask = np.zeros((H, W), np.float32)
    mask[:8, 20:60] = 1.0                 # rows 0-3 behind, 4-7 far ahead
    normal = np.array([0.0, 1.0, 0.05])
    normal /= np.linalg.norm(normal)
    p0, dvec = np.array([0.1, 0.0, 2.0]), np.array([0.6, 0.0, 0.8])
    want = _jax_rot(mask, normal, 1.0, p0, dvec, ROT_ANGLES, H, W)
    got = _port_rot(mask, normal, 1.0, p0, dvec, ROT_ANGLES, H, W)
    assert _differing(got, want) <= PIXEL_TOL * want.size


def test_sweep_near_zero_depth_matches_jax():
    """The plane z = 2^-40 translated by -1 x (0, 0, 2^-40 - 2^-63): z
    becomes 2^-63 exactly while x moves by 0.3, so px ~ 1.4e21 (beyond
    int64) and py ~ +-2.5e8 (beyond neither).  JAX saturates px to INT_MAX
    and clips it to W-1; a cast before the clamp would give column 0.  The
    arithmetic is exact here, so the masks must be equal."""
    d = 2.0 ** -40
    mask = base_mask()
    normal = np.array([0.0, 0.0, 1.0])
    dvec = np.array([-0.3, 0.0, d - 2.0 ** -63])
    steps = np.array([-1.0, 0.0, 0.5])
    want = _jax_trans(mask, normal, d, dvec, steps, H, W)
    got = _port_trans(mask, normal, d, dvec, steps, H, W)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)
    assert (want[0, :, W - 1] > 0.5).sum() == 3 and (want[0] > 0.5).sum() == 3


def test_iou_matrix_matches_jax_bucketed():
    rs = np.random.RandomState(3)
    a = (rs.rand(5, H, W) > 0.6).astype(np.float32)
    a[2] = 0.0                                   # an empty hypothesis
    for f_n in (1, 3, 9):
        f = (rs.rand(f_n, H, W) > 0.5).astype(np.float32)
        f[0] = 0.0                               # 0/0 -> NaN against a[2]
        want = iou_matrix_bucketed(f, jnp.asarray(a))
        got = iou_matrix(_t(f), _t(a)).numpy()
        assert got.shape == want.shape == (f_n, 5)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[0, 2])
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    unbucketed = np.asarray(jax_iou(jnp.asarray(f), jnp.asarray(a)))
    np.testing.assert_allclose(iou_matrix(_t(f), _t(a)).numpy(), unbucketed, atol=1e-6)


def test_iou_matrix_counts_exact_under_autocast():
    """Counts stay exact with bf16 autocast on around the call."""
    rs = np.random.RandomState(4)
    f = (rs.rand(2, 300, 400) > 0.3).astype(np.float32)
    a = (rs.rand(3, 300, 400) > 0.3).astype(np.float32)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = iou_matrix(_t(f), _t(a))
    assert got.dtype == torch.float32
    inter = np.einsum("fp,ap->fa", f.reshape(2, -1), a.reshape(3, -1))
    union = f.reshape(2, -1).sum(1)[:, None] + a.reshape(3, -1).sum(1)[None] - inter
    np.testing.assert_allclose(got.numpy(), inter / union, rtol=1e-6)


def test_transform_normals_matches_jax():
    from articulation3d_tpu.temporal import transform_normals as jax_tn
    normal, _, _, dvec = seed_geometry()
    angles = np.arange(-np.pi / 2, np.pi / 2, np.pi / 30)
    want = np.asarray(jax_tn(jnp.asarray(normal, jnp.float32), jnp.asarray(dvec, jnp.float32),
                             jnp.asarray(angles, jnp.float32)))
    got = transform_normals(_t(normal), _t(dvec), _t(angles)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sweeps_need_no_matmul_precision():
    """The point transform is elementwise: TF32/precision settings and
    autocast leave the sweep's masks unchanged."""
    normal, offset, p0, dvec = seed_geometry()
    ref = _port_rot(base_mask(), normal, offset, p0, dvec, ROT_ANGLES, H, W)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = _port_rot(base_mask(), normal, offset, p0, dvec, ROT_ANGLES, H, W)
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(got, ref)
    assert port_kernels.pixel_rays(H, W, CPU).dtype == torch.float32


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #

def _trans_clip():
    plane_stored = np.array([0.0, 20.0, 0.0], np.float32)
    normal, offset, _, dvec = seed_geometry(plane_stored)
    proj = _jax_trans(base_mask(), normal, offset, dvec, np.arange(10) * 0.1, H, W)
    preds = []
    for t in range(10):
        f = make_frame(proj[t], plane=plane_stored)
        f.classes[:] = 1
        preds.append(f)
    return preds


def _door_clip(h=120, w=160, n=24):
    """A planar door rotating about a vertical hinge, rendered with the
    optimizer's own camera (f = 517.97 about the image center)."""
    import cv2
    k = intrinsics(h, w, FOCAL_OPT)
    proj = lambda p: (p @ k.T)[:, :2] / (p @ k.T)[:, 2:3]
    a, b = np.array([-0.3, -0.25, 3.0]), np.array([-0.3, 0.25, 3.0])
    preds = []
    for theta in np.linspace(-0.4, 0.4, n):
        d = np.array([np.cos(theta), 0.0, np.sin(theta)])
        quad = proj(np.stack([a, b, b + 0.5 * d, a + 0.5 * d]))
        mask = np.zeros((h, w), np.uint8)
        cv2.fillPoly(mask, [np.round(quad).astype(np.int32)], 1)
        ys, xs = np.nonzero(mask)
        box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)
        nrm = np.array([-np.sin(theta), 0.0, np.cos(theta)])
        enc = jax_encode(proj(np.stack([a, b])).reshape(4)[None],
                         ((box[:2] + box[2:]) / 2.0)[None])[0]
        preds.append(JaxFramePrediction(
            boxes=box[None], scores=np.array([0.9]), classes=np.array([0]),
            masks=mask[None].astype(bool), planes=camera_to_plane(nrm * (nrm @ a))[None],
            rot_axis=enc[None, :3], tran_axis=np.zeros((1, 2), np.float32)))
    return preds


def _check_optimize(preds, h, w, seed):
    ported = [_port(p) for p in preds]
    random.seed(seed)
    jt = jax_track(preds)
    jopt = jax_optimize(preds, jt, "3dc", h=h, w=w)
    jstate = random.getstate()
    random.seed(seed)
    pt = track_planes(ported)
    popt = optimize_planes(ported, pt, "3dc", h=h, w=w, device="cpu")
    assert random.getstate() == jstate          # the same random calls
    assert sum(len(v) for v in pt.values()) > 0
    for cat in ("rot", "trans"):
        for ja, pa in zip(jt[cat], pt[cat]):
            assert ja["has_rot"] == pa["has_rot"], cat
            if ja["has_rot"]:
                np.testing.assert_array_equal(pa["std_axis"], ja["std_axis"])
                assert ja["reg_masks"].keys() == pa["reg_masks"].keys()
                for idx in ja["reg_masks"]:
                    assert _differing(pa["reg_masks"][idx], ja["reg_masks"][idx]) \
                        <= PIXEL_TOL * h * w
                for idx in ja.get("reg_normals", {}):
                    np.testing.assert_allclose(pa["reg_normals"][idx],
                                               ja["reg_normals"][idx], atol=1e-6)
    for a, b in zip(jopt, popt):
        np.testing.assert_array_equal(b.scores, a.scores)
        np.testing.assert_array_equal(b.rot_axis, a.rot_axis)
        np.testing.assert_array_equal(b.tran_axis, a.tran_axis)
    return jt, pt, popt


@pytest.mark.parametrize("seed", [2020, 7])
def test_optimize_rotation_clip_matches_jax(seed):
    jt, pt, _ = _check_optimize(_rot_sequence(), H, W, seed)
    assert pt["rot"][0]["has_rot"] is True


def test_optimize_translation_clip_matches_jax():
    jt, pt, _ = _check_optimize(_trans_clip(), H, W, 2020)
    assert pt["trans"][0]["has_rot"] is True


def test_cluster_pass_matches_jax():
    """The RANSAC rounds themselves: seeds, inliers (with the CPython
    remove-while-iterating skip), best angles and IoUs."""
    preds = _rot_sequence()
    ported = [_port(p) for p in preds]
    for kind, hyp in (("rot", ROT_ANGLES), ("trans", TRANS_STEPS)):
        random.seed(5)
        plane = jax_track(preds)["rot"][0]
        want = jax_opt._cluster_pass(preds, plane, kind, hyp, H, W)
        random.seed(5)
        pplane = track_planes(ported)["rot"][0]
        masks = port_opt._track_masks(ported, pplane, CPU)
        got = port_opt._cluster_pass(ported, pplane, kind, hyp, H, W, masks)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert a["center_id"] == b["center_id"] and a["inliners"] == b["inliners"]
            np.testing.assert_array_equal(b["angles"], a["angles"])
            np.testing.assert_allclose(b["ious"], a["ious"], atol=1e-6)
        assert any(len(c["inliners"]) for c in got)


def test_door_clip_matches_jax():
    jt, pt, popt = _check_optimize(_door_clip(), 120, 160, 2020)
    assert len(pt["rot"]) == 1 and pt["rot"][0]["has_rot"] is True
    for p in popt:
        np.testing.assert_allclose(p.scores, 0.9)


def test_optimize_average_matches_jax():
    """The mean-axis baseline takes a list of tracks (as in JAX, the
    tracker's dict itself is not accepted) and needs no device."""
    preds = _rot_sequence()
    ported = [_port(p) for p in preds]
    jt, pt = jax_track(preds)["rot"], track_planes(ported)["rot"]
    want = jax_optimize(preds, jt, "average")
    got = optimize_planes(ported, pt, "average")
    np.testing.assert_array_equal(pt[0]["std_axis"], jt[0]["std_axis"])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.rot_axis, a.rot_axis)
        np.testing.assert_array_equal(b.scores, a.scores)
    with pytest.raises(TypeError):
        optimize_planes(ported, track_planes(ported), "average")


def test_frame_prediction_copy_and_box_centers():
    """`copy()` gives new axis and score arrays (the optimizer writes into
    them) and shares the masks, as the JAX one does."""
    p = _port(_rot_sequence(6)[5])
    q = p.copy()
    for name in ("boxes", "scores", "classes", "planes", "rot_axis", "tran_axis"):
        assert not np.shares_memory(getattr(p, name), getattr(q, name)), name
        np.testing.assert_array_equal(getattr(p, name), getattr(q, name))
    assert q.masks is p.masks
    q.rot_axis[0] = 7.0
    q.scores[:] = 0.0
    assert (p.rot_axis != 7.0).all() and (p.scores > 0).all()
    np.testing.assert_array_equal(p.box_centers, (p.boxes[:, :2] + p.boxes[:, 2:]) / 2.0)
    np.testing.assert_array_equal(p.box_centers, _rot_sequence(6)[5].box_centers)


def test_optimize_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    preds = [_port(p) for p in _rot_sequence()]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize_planes(preds, track_planes(preds), "3dc", h=H, w=W)
