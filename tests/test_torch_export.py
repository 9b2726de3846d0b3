"""The port's mesh export against the JAX package, on the CPU.

  * `triangulate` (the port's own build of the C++ ear-clipper) gives the
    same triangles as JAX's native library on the polygons of
    `tests/test_export.py` and on random star polygons;
  * mask -> polygon and the textured plane meshes are equal;
  * `save_obj_model` on the synthetic prediction of `tests/test_export.py`
    and on one optimised door frame, with and without `webvis`, writes the
    same files: `.mtl` byte-equal, `.obj` byte-equal except the `v` lines
    of the five swept copies, whose float32 rotation matrix may differ from
    XLA's by an ulp (held within 1e-6 of each vertex's largest coordinate),
    and pixel-equal uv maps.
"""

import os

import cv2
import numpy as np
import pytest

from articulation3d_tpu.data.axis_codec import axis_to_angle_offset
from articulation3d_tpu.export import binary_mask_to_polygon as jax_polygon
from articulation3d_tpu.export import get_single_image_mesh_arti as jax_mesh
from articulation3d_tpu.export import save_obj_model as jax_save_obj_model
from articulation3d_tpu.export import triangulate as jax_triangulate
from articulation3d_tpu.native import have_native
from articulation3d_tpu.structures import FramePrediction as JaxFramePrediction
from articulation3d_tpu_torch import native
from articulation3d_tpu_torch.export import (binary_mask_to_polygon, get_single_image_mesh_arti,
                                             save_obj_model, triangulate)
from articulation3d_tpu_torch.structures import FramePrediction

SWEPT_MESHES = {1, 2, 3, 4, 5}     # "# mesh k" sections holding the sweep's copies


def _port(p) -> FramePrediction:
    return FramePrediction(p.boxes, p.scores, p.classes, p.masks, p.planes,
                           p.rot_axis, p.tran_axis)


def _star(seed, n):
    rs = np.random.RandomState(seed)
    ang = np.sort(rs.uniform(0, 2 * np.pi, n))
    r = rs.uniform(1, 2, n) * (1 + (np.arange(n) % 2))
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1) * 50 + 200
    return pts.astype(np.float32)


POLYGONS = {
    "square": np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32),
    "concave_l": np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], np.float32),
    "random_12": _star(0, 12) / 100.0,
    "star_9": _star(1, 9),
    "star_31": _star(2, 31),
    "clockwise_star_20": _star(3, 20)[::-1].copy(),
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_triangulate_matches_jax(name):
    assert have_native(), "the JAX package's native ear-clipper must be the reference"
    poly = POLYGONS[name]
    got = triangulate(poly)
    assert got.dtype == np.int32 and got.shape[0] >= 1
    np.testing.assert_array_equal(got, jax_triangulate(poly))


def test_native_builds_into_the_build_dir():
    path = native.build()
    assert os.path.exists(path) and path == native.lib_path()
    assert os.path.dirname(path).endswith(os.path.join("articulation3d_tpu_torch", "_build"))
    assert triangulate(POLYGONS["square"][:2]).shape == (0, 3)


def _masks():
    rs = np.random.RandomState(0)
    m1 = np.zeros((480, 640), np.float32)
    m1[100:300, 200:400] = 1
    m2 = np.zeros((480, 640), np.uint8)
    cv2.fillPoly(m2, [_star(4, 14).astype(np.int32) + 50], 1)
    m3 = (rs.rand(480, 640) > 0.995).astype(np.float32)       # specks
    m3[300:420, 50:90] = 1
    return [m1, m2, m3]


def test_binary_mask_to_polygon_matches_jax():
    for m in _masks():
        assert binary_mask_to_polygon(m) == jax_polygon(m)


@pytest.mark.parametrize("webvis", [False, True])
def test_plane_meshes_match_jax(webvis):
    img = np.random.RandomState(1).randint(0, 255, (480, 640, 3), np.uint8)
    masks = np.stack(_masks())
    planes = np.array([[0.0, 2.0, 0.0], [0.3, 3.0, 0.4], [-0.2, 1.5, 0.1]])
    want, want_uv = jax_mesh(planes, masks, img, webvis=webvis)
    got, got_uv = get_single_image_mesh_arti(planes, masks, img, webvis=webvis)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.verts, b.verts)
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_array_equal(a.verts_uvs, b.verts_uvs)
        np.testing.assert_array_equal(a.uv_map, b.uv_map)
    for a, b in zip(got_uv, want_uv):
        np.testing.assert_array_equal(a, b)


def _synthetic_prediction(cls=JaxFramePrediction):
    """The prediction of `tests/test_export.py::test_save_obj_and_model`."""
    mask = np.zeros((480, 640), np.float32)
    mask[100:300, 200:400] = 1
    center = np.array([[300.0, 200.0]])
    rot = axis_to_angle_offset(np.array([[200.0, 50, 200, 400]]), center)[0][:3]
    return cls(boxes=np.array([[200, 100, 400, 300]], np.float32),
               scores=np.array([0.9]), classes=np.array([0]), masks=mask[None],
               planes=np.array([[0.0, 2.0, 0.0]], np.float32), rot_axis=rot[None],
               tran_axis=np.array([[0.0, 1.0]], np.float32))


def _door_prediction():
    """Frame 0 of the door clip after JAX's '3dc' fit, at 120x160."""
    import random

    from articulation3d_tpu.temporal import optimize_planes, track_planes
    from test_torch_temporal import _door_clip
    preds = _door_clip()
    random.seed(2020)
    opt = optimize_planes(preds, track_planes(preds), "3dc", h=120, w=160)
    return opt[0]


def _compare_obj_dirs(a_dir, b_dir):
    """a: the port's frame_XXXX directory, b: JAX's."""
    assert sorted(os.listdir(a_dir)) == sorted(os.listdir(b_dir))
    assert sorted(os.listdir(os.path.join(a_dir, "uv_maps"))) == \
        sorted(os.listdir(os.path.join(b_dir, "uv_maps")))
    with open(os.path.join(a_dir, "arti_pred.mtl"), "rb") as fa, \
            open(os.path.join(b_dir, "arti_pred.mtl"), "rb") as fb:
        assert fa.read() == fb.read()
    for name in os.listdir(os.path.join(b_dir, "uv_maps")):
        ua = cv2.imread(os.path.join(a_dir, "uv_maps", name), cv2.IMREAD_UNCHANGED)
        ub = cv2.imread(os.path.join(b_dir, "uv_maps", name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ua, ub)
    with open(os.path.join(a_dir, "arti_pred.obj")) as fa, \
            open(os.path.join(b_dir, "arti_pred.obj")) as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    assert len(la) == len(lb)
    mesh = -1
    for x, y in zip(la, lb):
        if y.startswith("# mesh "):
            mesh = int(y.split()[2])
        if x == y:
            continue
        assert mesh in SWEPT_MESHES and x.startswith("v ") and y.startswith("v "), (x, y)
        va = np.array(x.split()[1:], np.float64)
        vb = np.array(y.split()[1:], np.float64)
        assert np.abs(va - vb).max() <= 1e-6 * np.abs(vb).max(), (x, y)


@pytest.mark.parametrize("webvis", [False, True])
@pytest.mark.parametrize("which", ["synthetic", "door"])
def test_save_obj_model_matches_jax(tmp_path, which, webvis):
    if which == "synthetic":
        pred, img, hw = _synthetic_prediction(), np.zeros((480, 640, 3), np.uint8), (480, 640)
    else:
        pred = _door_prediction()
        img = np.random.RandomState(2).randint(0, 255, (120, 160, 3), np.uint8)
        hw = (120, 160)
    jax_save_obj_model([pred], [img], 0, str(tmp_path / "jax"), webvis=webvis,
                       height=hw[0], width=hw[1])
    save_obj_model([_port(pred)], [img], 0, str(tmp_path / "port"), webvis=webvis,
                   height=hw[0], width=hw[1])
    a, b = tmp_path / "port" / "frame_0000", tmp_path / "jax" / "frame_0000"
    assert (b / "arti_pred.obj").exists()
    _compare_obj_dirs(str(a), str(b))
    text = (a / "arti_pred.obj").read_text()
    assert text.count("# mesh") >= 8
