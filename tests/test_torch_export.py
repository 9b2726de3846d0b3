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
    and pixel-equal uv maps;
  * the rest of export (`primitives`, `transforms`,
    `get_single_image_mesh_plane`): the same arrays as JAX's, bit for bit,
    and `.ply` / `.obj` text byte-equal; the checks of JAX's own
    `tests/test_export.py` (cylinder radius, the quaternion against
    Rodrigues, the `transform_verts` definition, the global/local round
    trip, the webview tilt) hold for the port.
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


# --------------------------------------------------------------------------- #
# primitives, writers and world/local transforms (JAX tests/test_export.py)
# --------------------------------------------------------------------------- #

def _jax_export():
    from articulation3d_tpu import export as jexp
    from articulation3d_tpu.export import transforms as jtr
    return jexp, jtr


CAMERA = {"position": [0.3, -0.2, 1.5], "lookat": [0.1, 0.2, 1.0],
          "vertical": [0.0, 1.0, 0.1]}


@pytest.mark.parametrize("prim", ["cylinder", "arrow", "degenerate", "axis_mesh",
                                  "camera_meshes", "cone_edges", "palette"])
def test_primitives_match_jax(prim):
    from articulation3d_tpu_torch.export import primitives as pp
    from articulation3d_tpu.export import primitives as jp
    if prim == "cylinder":
        got, want = (m.create_cylinder_mesh(0.1, [0, 0, 0], [0.2, 0.3, 1], stacks=4,
                                            slices=7) for m in (pp, jp))
        d = np.linalg.norm(np.cross(got[0][:-2] - 0.0, [0.2, 0.3, 1]), axis=1) \
            / np.linalg.norm([0.2, 0.3, 1])
        np.testing.assert_allclose(d, 0.1, atol=1e-6)       # ring verts on the radius
    elif prim == "arrow":
        got, want = (m.create_arrow_mesh(0.05, [0, 0, 0], [1, 0.5, 0]) for m in (pp, jp))
        assert got[1].max() < len(got[0])
    elif prim == "degenerate":
        got, want = (m.create_cylinder_mesh(0.1, [1, 1, 1], [1, 1, 1]) for m in (pp, jp))
        assert got[0].shape == (0, 3)
    elif prim == "axis_mesh":
        a, b = (m.get_axis_mesh(0.02, [0, 0, 1], [0.5, 0.1, 2]) for m in (pp, jp))
        got, want = (a.verts, a.faces), (b.verts, b.faces)
    elif prim == "camera_meshes":
        cams = [CAMERA, {"position": [0, 0, 0], "lookat": [0, 0, 1],
                         "vertical": [0, 1, 0]}]
        a, b = (m.get_camera_meshes(cams) for m in (pp, jp))
        assert len(a) == len(b) == 2 and [c for _, c in a] == [c for _, c in b]
        got = [x for m, _ in a for x in (m.verts, m.faces)]
        want = [x for m, _ in b for x in (m.verts, m.faces)]
    elif prim == "cone_edges":
        got, want = (np.asarray(m.get_cone_edges(CAMERA["position"], CAMERA["lookat"],
                                                 CAMERA["vertical"])) for m in (pp, jp))
        assert got.shape == (8, 2, 3)
    else:
        got, want = pp.create_color_palette(), jp.create_color_palette()
        assert len(got) == 40
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("colors,faces", [(True, True), (False, True), (True, False)])
def test_ply_and_obj_writers_are_byte_equal(tmp_path, colors, faces):
    from articulation3d_tpu_torch.export import write_obj, write_ply
    jexp, _ = _jax_export()
    rs = np.random.RandomState(0)
    verts = rs.randn(10, 3)
    col = rs.randint(0, 256, (10, 3)) if colors else None
    idx = np.array([[0, 1, 2], [3, 4, 5], [7, 8, 9]]) if faces else None
    for name, fn, jfn in (("a.ply", write_ply, jexp.write_ply),
                          ("a.obj", write_obj, jexp.write_obj)):
        fn(verts, col, idx, str(tmp_path / ("port_" + name)))
        jfn(verts, col, idx, str(tmp_path / ("jax_" + name)))
        got = (tmp_path / ("port_" + name)).read_bytes()
        assert got == (tmp_path / ("jax_" + name)).read_bytes()
    assert (tmp_path / "port_a.ply").read_text().startswith("ply")
    if faces:
        assert "f 1 2 3" in (tmp_path / "port_a.obj").read_text()
    write_obj(verts, None, idx, str(tmp_path / "m.obj"), mtl_filename="m.mtl")
    jexp.write_obj(verts, None, idx, str(tmp_path / "jm.obj"), mtl_filename="m.mtl")
    assert (tmp_path / "m.obj").read_bytes() == (tmp_path / "jm.obj").read_bytes()


def _rodrigues(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def test_quaternions_match_jax_and_rodrigues():
    from articulation3d_tpu_torch.export.transforms import quat_inverse, quat_to_rotmat
    _, jtr = _jax_export()
    rs = np.random.RandomState(0)
    for _ in range(5):
        axis, angle = rs.randn(3), rs.uniform(-np.pi, np.pi)
        q = _quat(axis, angle) * rs.uniform(0.5, 2.0)      # not normalised
        np.testing.assert_array_equal(quat_to_rotmat(q), jtr.quat_to_rotmat(q))
        np.testing.assert_array_equal(quat_inverse(q), jtr.quat_inverse(q))
        np.testing.assert_allclose(quat_to_rotmat(q), _rodrigues(axis, angle), atol=1e-6)


def test_transform_meshes_round_trip_and_flip():
    from articulation3d_tpu_torch.export import (TexturedMesh, transform_meshes,
                                                 transform_verts)
    jexp, jtr = _jax_export()
    rs = np.random.RandomState(1)
    cam = {"position": np.array([0.5, -1.0, 2.0]),
           "rotation": _quat([0.2, 0.9, -0.1], 0.7)}
    verts = rs.randn(7, 3).astype(np.float32)
    out = transform_meshes([TexturedMesh(verts, np.array([[0, 1, 2]]))], cam)[0]
    want = jexp.transform_meshes([jexp.TexturedMesh(verts, np.array([[0, 1, 2]]))], cam)[0]
    np.testing.assert_array_equal(out.verts, want.verts)
    np.testing.assert_array_equal(out.faces, want.faces)
    # the definition: R @ (v * [1, -1, -1]) + t
    expect = (_rodrigues([0.2, 0.9, -0.1], 0.7) @ (verts * [1, -1, -1]).T).T + cam["position"]
    np.testing.assert_allclose(out.verts, expect, atol=1e-5)
    ident = {"position": np.zeros(3), "rotation": [1.0, 0, 0, 0]}
    np.testing.assert_allclose(transform_verts(verts, ident), verts * [1, -1, -1], atol=1e-6)
    np.testing.assert_array_equal(transform_verts(verts, cam), jtr.transform_verts(verts, cam))


def test_plane_params_global_local_match_jax():
    from articulation3d_tpu_torch.export import (get_plane_params_in_global,
                                                 get_plane_params_in_local)
    jexp, _ = _jax_export()
    rs = np.random.RandomState(3)
    cam = {"position": np.array([0.3, 0.8, -0.4]),
           "rotation": _quat([1.0, 0.2, 0.5], -1.1)}
    planes = rs.randn(6, 3).astype(np.float32) * 2.0
    world = get_plane_params_in_global(planes, cam)
    np.testing.assert_array_equal(world, jexp.get_plane_params_in_global(planes, cam))
    back = get_plane_params_in_local(world, cam)
    np.testing.assert_array_equal(back, jexp.get_plane_params_in_local(world, cam))
    np.testing.assert_allclose(back, planes, atol=1e-4)


def test_rotate_mesh_for_webview_matches_jax():
    from articulation3d_tpu_torch.export import TexturedMesh, rotate_mesh_for_webview
    jexp, _ = _jax_export()
    verts = np.concatenate([np.eye(3), np.random.RandomState(4).randn(5, 3)]).astype(np.float32)
    out = rotate_mesh_for_webview([TexturedMesh(verts, np.array([[0, 1, 2]]))])[0]
    want = jexp.rotate_mesh_for_webview([jexp.TexturedMesh(verts, np.array([[0, 1, 2]]))])[0]
    np.testing.assert_array_equal(out.verts, want.verts)
    np.testing.assert_allclose(out.verts[0], [1, 0, 0], atol=1e-6)   # a pure x rotation
    np.testing.assert_allclose(np.linalg.norm(out.verts, axis=1),
                               np.linalg.norm(verts, axis=1), atol=1e-5)
    assert abs(out.verts[1][1] - 0.9816272) < 1e-5


@pytest.mark.parametrize("segm", ["rle", "polygons"])
def test_single_image_mesh_plane_matches_jax(segm):
    from articulation3d_tpu.export import get_single_image_mesh_plane as jax_mesh_plane
    from articulation3d_tpu_torch.export import get_single_image_mesh_plane
    from articulation3d_tpu_torch.utils.rle import rle_encode
    img = np.random.RandomState(5).randint(0, 255, (480, 640, 3), np.uint8)
    masks = _masks()
    planes = np.array([[0.0, 2.0, 0.0], [0.3, 3.0, 0.4], [-0.2, 1.5, 0.1]])
    if segm == "rle":
        segs = [rle_encode(np.asarray(m, np.uint8)) for m in masks]
    else:
        segs = [binary_mask_to_polygon(m) for m in masks]
    want, want_uv = jax_mesh_plane(planes, segs, img)
    got, got_uv = get_single_image_mesh_plane(planes, segs, img)
    assert len(got) == len(want) == 3
    ref, _ = get_single_image_mesh_arti(planes, np.stack(masks), img)
    for a, b, c in zip(got, want, ref):
        for f in ("verts", "faces", "verts_uvs", "uv_map"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
    for a, b in zip(got_uv, want_uv):
        np.testing.assert_array_equal(a, b)


def test_export_names_match_jax():
    from articulation3d_tpu_torch import export as pexp
    jexp, _ = _jax_export()
    assert sorted(pexp.__all__) == sorted(jexp.__all__)
    for name in pexp.__all__:
        assert callable(getattr(pexp, name)) or isinstance(getattr(pexp, name), type)
