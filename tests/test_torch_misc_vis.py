"""The port's debug renderer and misc visualisation against the JAX package.

`vis/render.py` (the per-face z-buffer rasterizer) and `vis/misc.py`'s
PIL match and box drawing, labelled overlays and `fig2data` are host
numpy, PIL and OpenCV in both packages: on the same inputs every image is
pixel-equal to JAX's and every written PNG decodes to the same pixels.

The normal sphere and the affinity heatmap are matplotlib figures in JAX;
the card's machine has no matplotlib, so the port draws them with OpenCV
through matplotlib's projection and axes box (ROADMAP.md section 3).  They
are held to a geometric tolerance instead of pixel equality:

  * the normal sphere: the same canvas (shape, white margins outside the
    480x480 square); every stroke pixel (any channel below 250), every
    green arrow pixel and every blue history-dot pixel of each image lies
    within 2 px of one of the other's, for at least 95 % of them
    (measured 99.4-100 %), and the two arrows' areas agree within a
    factor of 2;
  * the affinity heatmap: the same 640x480 PNG size, the colored cell
    region's corners within 2 px of JAX's (measured 1 px), and each cell's
    color, sampled away from its annotation, within 3/255 of JAX's
    (measured 1/255).

The checks of JAX's own `tests/test_misc_vis.py` (canvas, concat geometry,
something drawn, the z-buffer order) hold for the port too.
"""

import numpy as np
import pytest

from articulation3d_tpu.export import TexturedMesh as JaxTexturedMesh
from articulation3d_tpu.structures import FramePrediction as JaxFramePrediction
from articulation3d_tpu.vis import misc as jmisc
from articulation3d_tpu.vis import render as jrender
from articulation3d_tpu.vis.visualizer import ArtiVisualizer as JaxArtiVisualizer
from articulation3d_tpu_torch.export import TexturedMesh
from articulation3d_tpu_torch.structures import FramePrediction
from articulation3d_tpu_torch.vis import misc, render
from articulation3d_tpu_torch.vis.visualizer import ArtiVisualizer


def _quad(cls, z, red, half=0.5, tex=4):
    verts = np.array([[-half, -half, z], [half, -half, z], [half, half, z],
                      [-half, half, z]], np.float32)
    uv = np.zeros((tex, tex, 3), np.uint8)
    uv[:, :, 0 if red else 2] = 255
    uv[::2, ::2, 1] = 120                                   # a texture with structure
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return cls(verts, np.array([[0, 1, 2], [0, 2, 3]]), uvs, uv)


def _scene(cls):
    rs = np.random.RandomState(0)
    tilted = cls(np.array([[-0.8, -0.3, 1.5], [0.6, -0.5, 2.5], [0.2, 0.7, 1.2]],
                          np.float32), np.array([[0, 1, 2]]))   # untextured
    back = _quad(cls, 2.0, False, half=1.2, tex=8)
    front = _quad(cls, 1.0, True)
    noise = cls(rs.randn(9, 3).astype(np.float32) * 0.3 + [0, 0, 1.8],
                rs.randint(0, 9, (6, 3)))
    return [back, tilted, front, noise]


def test_look_at_view_transform_matches_jax():
    for args in ((2.7, 0.0, 0.0), (3.0, 20.0, -35.0), (1.5, 90.0, 10.0)):
        for a, b in zip(render.look_at_view_transform(*args),
                        jrender.look_at_view_transform(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(60, 80), (120, 160)])
def test_render_meshes_is_pixel_equal(size):
    got = render.render_meshes(_scene(TexturedMesh), image_size=size)
    want = jrender.render_meshes(_scene(JaxTexturedMesh), image_size=size)
    np.testing.assert_array_equal(got, want)
    assert got.shape == size + (3,)
    assert (got < 1.0).any(axis=-1).mean() > 0.1               # the scene covers pixels
    assert np.allclose(got[0, 0], 1.0)                         # white background


def test_render_zbuffer_orders_faces():
    for order in ((2.0, 1.0), (1.0, 2.0)):
        quads = [_quad(TexturedMesh, z, red=(z == 1.0)) for z in order]
        c = render.render_meshes(quads, image_size=(60, 80))[30, 40]
        assert c[0] > c[2]                                     # the near (red) quad wins


def test_render_img_writes_the_same_png(tmp_path):
    import cv2
    meshes = _scene(TexturedMesh)
    uv_maps = [None, np.full((4, 4, 3), 90, np.uint8), None, None]
    got = render.render_img(str(tmp_path / "port"), meshes, uv_maps, image_size=(96, 128))
    want = jrender.render_img(str(tmp_path / "jax"), _scene(JaxTexturedMesh), uv_maps,
                              image_size=(96, 128))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8
    a = cv2.imread(str(tmp_path / "port" / "render_0.png"))
    b = cv2.imread(str(tmp_path / "jax" / "render_0.png"))
    np.testing.assert_array_equal(a, b)


def _within(a: np.ndarray, b: np.ndarray, px: int) -> float:
    """The share of a's pixels that lie within `px` of one of b's."""
    import cv2
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * px + 1, 2 * px + 1))
    near = cv2.dilate(b.astype(np.uint8), k) > 0
    return float((a & near).sum()) / max(int(a.sum()), 1)


_STROKES = {
    "ink": lambda im: im.min(-1) < 250,
    "green": lambda im: im[..., 1].astype(int) - np.maximum(im[..., 0], im[..., 2]) > 40,
    "blue": lambda im: im[..., 2].astype(int) - np.maximum(im[..., 0], im[..., 1]) > 60,
}


@pytest.mark.parametrize("normal,history", [
    ([0.2159, 0.8909, 0.3995], [[[0.0, 1.0, 0.0]]]),
    ([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8]], []),
    ([0.0, -0.7071, 0.7071], [[[1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]]),
])
def test_normal_figure_matches_jax_geometry(normal, history):
    got = misc.get_normal_figure(np.asarray(normal), history_normals=history,
                                 output_size=(480, 640))
    want = jmisc.get_normal_figure(np.asarray(normal), history_normals=history,
                                   output_size=(480, 640))
    assert got.shape == want.shape == (480, 640, 3) and got.dtype == np.uint8
    assert np.all(got[:, :80] == 255) and np.all(got[:, -80:] == 255)
    assert np.all(want[:, :80] == 255) and np.all(want[:, -80:] == 255)
    for name, stroke in _STROKES.items():
        a, b = stroke(got), stroke(want)
        assert a.any() == b.any() == (name != "blue" or bool(history)), name
        if not b.any():
            continue
        assert _within(a, b, 2) >= 0.95 and _within(b, a, 2) >= 0.95, name
    green = [_STROKES["green"](im).sum() for im in (got, want)]
    assert 0.5 <= green[0] / green[1] <= 2.0, green


def test_fig2data_matches_jax():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(2, 1.5))
    ax.plot([0, 1, 2], [1, 0, 1])
    got, want = misc.fig2data(fig), jmisc.fig2data(fig)
    plt.close(fig)
    np.testing.assert_array_equal(got, want)
    assert got.shape[2] == 4 and got.dtype == np.uint8


@pytest.mark.parametrize("shape,matching", [((4, 3), [1, -1, 0, 2]),
                                            ((12, 12), list(range(12)))])
def test_affinity_heatmap_matches_jax_geometry(tmp_path, shape, matching):
    import cv2
    aff = np.random.RandomState(0).rand(*shape)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    a = misc.save_affinity_after_stitch(aff, *shape, matching, str(tmp_path / "port"))
    b = jmisc.save_affinity_after_stitch(aff, *shape, matching, str(tmp_path / "jax"))
    assert a.endswith("affinity_pred.png")
    got, want = cv2.imread(a), cv2.imread(b)
    assert got.shape == want.shape == (480, 640, 3)

    def cells(img):
        colored = img.max(-1).astype(int) - img.min(-1) > 20
        rows, cols = np.nonzero(colored)
        return np.array([rows.min(), cols.min(), rows.max(), cols.max()])

    assert np.abs(cells(got) - cells(want)).max() <= 2
    x0, y0, x1, y1 = misc._heatmap_box(*shape)
    cw, ch = (x1 - x0) / shape[1], (y1 - y0) / shape[0]
    for i in range(shape[0]):
        for j in range(shape[1]):
            r, c = int(y0 + (i + 0.2) * ch), int(x0 + (j + 0.2) * cw)
            assert np.abs(got[r, c].astype(int) - want[r, c].astype(int)).max() <= 3, (i, j)


@pytest.mark.parametrize("vertical", [True, False])
def test_draw_match_is_pixel_equal(vertical):
    rs = np.random.RandomState(0)
    im1 = rs.randint(0, 255, (60, 80, 3), np.uint8)
    im2 = rs.randint(0, 255, (60, 80, 3), np.uint8)
    centers1 = np.asarray([[20.0, 30.0], [60.0, 10.0], [5.0, 50.0]])
    centers2 = np.asarray([[25.0, 35.0], [70.0, 40.0]])
    kw = dict(matching_proposals=np.asarray([[0, 0], [1, 1]]), correct_list=[1, 0],
              factor=2, distance=10, vertical=vertical)
    got = misc.draw_match(im1, im2, centers1, centers2, **kw)
    want = jmisc.draw_match(im1, im2, centers1, centers2, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if vertical:
        assert (got.height, got.width) == (60 * 2 * 2 + 20, 80 * 2)
    else:
        assert (got.height, got.width) == (60 * 2, 80 * 2 * 2 + 20)


def test_draw_bbox_and_concat_are_pixel_equal():
    from PIL import Image
    rs = np.random.RandomState(1)
    arrs = [rs.randint(0, 255, (60, 80, 3), np.uint8) for _ in range(2)]
    b1 = [[5, 5, 30, 30], [40, 10, 75, 50]]
    b2 = [[10, 8, 35, 40], [2, 30, 20, 58], [50, 5, 70, 25]]
    outs = []
    for mod in (misc, jmisc):
        i1, i2 = mod.draw_bbox(Image.fromarray(arrs[0]), Image.fromarray(arrs[1]),
                               b1, b2, [1, -1])
        outs.append([np.asarray(i1), np.asarray(i2),
                     np.asarray(mod.get_concat_v(i1, i2, 7, vertical=False))])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert misc.get_loc_white([10, 20, 50, 60]) == jmisc.get_loc_white([10, 20, 50, 60])
    assert not np.array_equal(outs[0][0], arrs[0])


def _prediction(cls):
    masks = np.zeros((2, 60, 80), bool)
    masks[0, 5:20, 5:20] = True
    masks[1, 30:50, 30:52] = True
    return cls(boxes=np.asarray([[5, 5, 20, 20], [30, 30, 50, 50]], np.float32),
               scores=np.asarray([0.9, 0.6]), classes=np.asarray([0, 1]), masks=masks,
               planes=np.zeros((2, 3)), rot_axis=np.zeros((2, 3)),
               tran_axis=np.zeros((2, 2)))


@pytest.mark.parametrize("paper_img", [False, True])
def test_labeled_segs_are_pixel_equal(paper_img):
    img = np.random.RandomState(1).randint(0, 255, (60, 80, 3), np.uint8)
    colors = [[0.1, 0.8, 0.3], [0.9, 0.2, 0.2]]
    got = misc.get_labeled_seg(_prediction(FramePrediction), 0.5, ArtiVisualizer(img),
                               assigned_colors=colors, paper_img=paper_img)
    want = jmisc.get_labeled_seg(_prediction(JaxFramePrediction), 0.5,
                                 JaxArtiVisualizer(img), assigned_colors=colors,
                                 paper_img=paper_img)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (60, 80, 3) and not np.array_equal(got, img)
    dic = {"annotations": [{"bbox": [5, 5, 15, 15], "bbox_mode": 1, "category_id": 0},
                           {"bbox": [30, 30, 60, 50], "bbox_mode": 0, "category_id": 1}]}
    got = misc.get_gt_labeled_seg(dic, ArtiVisualizer(img), assigned_colors=colors,
                                  paper_img=paper_img)
    want = jmisc.get_gt_labeled_seg(dic, JaxArtiVisualizer(img), assigned_colors=colors,
                                    paper_img=paper_img)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, img) == paper_img          # paper images draw no GT boxes
