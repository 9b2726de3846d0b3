"""The port's visualisation against the JAX package, on the CPU: the
frames `draw_pred` and `get_normal_map` draw, and the CLI's side-by-side
composite, are pixel-equal for the same predictions."""

import numpy as np
import pytest

from articulation3d_tpu.data.axis_codec import axis_to_angle_offset
from articulation3d_tpu.data.catalog import get_metadata as jax_metadata
from articulation3d_tpu.vis import ArtiVisualizer as JaxVisualizer
from articulation3d_tpu.vis import draw_pred as jax_draw_pred
from articulation3d_tpu.vis import get_normal_map as jax_normal_map
from articulation3d_tpu_torch.data.catalog import get_metadata
from articulation3d_tpu_torch.infer import _vis_frame
from articulation3d_tpu_torch.structures import FramePrediction
from articulation3d_tpu_torch.vis import ArtiVisualizer, draw_pred, get_normal_map

CLS_NAME_MAP = ["R", "T"]


def _predictions(seed, h=120, w=160, n=6):
    rs = np.random.RandomState(seed)
    x1 = rs.uniform(0, w - 40, n)
    y1 = rs.uniform(0, h - 30, n)
    boxes = np.stack([x1, y1, x1 + rs.uniform(10, 40, n), y1 + rs.uniform(10, 30, n)], 1)
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2
    seg = np.concatenate([centers + rs.uniform(-20, 20, (n, 2)),
                          centers + rs.uniform(-20, 20, (n, 2))], 1)
    rot = axis_to_angle_offset(seg, centers)[:, :3]
    ang = rs.uniform(0, 2 * np.pi, n)
    masks = np.zeros((n, h, w), bool)
    for i, b in enumerate(boxes.astype(int)):
        masks[i, b[1]:b[3], b[0]:b[2]] = rs.rand(b[3] - b[1], b[2] - b[0]) > 0.2
    return FramePrediction(boxes=boxes, scores=rs.uniform(0.3, 1.0, n),
                           classes=rs.randint(0, 2, n), masks=masks,
                           planes=rs.randn(n, 3), rot_axis=rot,
                           tran_axis=np.stack([np.sin(ang), np.cos(ang)], 1))


def _image(seed, h=120, w=160):
    return np.random.RandomState(100 + seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def test_metadata_matches_jax():
    a, b = get_metadata("arti_train"), jax_metadata("arti_train")
    assert a.thing_classes == b.thing_classes and a.thing_colors == b.thing_colors
    assert a.thing_dataset_id_to_contiguous_id == b.thing_dataset_id_to_contiguous_id


@pytest.mark.parametrize("conf", [0.7, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_draw_pred_matches_jax(seed, conf):
    p, im = _predictions(seed), _image(seed)
    want = jax_draw_pred(JaxVisualizer(im[:, :, ::-1]), p, jax_metadata("arti_train"),
                         CLS_NAME_MAP, conf_threshold=conf)
    got = draw_pred(ArtiVisualizer(im[:, :, ::-1]), p, get_metadata("arti_train"),
                    CLS_NAME_MAP, conf_threshold=conf)
    assert got.shape == (120, 160, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != im[:, :, ::-1]).any()
    np.testing.assert_array_equal(im, _image(seed))       # the frame is not drawn on


def test_get_normal_map_matches_jax():
    p = _predictions(3)
    np.testing.assert_array_equal(get_normal_map(p.planes, p.masks),
                                  jax_normal_map(p.planes, p.masks))
    empty = (np.array([[1.0, 0, 0]]), np.zeros((1, 120, 160)))
    np.testing.assert_array_equal(get_normal_map(*empty), jax_normal_map(*empty))


def test_cli_frame_matches_jax_composition():
    """`infer._vis_frame` is `tools/inference.py:101-110` for one frame."""
    p, im = _predictions(4), _image(4)
    seg = jax_draw_pred(JaxVisualizer(im[:, :, ::-1]), p, jax_metadata("arti_train"),
                        CLS_NAME_MAP, conf_threshold=0.5)
    want = np.concatenate((seg, jax_normal_map(p.planes, p.masks)), axis=1)
    got = _vis_frame(im, p, get_metadata("arti_train"), CLS_NAME_MAP, 0.5)
    np.testing.assert_array_equal(got, want)
    empty = FramePrediction(np.zeros((0, 4)), np.zeros(0), np.zeros(0), np.zeros((0, 120, 160)),
                            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 2)))
    assert _vis_frame(im, empty, get_metadata("arti_train"), CLS_NAME_MAP, 0.5).shape == \
        (120, 320, 3)
