"""The FLOP and byte counts against hand-worked values and against counts
taken from the plain reference at a small shape."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights as pbweights
from portbench.counts import flops, roi_align
from portbench.peaks import HBM_BYTES_PER_S
from portbench.reference import planercnn as ref


def test_hand_worked():
    assert flops.conv(3, 64, 7, 240, 320) == 2 * 3 * 64 * 49 * 240 * 320
    assert flops.linear(12544, 1024) == 2 * 12544 * 1024
    assert flops.pyramid(480, 640) == {"p2": (120, 160), "p3": (60, 80), "p4": (30, 40),
                                       "p5": (15, 20), "p6": (8, 10)}
    assert flops.box_roi_flops() == 2 * (12544 * 1024 + 1024 * 1024 + 1024 * 3 + 1024 * 8)
    c = flops.cascade_roi_flops()
    conv14 = 2 * 256 * 256 * 9 * 196
    assert c["mask"] == 4 * conv14 + 2 * 256 * 256 * 4 * 196 + 2 * 256 * 784
    assert c["plane"] == 4 * conv14 + 2 * 50176 * 1024 + 2 * 1024 * 3
    assert c["axis"] == 2 * (4 * conv14 + 2 * 50176 * 1024) + 2 * 1024 * 5
    # the stem alone at 64x96: 7x7 s2 -> 32x48
    assert flops.image_flops(64, 96)["trunk"] > flops.conv(3, 64, 7, 32, 48)


@pytest.fixture(scope="module")
def net():
    sd = pbweights.draw(0, "cpu", rpn_delta_scale=0.01, objectness_bias=4.0)
    return ref.Net(sd)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@torch.no_grad()
def test_image_flops_match_the_reference(net):
    x = torch.randn(1, 3, 64, 96)
    feats = net.backbone(x)
    parts = flops.image_flops(64, 96)
    assert _counted(lambda: net.backbone(x)) == parts["trunk"] + parts["fpn"]
    assert _counted(lambda: net.rpn_head(feats)) == parts["rpn"]
    assert _counted(lambda: net.depth(feats, (64, 96))) == parts["depth"]


@torch.no_grad()
def test_roi_flops_match_the_reference(net):
    r = 3
    assert _counted(lambda: net.box_head(torch.randn(r, 256, 7, 7))) == r * flops.box_roi_flops()
    pooled = torch.randn(r, 256, 14, 14)
    c = flops.cascade_roi_flops()
    assert _counted(lambda: net.mask_logits(pooled)) == r * c["mask"]
    assert _counted(lambda: net.plane_raw(pooled)) == r * c["plane"]
    assert _counted(lambda: net.axis_raw(pooled)) == r * c["axis"]


def _brute_cells(shapes, boxes, valid, p, ratio, aligned):
    """Union over ROIs of the rectangle between the first and last cell with
    a non-zero ROIAlign weight (the reference's own weights)."""
    total = 0
    lv = roi_align.levels(boxes)
    for b in range(boxes.shape[0]):
        for i, (h, w) in enumerate(shapes):
            grid = np.zeros((h, w), bool)
            for n in np.nonzero(valid[b] & (lv[b] == i + 2))[0]:
                bx = torch.tensor(boxes[b, n], dtype=torch.float64) / roi_align.STRIDES[i]
                bx = bx - (0.5 if aligned else 0.0)
                ys, xs = bx[3] - bx[1], bx[2] - bx[0]
                if not aligned:
                    ys, xs = max(ys, 1.0), max(xs, 1.0)
                gy = ratio or max(1, int(np.ceil(float(ys) / p)))
                gx = ratio or max(1, int(np.ceil(float(xs) / p)))
                wy = ref._axis_weights(bx[1:2].float(), torch.tensor([ys]).float(), p, gy, h)
                wx = ref._axis_weights(bx[0:1].float(), torch.tensor([xs]).float(), p, gx, w)
                ry = np.nonzero(wy[0].abs().sum(0).numpy() > 0)[0]
                rx = np.nonzero(wx[0].abs().sum(0).numpy() > 0)[0]
                if len(ry) and len(rx):
                    grid[ry[0]:ry[-1] + 1, rx[0]:rx[-1] + 1] = True
            total += int(grid.sum())
    return total


@pytest.mark.parametrize("p,ratio,aligned", [(7, 0, True), (14, 2, False), (14, 0, False)])
def test_touched_cells_match_the_reference_weights(p, ratio, aligned):
    rs = np.random.RandomState(0)
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    x0 = rs.uniform(-10, 90, (2, 12))
    y0 = rs.uniform(-10, 60, (2, 12))
    boxes = np.stack([x0, y0, x0 + rs.uniform(2, 60, (2, 12)),
                      y0 + rs.uniform(2, 40, (2, 12))], -1).astype(np.float32)
    valid = rs.rand(2, 12) > 0.2
    assert roi_align.touched_cells(shapes, boxes, valid, p, ratio, aligned) == \
        _brute_cells(shapes, boxes, valid, p, ratio, aligned)


def test_bound_by_bytes_hand_worked():
    # one 8x8 px ROI at p2, 7x7 aligned: 0.5..2.5 in cells, samples from 0.64
    # to 2.36, so the bilinear taps touch cells 0..3 on each axis
    shapes = [(16, 16), (8, 8), (4, 4), (2, 2)]
    boxes = np.array([[[4.0, 4.0, 12.0, 12.0]]], np.float32)
    valid = np.ones((1, 1), bool)
    assert roi_align.touched_cells(shapes, boxes, valid, 7, 0, True) == 16
    t, by = roi_align.bound_seconds(shapes, boxes, valid, 7, 0, True)
    nbytes = 16 * 256 * 2 + 16 + 1 + 49 * 256 * 4
    assert by == "bytes" and t == pytest.approx(nbytes / HBM_BYTES_PER_S)
