"""The helpers of `chip_smoke.py`'s refine and DRPN phases, on the CPU.

  * `_route_agreement` holds the kernel route against the plain route by
    the matched share, box and plane errors and the IoU of the refined
    masks' foreground over the matched detections: 1 for equal masks, 0
    when one route's masks are empty, the pooled ratio in between; and the
    share of equal pixels, which it reports beside the IoU;
  * `_only_phases` reads `--only a,b` and refuses unknown phases or other
    arguments (a run with it prints a partial last line, not the result).
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_refine",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dets(boxes, valid, planes):
    t = lambda a: torch.from_numpy(np.asarray(a))
    return types.SimpleNamespace(boxes=t(np.asarray(boxes, np.float32)), valid=t(valid),
                                 planes=t(np.asarray(planes, np.float32)))


def _case():
    """Two images of three detections; the plain route lists image 0's in
    another order and has one box 0.5 px off and one plane 1e-3 off."""
    boxes = np.asarray([[[0, 0, 10, 10], [20, 20, 40, 40], [50, 0, 60, 30]],
                        [[5, 5, 25, 25], [30, 30, 50, 60], [0, 0, 1, 1]]], np.float32)
    valid = np.asarray([[True, True, True], [True, True, False]])
    planes = np.arange(18, dtype=np.float32).reshape(2, 3, 3)
    a = _dets(boxes, valid, planes)
    order = [2, 0, 1]
    boxes_b, planes_b = boxes.copy(), planes.copy()
    boxes_b[0], planes_b[0] = boxes[0][order], planes[0][order]
    boxes_b[1, 1, 2] += 0.5
    planes_b[1, 0, 1] += 1e-3
    return a, _dets(boxes_b, valid, planes_b), order


def _masks(rs):
    return [rs.rand(3, 32, 48) > 0.7, rs.rand(3, 32, 48) > 0.7]


def test_route_agreement_counts_matches_and_errors():
    cs = _chip_smoke()
    a, b, _ = _case()
    agree = cs._route_agreement(a, b)
    assert agree["matched"] == 1.0 and agree["n_ref"] == 5
    assert agree["box_err"] == pytest.approx(0.5)
    assert agree["plane_err"] == pytest.approx(1e-3, rel=1e-3)


@pytest.mark.parametrize("kind", ["equal", "empty", "half"])
def test_route_agreement_foreground_iou(kind):
    cs = _chip_smoke()
    a, b, order = _case()
    ma = _masks(np.random.RandomState(0))
    mb = [ma[0][order].copy(), ma[1].copy()]          # the plain route's order
    if kind == "empty":
        mb = [np.zeros_like(m) for m in mb]
    if kind == "half":                                 # drop the left half of every mask
        for m in mb:
            m[..., :24] = False
    agree = cs._route_agreement(a, b, ma, mb)
    pairs = [(ma[0], mb[0][np.argsort(order)]), (ma[1][:2], mb[1][:2])]
    union = sum(int((x | y).sum()) for x, y in pairs)
    assert agree["fg_union"] == union > 0
    want = {"equal": 1.0, "empty": 0.0,
            "half": sum(int(x[..., 24:].sum()) for x, _ in pairs) / union}[kind]
    assert agree["fg_iou"] == pytest.approx(want)
    size = sum(x.size for x, _ in pairs)
    assert agree["equal_pixels"] == pytest.approx(
        sum(int((x == y).sum()) for x, y in pairs) / size)


def test_only_phases(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert cs._only_phases() == []
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--only", "drpn,f1"])
    assert cs._only_phases() == ["drpn", "f1"]
    for argv in (["--only", "drpn,nope"], ["--all"], ["--only"]):
        monkeypatch.setattr(sys, "argv", ["chip_smoke.py", *argv])
        with pytest.raises(SystemExit):
            cs._only_phases()
