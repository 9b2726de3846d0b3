"""The judge's NMS checks on hand-made boxes: a greedy NMS output passes,
and duplicates, wrong suppressions and dropped candidates read what they
should."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import judge
from portbench.reference import planercnn as ref


def test_iou_by_hand():
    a = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    b = torch.tensor([[0.0, 0.0, 10.0, 8.0], [5.0, 0.0, 15.0, 10.0], [20.0, 20.0, 30.0, 30.0],
                      [3.0, 3.0, 3.0, 3.0]])
    got = judge.iou(a, b)[0].tolist()
    assert got == pytest.approx([0.8, 50.0 / 150.0, 0.0, 0.0])


def test_overlap_reads_the_worst_pair_within_a_group():
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 8.0], [40.0, 0, 50, 10]])
    assert judge.nms_overlap(boxes, torch.tensor([0, 0, 0]), 0.7) == pytest.approx(0.1)
    assert judge.nms_overlap(boxes, torch.tensor([0, 1, 0]), 0.7) == 0.0
    assert judge.nms_overlap(boxes, torch.tensor([0, 0, 0]), 0.9) == 0.0


def _cand(boxes, scores, matched, floor=-math.inf, group=None):
    n = len(scores)
    return {"boxes": torch.tensor(boxes, dtype=torch.float32),
            "scores": torch.tensor(scores, dtype=torch.float32),
            "scale": torch.full((n,), 2.0), "floor": torch.full((n,), floor),
            "group": torch.zeros(n, dtype=torch.int64) if group is None else torch.tensor(group),
            "matched": torch.tensor(matched)}


def test_miss_by_hand():
    kept = {"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([5.0]),
            "group": torch.tensor([0])}
    # an unmatched candidate 3 above the cut with nothing over it: 3 / scale 2
    far = _cand([[50.0, 50, 60, 60]], [4.0], [False])
    assert judge.nms_miss(far, kept, 1.0, 0.7) == pytest.approx(1.5)
    # below the cut, or under its own floor: nothing
    assert judge.nms_miss(far, kept, 4.5, 0.7) == 0.0
    assert judge.nms_miss(_cand([[50.0, 50, 60, 60]], [4.0], [False], floor=4.0),
                          kept, 1.0, 0.7) == 0.0
    # covered by a kept box of higher score: nothing; of another group: all
    under = _cand([[0.0, 0.0, 10.0, 8.0]], [4.0], [False])
    assert judge.nms_miss(under, kept, 1.0, 0.7) == 0.0
    assert judge.nms_miss(_cand([[0.0, 0.0, 10.0, 8.0]], [4.0], [False], group=[1]),
                          kept, 1.0, 0.7) == pytest.approx(1.5)
    # covered, but the kept box scores 1 lower: 1 / scale 2
    assert judge.nms_miss(_cand([[0.0, 0.0, 10.0, 8.0]], [6.0], [False]),
                          kept, 1.0, 0.7) == pytest.approx(0.5)
    # an overlap under the threshold less the slack does not cover
    half = _cand([[5.0, 0.0, 15.0, 10.0]], [4.0], [False])
    assert judge.nms_miss(half, kept, 1.0, 0.7) == pytest.approx(1.5)
    assert judge.nms_miss(half, kept, 1.0, 0.3) == 0.0
    # matched candidates are not read
    assert judge.nms_miss(_cand([[50.0, 50, 60, 60]], [4.0], [True]), kept, 1.0, 0.7) == 0.0


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_greedy_nms_output_passes_and_a_wrong_threshold_does_not(thresh):
    rs = np.random.RandomState(7)
    xy = rs.uniform(0, 60, (200, 2))
    wh = rs.uniform(8, 30, (200, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], 1), dtype=torch.float32)
    scores = torch.tensor(rs.uniform(0, 10, 200), dtype=torch.float32)

    def read(run_thresh):
        keep = torch.from_numpy(ref.nms(boxes.numpy(), scores.numpy(), run_thresh))
        matched = torch.zeros(200, dtype=torch.bool)
        matched[keep] = True
        cand = {"boxes": boxes, "scores": scores, "scale": torch.ones(200),
                "floor": torch.full((200,), -math.inf), "group": torch.zeros(200, dtype=torch.int64),
                "matched": matched}
        kept = {"boxes": boxes[keep], "scores": scores[keep], "group": torch.zeros(len(keep),
                                                                                  dtype=torch.int64)}
        return (judge.nms_overlap(boxes[keep], kept["group"], thresh),
                judge.nms_miss(cand, kept, -math.inf, thresh))

    assert read(thresh) == (0.0, 0.0)
    over, _ = read(1.0)                 # NMS skipped: kept pairs overlap
    assert over > 0.1
    _, miss = read(thresh - 0.2)        # too strict: candidates dropped uncovered
    assert miss > 0.1
