"""Interpolated VOC average precision (counterpart of
`articulation3d_tpu/utils/vocap.py`, the reference's `utils/VOCap.py:5-44`).

The reference's reverse Python loop over the precision envelope is one
reversed `np.maximum.accumulate`.
"""

from __future__ import annotations

import numpy as np


def compute_ap(scores: np.ndarray, labels: np.ndarray, npos: float) -> float:
    """AP from per-detection scores and 1/0 TP labels: sort by descending
    score, cumulate TP/FP, recall = tp/npos, precision = tp/(tp+fp), then
    `xVOCap`."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(labels[order] == 1).astype(np.float64)
    fp = np.cumsum(labels[order] == 0).astype(np.float64)
    rec = tp / npos
    prec = tp / (fp + tp)
    return xVOCap(rec, prec)


def xVOCap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Interpolated AP (reference `xVOCap`)."""
    mrec = np.concatenate([[0.0], np.asarray(rec, np.float64), [1.0]])
    mpre = np.concatenate([[0.0], np.asarray(prec, np.float64), [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))
