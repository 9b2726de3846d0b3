"""The `serving_config` contract: the serving preset's detections against
the parity caps' on the same frames (JAX `utils/debug_weights.py::
match_detections`, kept here as the port's own copy)."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def match_detections(serving: Mapping[str, np.ndarray], parity: Mapping[str, np.ndarray], *,
                     box_tol: float = 0.5, score_tol: float = 1e-3,
                     mask_tol: float = 5e-2) -> Dict[str, float]:
    """Match each valid detection of `serving` to one of `parity` (JAX
    `utils/debug_weights.py::match_detections`), frame by frame.

    Both are dicts of numpy arrays: boxes (B, N, 4), scores, classes and
    valid (B, N), optionally masks (B, N, M, M).  A serving detection
    matches an unused parity detection of its frame and class whose box is
    within `box_tol` px in every coordinate, its score within `score_tol`
    and its mask within `mask_tol`; the candidates within `box_tol` are
    tried nearest first.  Returns n_serving, n_matched, the largest box,
    score and mask differences of the matched pairs, and n_parity_extra:
    unmatched parity detections that outscore their frame's weakest
    serving detection (all unmatched ones where serving keeps none)."""
    n_serving = n_matched = n_extra = 0
    max_box = max_score = max_mask = 0.0
    masks = serving.get("masks") is not None
    for f in range(serving["boxes"].shape[0]):
        sv = np.nonzero(serving["valid"][f])[0]
        pv = np.nonzero(parity["valid"][f])[0]
        n_serving += len(sv)
        used = set()
        min_kept = serving["scores"][f][sv].min() if len(sv) else -np.inf
        for i in sv:
            cands = []
            for j in pv:
                if j in used or parity["classes"][f][j] != serving["classes"][f][i]:
                    continue
                d = float(np.abs(parity["boxes"][f][j] - serving["boxes"][f][i]).max())
                if d <= box_tol:
                    cands.append((d, j))
            for d, j in sorted(cands):
                sd = abs(float(parity["scores"][f][j] - serving["scores"][f][i]))
                if sd > score_tol:
                    continue
                if masks:
                    md = float(np.abs(parity["masks"][f][j] - serving["masks"][f][i]).max())
                    if md > mask_tol:
                        continue
                    max_mask = max(max_mask, md)
                used.add(j)
                n_matched += 1
                max_box, max_score = max(max_box, d), max(max_score, sd)
                break
        n_extra += sum(1 for j in pv if j not in used and parity["scores"][f][j] > min_kept)
    return {"n_serving": n_serving, "n_matched": n_matched, "n_parity_extra": n_extra,
            "max_box_diff": max_box, "max_score_diff": max_score, "max_mask_diff": max_mask}
