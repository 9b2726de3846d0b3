"""COCO run-length-encoded mask codec and mask IoU (pycocotools' format).

Counterpart of `articulation3d_tpu/utils/rle.py`: column-major runs, the
first run counting zeros, written as pycocotools' `rleToString` chars
(5-bit groups + 48, each count after the second coded as its difference
from the count two back), so prediction files interoperate with
pycocotools byte for byte.

The runs are computed by the port's C++ codec (`csrc/rle.cc`, built with
`g++` by `native.py`); a failed build raises.  `mask_to_counts_np` and
`counts_to_mask_np` are its plain numpy twins, which the tests hold it
against.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from .. import native

RLE = Dict[str, Union[str, bytes, List[int], Sequence[int]]]


def mask_to_counts_np(mask: np.ndarray) -> np.ndarray:
    """Column-major run lengths of a 0/1 mask, first run counting zeros."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return np.zeros((0,), np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx)
    if flat[0] == 1:  # runs must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def counts_to_mask_np(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Column-major run lengths -> (h, w) uint8 mask."""
    total = int(np.sum(counts))
    flat = np.zeros(total, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += int(c)
        val ^= 1
    if total != h * w:
        flat = np.resize(flat, h * w)
    return flat.reshape((h, w), order="F")


def _counts_encode_str(cnts: Sequence[int]) -> str:
    """pycocotools `rleToString`: 5-bit groups, +48, delta from cnts[i-2]."""
    out = []
    cnts = [int(c) for c in cnts]
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _counts_decode_str(s: Union[str, bytes]) -> List[int]:
    """pycocotools `rleFrString`."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = 1
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = c & 0x20
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def rle_encode(mask: np.ndarray) -> RLE:
    """Binary (H, W) mask -> compressed COCO RLE {"size": [h, w], "counts": str}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _counts_encode_str(native.rle_encode_counts(mask))}


def rle_decode(rle: RLE) -> np.ndarray:
    """COCO RLE (compressed string or plain counts list) -> (H, W) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _counts_decode_str(counts)
    return native.rle_decode_counts(np.asarray(counts, np.int64), int(h), int(w))


def rle_area(rle: RLE) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _counts_decode_str(counts)
    return int(np.sum(np.asarray(counts[1::2], np.int64)))


def mask_iou(dt: List[RLE], gt: List[RLE],
             iscrowd: Union[Sequence[int], None] = None) -> np.ndarray:
    """Pairwise mask IoU, pycocotools `maskUtils.iou` semantics.

    iscrowd[j] = 1 makes the denominator area(dt) (crowd regions).
    Returns (len(dt), len(gt)) float64.
    """
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))
    dm = np.stack([rle_decode(r).astype(bool) for r in dt])
    gm = np.stack([rle_decode(r).astype(bool) for r in gt])
    d = dm.reshape(len(dt), -1).astype(np.float64)
    g = gm.reshape(len(gt), -1).astype(np.float64)
    inter = d @ g.T
    da = d.sum(axis=1)[:, None]
    ga = g.sum(axis=1)[None, :]
    union = da + ga - inter
    if iscrowd is not None:
        crowd = np.asarray(iscrowd, bool)[None, :]
        union = np.where(crowd, da * np.ones_like(ga), union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
