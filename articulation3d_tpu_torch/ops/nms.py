"""Exact greedy NMS on fixed-capacity, batched box sets.

Counterpart of `articulation3d_tpu/ops/nms.py`.  Boxes are visited in
descending score order (a stable sort, so ties keep input order, as the
JAX package's `jnp.argsort` does); a box is suppressed iff it overlaps an
earlier KEPT box with IoU > threshold.  Invalid entries never suppress and
are never kept.  Every leading dimension is a batch of independent sets.

`nms_mask` takes K4 (`csrc/nms.cu`) for CUDA tensors: every set of the call
in one pair of launches, with no host wait.  For CPU tensors it takes the
plain version `nms_mask_sweep`, which finds the keep mask as the fixed
point of

    keep[j] = valid[j] and not any_{i < j} (keep[i] and iou[i, j] > t)

iterated from keep = valid.  After k sweeps the first k positions in sorted
order are final, so the sweep ends within N steps; in practice suppression
chains are short and it ends after a handful.  The relation has exactly one
fixed point, the greedy result, so stopping at the first sweep that changes
nothing is exact.  Both visit the sets in the same order (`_order`) and
compute the IoU alike (`box_ops.pairwise_iou`), so their keep masks are
equal bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import cuda_build
from .box_ops import pairwise_iou

NEG_INF = -1e10
# K4's walk keeps a set's removed bits in 48 KB of shared memory; the sets
# are a grid dimension
MAX_N, MAX_SETS = 64 * 6144, 65535
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP, _VP, _VP, _I, _I,            # boxes, valid, order, sets, N
             ctypes.c_float, _VP, _VP, _VP]    # threshold, scratch, keep, stream


def top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (a stable sort of
    the negated values, like the JAX package's sort-based top_k)."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


def _check(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got {boxes.dtype}, {scores.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if (boxes.dim() < 2 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:-1]
            or valid.shape != scores.shape):
        raise ValueError(f"want boxes (..., N, 4), scores and valid (..., N); got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(valid.shape)}")
    if not boxes.device == scores.device == valid.device:
        raise ValueError("boxes, scores and valid must be on one device")


def _order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each set's visiting order: a stable sort of the scores, descending,
    with the invalid entries' scores masked to NEG_INF."""
    masked = torch.where(valid, scores, NEG_INF)
    return torch.sort(-masked, dim=-1, stable=True).indices


def nms_mask_sweep(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """The plain version of K4: sweeps over the (..., N, N) IoU matrix to
    their fixed point, one host wait per sweep on CUDA."""
    n = boxes.shape[-2]
    order = _order(scores, valid)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    svalid = torch.gather(valid, -1, order)

    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (pairwise_iou(sboxes, sboxes) > iou_threshold) & later
    keep = svalid
    for _ in range(n):
        killed = (keep[..., :, None] & sup).any(dim=-2)
        new = svalid & ~killed
        with tracing.sync("nms", new):      # one host wait per sweep
            same = torch.equal(new, keep)
        if same:
            break
        keep = new
    return torch.zeros_like(keep).scatter(-1, order, keep)


def _nms_cuda(boxes: torch.Tensor, valid: torch.Tensor, order: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """K4 on checked CUDA inputs; counts the launch and its sets."""
    n = boxes.shape[-2]
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    sets, words = keep.numel() // n, -(-n // 64)
    if n > MAX_N or sets > MAX_SETS:
        raise ValueError(f"K4 takes at most {MAX_SETS} sets of {MAX_N} boxes, got {sets} of {n}")
    boxes, valid = boxes.contiguous(), valid.contiguous()
    scratch = torch.empty(sets * (n + 1) * words, dtype=torch.int64, device=boxes.device)
    lib = cuda_build.load("nms", _ARGTYPES)
    err = lib.nms(boxes.data_ptr(), valid.data_ptr(), order.contiguous().data_ptr(),
                  sets, n, float(iou_threshold), scratch.data_ptr(), keep.data_ptr(),
                  torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms launch failed: CUDA error {err}")
    tracing.count("nms.launches")
    tracing.count("nms.sets", sets)
    return keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask, aligned with the INPUT order.

    boxes (..., N, 4) float32, scores (..., N) float32, valid (..., N) bool
    -> (..., N) bool.  CUDA tensors launch K4 (the sort stays here, K4
    gathers through it and scatters its answer back); CPU tensors take
    `nms_mask_sweep`.
    """
    _check(boxes, scores, valid)
    tracing.count("nms.calls")
    with tracing.span("nms"):
        if boxes.device.type == "cpu":
            return nms_mask_sweep(boxes, scores, valid, iou_threshold)
        if boxes.device.type != "cuda":
            raise ValueError(f"unsupported device {boxes.device}")
        return _nms_cuda(boxes, valid, _order(scores, valid), iou_threshold)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     classes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Class-wise NMS via the coordinate-offset trick (detectron2
    batched_nms); the offset is taken per set over its valid boxes."""
    vb = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = vb.flatten(-2).max(dim=-1).values + 1.0
    offsets = classes.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold)


def select_top(scores: torch.Tensor, keep: torch.Tensor, k: int):
    """Top-k kept entries by score: (indices (..., k), valid (..., k)),
    indices into the input ordered by descending score; `valid` is False
    where fewer than k survive."""
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    top_scores, idx = top_k(masked, k)
    return idx, top_scores > NEG_INF / 2
