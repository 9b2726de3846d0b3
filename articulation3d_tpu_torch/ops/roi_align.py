"""ROIAlign as flat row gathers over a concatenated FPN pyramid.

Counterpart of `articulation3d_tpu/ops/roi_align.py`, with torchvision
`roi_align` semantics:

  * V1 ("ROIAlign") vs V2 ("ROIAlignV2", aligned=True): V2 shifts sample
    coordinates by -0.5 and does not force malformed ROIs to 1x1;
  * `sampling_ratio` S samples per bin and axis; 0 means the adaptive
    ceil(bin size), with no cap as in torchvision (`adaptive_cap=None`),
    or at most `adaptive_cap` as in the JAX package (which passes 4).  The
    samples sit on a grid of the largest count of the ROIs at hand, and
    those beyond an ROI's own count are masked out;
  * detectron2's FPN level assignment floor(4 + log2(sqrt(area) / 224)).

Each level map is flattened to (H*W, C) rows and the levels are
concatenated, with one zero row at the end for out-of-range corners, so
every ROI samples once at its level through flat indices.  ROIs are
grouped by sample count and processed in chunks whose corner buffer
(k, P*S, P*S, C) holds no more samples than `chunk` ROIs at S = 4: an
uncapped sliver at p2 takes up to 23 samples per bin, and a chunk of
those has fewer ROIs, not a buffer sized for the largest count.

This is the plain reference both poolers are tested against, and the
model's "torch" ROI pooler.  Features are channels-last (H, W, C).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# S for `chunk` in the gather pooler's buffer budget (the JAX package's cap)
_BUDGET_SAMPLES = 4


def _bins(boxes: torch.Tensor, spatial_scale, output_size: int, aligned: bool):
    """Per-ROI (x1, y1, bin_w, bin_h) on the pooled level, as float32."""
    n = boxes.shape[0]
    scale = torch.as_tensor(spatial_scale, dtype=torch.float32, device=boxes.device)
    if scale.dim() == 0:
        scale = scale.expand(n)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * scale - offset
    y1 = boxes[:, 1] * scale - offset
    x2 = boxes[:, 2] * scale - offset
    y2 = boxes[:, 3] * scale - offset

    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:  # legacy: force malformed ROIs to be 1x1
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    return x1, y1, roi_w / output_size, roi_h / output_size


def _counts(bin_sz: torch.Tensor, sampling_ratio: int,
            adaptive_cap: Optional[int]) -> torch.Tensor:
    """Samples per bin along one axis, (N,) int32: the ratio, or ceil(bin)
    at least 1 and at most `adaptive_cap` (no cap when it is None)."""
    if sampling_ratio > 0:
        return torch.full(bin_sz.shape, sampling_ratio, dtype=torch.int32,
                          device=bin_sz.device)
    return torch.ceil(bin_sz).to(torch.int32).clamp(1, adaptive_cap)


def sample_counts(boxes: torch.Tensor, spatial_scale, output_size: int,
                  sampling_ratio: int, aligned: bool,
                  adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """(N,) int32: each ROI's larger per-axis sample count."""
    _, _, bin_w, bin_h = _bins(boxes, spatial_scale, output_size, aligned)
    return torch.maximum(_counts(bin_w, sampling_ratio, adaptive_cap),
                         _counts(bin_h, sampling_ratio, adaptive_cap))


def _sample_coords(boxes: torch.Tensor, spatial_scale, output_size: int,
                   sampling_ratio: int, aligned: bool,
                   adaptive_cap: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Per-ROI sample coordinates and masks.

    spatial_scale: a float or a per-ROI (N,) tensor (multilevel).
    adaptive_cap: with sampling ratio 0, the most samples per bin and axis
    (None: ceil(bin), uncapped).  The grid S is the ratio, the cap, or,
    uncapped, the largest count of these ROIs (one host read).
    Returns ys, xs (N, P, S) float coordinates and y_mask, x_mask (N, P, S).
    """
    p = output_size
    n = boxes.shape[0]
    dev = boxes.device
    x1, y1, bin_w, bin_h = _bins(boxes, spatial_scale, p, aligned)
    n_sw = _counts(bin_w, sampling_ratio, adaptive_cap)
    n_sh = _counts(bin_h, sampling_ratio, adaptive_cap)
    if sampling_ratio > 0:
        s = sampling_ratio
    elif adaptive_cap is not None:
        s = adaptive_cap
    else:
        s = int(torch.maximum(n_sw, n_sh).max()) if n else 1

    ph = torch.arange(p, dtype=torch.float32, device=dev)
    iy = torch.arange(s, dtype=torch.float32, device=dev)

    def coords(start, bin_sz, n_s):
        frac = (iy[None, None, :] + 0.5) / n_s[:, None, None].to(torch.float32)
        return start[:, None, None] + (ph[None, :, None] + frac) * bin_sz[:, None, None]

    ys = coords(y1, bin_h, n_sh)
    xs = coords(x1, bin_w, n_sw)
    y_mask = (iy[None, None, :] < n_sh[:, None, None]).to(torch.float32).expand(n, p, s)
    x_mask = (iy[None, None, :] < n_sw[:, None, None]).to(torch.float32).expand(n, p, s)
    return ys, xs, y_mask, x_mask


def _corner_indices_weights(ys, xs, heights, widths, row_offsets, row_stride):
    """Bilinear corner flat indices and weights for mixed-level sampling.

    ys, xs (N, P, S); heights/widths/row_offsets/row_stride per-ROI (N,)
    int64.  Returns idx (N, P, S, P, S, 4) int64 into the flat row buffer
    and w (N, P, S, P, S, 4) float32.
    """
    hf = heights[:, None, None].to(torch.float32)
    wf = widths[:, None, None].to(torch.float32)
    hi = heights[:, None, None]
    wi = widths[:, None, None]

    oor_y = (ys < -1.0) | (ys > hf)
    oor_x = (xs < -1.0) | (xs > wf)
    y = ys.clamp(min=0.0)
    x = xs.clamp(min=0.0)

    y_low = torch.minimum(y.to(torch.int64), hi - 1)
    x_low = torch.minimum(x.to(torch.int64), wi - 1)
    y_high = torch.minimum(y_low + 1, hi - 1)
    x_high = torch.minimum(x_low + 1, wi - 1)
    y = torch.where(y.to(torch.int64) >= hi - 1, y_low.to(y.dtype), y)
    x = torch.where(x.to(torch.int64) >= wi - 1, x_low.to(x.dtype), x)

    ly = y - y_low.to(y.dtype)
    lx = x - x_low.to(x.dtype)
    hy = 1.0 - ly
    hx = 1.0 - lx

    def by(a):  # y-like (N, P, S) -> (N, P, S, 1, 1)
        return a[:, :, :, None, None]

    def bx(a):  # x-like (N, P, S) -> (N, 1, 1, P, S)
        return a[:, None, None, :, :]

    off = row_offsets[:, None, None, None, None]
    stride = row_stride[:, None, None, None, None]
    oor = by(oor_y) | bx(oor_x)

    idx = torch.stack([off + by(y_low) * stride + bx(x_low),
                       off + by(y_low) * stride + bx(x_high),
                       off + by(y_high) * stride + bx(x_low),
                       off + by(y_high) * stride + bx(x_high)], dim=-1)
    w = torch.stack([by(hy) * bx(hx), by(hy) * bx(lx),
                     by(ly) * bx(hx), by(ly) * bx(lx)], dim=-1)
    w = torch.where(oor[..., None], torch.zeros_like(w), w)
    return idx, w


def _gather_pool(flat_rows: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 y_mask: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """Gather corner rows, combine bilinearly, average the bins, for one
    chunk of ROIs.  flat_rows (R+1, C) with a zero row last; idx/w
    (K, P, S, P, S, 4); masks (K, P, S).  Returns (K, P, P, C) float32."""
    k, p, s = idx.shape[:3]
    c = flat_rows.shape[1]
    sw = y_mask[:, :, :, None, None] * x_mask[:, None, None, :, :]
    pooled = torch.zeros((k, p, p, c), dtype=torch.float32, device=flat_rows.device)
    for corner in range(4):
        # index_select, not flat_rows[...]: the same rows, but its backward
        # is index_add_, which sums in index order on the CPU, where the
        # advanced index's (index_put_ with accumulate) order depends on the
        # threads, so that a training step's gradients varied from run to run
        rows = torch.index_select(flat_rows, 0, idx[..., corner].reshape(-1))
        rows = rows.reshape(k, p, s, p, s, c).to(torch.float32)
        wgt = (w[..., corner] * sw)[..., None]
        pooled = pooled + (rows * wgt).sum(dim=(2, 4))
    cnt = y_mask[:, 0, :].sum(dim=1) * x_mask[:, 0, :].sum(dim=1)
    return pooled / cnt.clamp(min=1.0)[:, None, None, None]


def _chunks(counts: Sequence[int], chunk: int) -> Sequence[Tuple[int, int]]:
    """[lo, hi) runs over ascending per-ROI sample counts, each run holding
    at most chunk * 4^2 sampled points per bin (at least one ROI)."""
    budget = max(1, chunk) * _BUDGET_SAMPLES ** 2
    runs, lo, n = [], 0, len(counts)
    while lo < n:
        k = max(1, budget // max(1, counts[lo]) ** 2)
        while k > 1 and k * counts[min(n, lo + k) - 1] ** 2 > budget:
            k = max(1, budget // counts[min(n, lo + k) - 1] ** 2)
        runs.append((lo, min(n, lo + k)))
        lo += k
    return runs


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int = 2,
                           max_level: int = 5, canonical_size: float = 224.0,
                           canonical_level: int = 4) -> torch.Tensor:
    """detectron2 `assign_boxes_to_levels`: (N, 4) -> (N,) int64 levels."""
    area = ((boxes[:, 2] - boxes[:, 0]).clamp(min=0)
            * (boxes[:, 3] - boxes[:, 1]).clamp(min=0))
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int64)


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor, *,
                         strides: Sequence[int], output_size: int,
                         sampling_ratio: int, aligned: bool,
                         min_level: int = 2, chunk: int = 128,
                         adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """FPN ROIAlign over levels p2..p5 for ONE image, each ROI at
    detectron2's sqrt-area level.

    features: (H_l, W_l, C) maps, fine -> coarse; boxes (N, 4).  `chunk`
    ROIs at 4 samples per bin set the gather buffer's size.
    Returns (N, P, P, C) in the features' dtype.
    """
    c = features[0].shape[-1]
    dev = boxes.device
    lvl = assign_boxes_to_levels(boxes, min_level=min_level,
                                 max_level=min_level + len(features) - 1) - min_level

    hs = torch.tensor([f.shape[0] for f in features], dtype=torch.int64, device=dev)
    ws = torch.tensor([f.shape[1] for f in features], dtype=torch.int64, device=dev)
    offs = torch.cumsum(hs * ws, 0) - hs * ws
    total = int(sum(f.shape[0] * f.shape[1] for f in features))
    flat = torch.cat([f.reshape(-1, c) for f in features]
                     + [features[0].new_zeros((1, c))], dim=0)

    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)[lvl]
    counts = sample_counts(boxes, scales, output_size, sampling_ratio, aligned,
                           adaptive_cap)
    order = torch.argsort(counts, stable=True)
    out = torch.empty((boxes.shape[0], output_size, output_size, c),
                      dtype=torch.float32, device=dev)
    for lo, hi in _chunks(counts[order].tolist(), chunk):
        r = order[lo:hi]
        ys, xs, y_mask, x_mask = _sample_coords(boxes[r], scales[r], output_size,
                                                sampling_ratio, aligned, adaptive_cap)
        idx, wgt = _corner_indices_weights(ys, xs, hs[lvl[r]], ws[lvl[r]],
                                           offs[lvl[r]], ws[lvl[r]])
        idx = torch.where(wgt > 0, idx, torch.full_like(idx, total)).clamp(0, total)
        out[r] = _gather_pool(flat, idx, wgt, y_mask, x_mask)
    return out.to(features[0].dtype)
