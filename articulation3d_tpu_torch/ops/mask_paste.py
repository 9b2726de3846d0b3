"""Mask pasting with optional per-pixel mask NMS.

Counterpart of `articulation3d_tpu/ops/mask_paste.py` (the reference's
`paste_masks_in_image`, `F.grid_sample(align_corners=False)` semantics): for
image pixel centre i + 0.5 the mask coordinate is

    m = (i + 0.5 - box_lo) / (box_hi - box_lo) * M - 0.5

sampled bilinearly with zero padding outside the mask.  With `nms`, a pixel
keeps only the instance whose soft pasted value is the largest (ties keep
all).
"""

from __future__ import annotations

import torch


def _sample_1d(coord: torch.Tensor, mask_size: int):
    """grid_sample-style zero-padded bilinear indices and weights."""
    i0 = torch.floor(coord).to(torch.int64)
    i1 = i0 + 1
    w1 = coord - i0.to(coord.dtype)
    w0 = 1.0 - w1
    zero = torch.zeros_like(w0)
    w0 = torch.where((i0 >= 0) & (i0 < mask_size), w0, zero)
    w1 = torch.where((i1 >= 0) & (i1 < mask_size), w1, zero)
    return i0.clamp(0, mask_size - 1), i1.clamp(0, mask_size - 1), w0, w1


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                image_height: int, image_width: int, *,
                threshold: float = 0.5, nms: bool = False) -> torch.Tensor:
    """Paste (N, M, M) soft masks of one image into (N, H, W).

    Returns bool masks if `threshold >= 0`, else the soft float masks.
    Invalid instances come out all-False / all-zero and never win mask NMS.
    """
    n, m, _ = masks.shape
    dev = masks.device
    y = torch.arange(image_height, dtype=torch.float32, device=dev) + 0.5
    x = torch.arange(image_width, dtype=torch.float32, device=dev) + 0.5
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    h_span = (y1 - y0).clamp(min=1e-6)
    w_span = (x1 - x0).clamp(min=1e-6)
    my = (y[None, :] - y0[:, None]) / h_span[:, None] * m - 0.5   # (N, H)
    mx = (x[None, :] - x0[:, None]) / w_span[:, None] * m - 0.5   # (N, W)
    yi0, yi1, yw0, yw1 = _sample_1d(my, m)
    xi0, xi1, xw0, xw1 = _sample_1d(mx, m)

    # separable bilinear: rows, then columns
    gather_rows = lambda idx: torch.gather(masks, 1, idx[:, :, None].expand(n, image_height, m))
    rows = gather_rows(yi0) * yw0[:, :, None] + gather_rows(yi1) * yw1[:, :, None]
    gather_cols = lambda idx: torch.gather(
        rows, 2, idx[:, None, :].expand(n, image_height, image_width))
    soft = gather_cols(xi0) * xw0[:, None, :] + gather_cols(xi1) * xw1[:, None, :]
    soft = torch.where(valid[:, None, None], soft, torch.zeros_like(soft))

    if nms and n:
        best = soft.amax(dim=0, keepdim=True)
        soft = torch.where(best != soft, torch.zeros_like(soft), soft)
    if threshold >= 0:
        return (soft >= threshold) & valid[:, None, None]
    return soft
