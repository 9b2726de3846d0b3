"""Image preprocessing on the device: resize -> normalize -> pad.

Counterpart of `articulation3d_tpu/ops/preprocess.py`: cv2-compatible
bilinear resize (half-pixel centres), Caffe-style BGR mean subtraction
(pixel_mean (103.53, 116.28, 123.675), std 1.0) and zero padding to a
multiple of `size_divisibility`.  Frames stay channels-last (B, H, W, 3)
BGR, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import tracing


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR)-compatible bilinear resize of (H, W, C) or
    (B, H, W, C) float images."""
    batched = img.dim() == 4
    if not batched:
        img = img[None]
    _, h, w, _ = img.shape

    def axis_coords(out_n, in_n):
        scale = in_n / out_n
        coords = ((torch.arange(out_n, dtype=torch.float32, device=img.device)
                   + 0.5) * scale - 0.5)
        i0 = torch.floor(coords).to(torch.int64)
        frac = coords - i0.to(torch.float32)
        return i0.clamp(0, in_n - 1), (i0 + 1).clamp(0, in_n - 1), frac

    y0, y1, fy = axis_coords(height, h)
    x0, x1, fx = axis_coords(width, w)
    fx = fx[None, None, :, None]
    fy = fy[None, :, None, None]
    r0, r1 = img[:, y0], img[:, y1]
    top = r0[:, :, x0] * (1 - fx) + r0[:, :, x1] * fx
    bot = r1[:, :, x0] * (1 - fx) + r1[:, :, x1] * fx
    out = top * (1 - fy) + bot * fy
    return out if batched else out[0]


def sem_seg_postprocess(result: torch.Tensor, img_size: Tuple[int, int],
                        output_height: int, output_width: int) -> torch.Tensor:
    """Semantic-segmentation logits (C, H, W) -> float32 (C, out_h, out_w):
    crop the size-divisibility padding off to `img_size`, then resize with
    half-pixel centres to the original resolution (the reference's
    `modeling/postprocessing.py:77-98`; the PlaneRCNN flow does not use it)."""
    cropped = result[:, :img_size[0], :img_size[1]]
    out = resize_bilinear(cropped.permute(1, 2, 0).to(torch.float32),
                          output_height, output_width)
    return out.permute(2, 0, 1)


def preprocess_images(images: torch.Tensor,
                      pixel_mean: Tuple[float, float, float] = (103.53, 116.28, 123.675),
                      pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                      *, height: int = 480, width: int = 640,
                      size_divisibility: int = 32) -> torch.Tensor:
    """(B, H, W, 3) uint8/float BGR frames -> normalized padded (B, H', W', 3)
    float32."""
    x = images.to(torch.float32)
    if x.shape[1] != height or x.shape[2] != width:
        x = resize_bilinear(x, height, width)
    with tracing.sync("preprocess", x):
        mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    with tracing.sync("preprocess", x):
        std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    d = size_divisibility
    ph = (d - height % d) % d
    pw = (d - width % d) % d
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    return x
