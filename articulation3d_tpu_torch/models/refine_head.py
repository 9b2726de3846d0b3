"""Mask-refinement head (NVIDIA PlaneRCNN style).

Counterpart of `articulation3d_tpu/models/refine_head.py` (the reference's
`PlaneRCNNRefineHead` / `RefinementNet` / `RefinementBlockMask`):

  * a per-instance U-Net over [image(3) | raw depth(1) | mask(1) |
    plane XYZ(3) | other masks(1)] at 192x256;
  * cross-instance pooling: each level concatenates the mean of the OTHER
    valid instances' features;
  * a global branch from the means over valid instances predicts the
    background logit;
  * plane offsets recomputed from the depth inside each soft mask, and the
    plane-induced XYZ maps of `planeXYZModule` with depth clamped to
    [0, max_depth].

The detections are a fixed stack of D rows with a `valid` mask: invalid
rows take no part in any cross-instance sum or mean, in the loss or in the
inference argmax.  The rays are the EVAL intrinsics' [u, 1, -v] with
f = 571.623718.

The public functions keep the JAX package's layouts (rays (H, W, 3), XYZ
maps (D, H, W, 3)); the U-Net runs NCHW in float32, as the JAX head (which
takes no dtype) does.  Module names are the reference's
(`refinement_block.{conv_0, conv_1, conv_1_1, conv_2, conv_2_1, up_2,
up_1, pred, global_up_2, global_up_1, global_pred}`), each conv block
holding its layer as `conv`.

Padding follows flax's "SAME": a 3x3 conv of stride 2 on an even size pads
one row and column at the END (torch's symmetric padding=1 would shift the
sampling grid by one input cell), and a 4x4 stride-2 transposed conv is
torch's `ConvTranspose2d(k=4, s=2, p=1)` with the flax kernel flipped in
both spatial axes (`weights.py` converts it; `tests/test_torch_refine.py`
pins both against flax).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RefineHeadConfig


def refine_ranges(h: int = 480, w: int = 640,
                  focal_length: float = 571.623718) -> torch.Tensor:
    """(h, w, 3) rays [u, 1, -v] (reference `get_ranges`), float32."""
    u = ((np.arange(w, dtype=np.float32) + 0.5) - w / 2.0) / focal_length
    v = ((np.arange(h, dtype=np.float32) + 0.5) - h / 2.0) / focal_length
    uu = np.tile(u[None, :], (h, 1))
    vv = np.tile(v[:, None], (1, w))
    return torch.from_numpy(np.stack([uu, np.ones_like(uu), -vv], axis=-1))


@functools.lru_cache(maxsize=8)
def _ranges_on(h: int, w: int, focal_length: float, device: torch.device) -> torch.Tensor:
    return refine_ranges(h, w, focal_length).to(device)


def plane_xyz_module(planes: torch.Tensor, ranges: torch.Tensor,
                     max_depth: float = 10.0) -> torch.Tensor:
    """Plane-induced XYZ maps (reference `planeXYZModule`).

    planes (D, 3) normal * offset in the rays' convention; ranges (H, W, 3).
    Returns (D, H, W, 3).  An all-zero plane row (a padded detection) has
    offset 0 and a zero gradient, not 0/0 (the square root is guarded).
    """
    sq = (planes * planes).sum(dim=-1, keepdim=True)
    nz = sq > 0
    offsets = torch.sqrt(torch.where(nz, sq, torch.ones_like(sq)))
    offsets = torch.where(nz, offsets, torch.zeros_like(offsets))          # (D, 1)
    normals = planes / offsets.clamp(min=1e-4)
    nx = torch.einsum("hwc,dc->dhw", ranges, normals)
    nx = torch.where(nx == 0.0, torch.full_like(nx, 1e-4), nx)
    depths = (offsets[:, :, None] / nx).clamp(0.0, max_depth)             # (D, H, W)
    return depths[..., None] * ranges[None]


def recompute_plane_offsets(normals: torch.Tensor, masks: torch.Tensor,
                            depth: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """offset = mean of n . (depth * ray) inside each soft mask; returns
    planes = n * offset (D, 3)."""
    xyz = ranges * depth[..., None]                                        # (H, W, 3)
    ndot = torch.einsum("dc,hwc->dhw", normals, xyz)
    num = (ndot * masks).sum(dim=(1, 2))
    den = masks.sum(dim=(1, 2)).clamp(min=1e-4)
    return normals * (num / den)[:, None]


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of the last two axes of a (..., H, W) tensor:
    `F.interpolate(mode="bilinear", align_corners=False)`, no antialias (as
    JAX's `jax.image.resize(..., antialias=False)`)."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, h, w)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/lax "SAME" padding of one axis: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` (built without padding) with flax's "SAME" padding: padded in
    the convolution where both sides match, else by `F.pad` first."""
    (k, _), (s, _) = conv.kernel_size, conv.stride
    (t, b), (lf, r) = (_same_pads(n, k, s) for n in x.shape[2:])
    if t == b and lf == r:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, (t, lf))
    return conv(F.pad(x, (lf, r, t, b)))


class ConvBlock(nn.Module):
    """conv (3x3, "SAME") or deconv (4x4, stride 2) + ReLU, no norm."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 mode: str = "conv"):
        super().__init__()
        self.mode = mode
        if mode == "conv":
            self.conv = nn.Conv2d(cin, cout, kernel, stride)
        else:
            self.conv = nn.ConvTranspose2d(cin, cout, kernel, stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(same_conv(self.conv, x) if self.mode == "conv" else self.conv(x))


class RefinementBlock(nn.Module):
    """Per-image instance-stack U-Net (reference `RefinementBlockMask`)."""

    def __init__(self):
        super().__init__()
        self.conv_0 = ConvBlock(3 + 6, 32)
        self.conv_1 = ConvBlock(64, 64, stride=2)
        self.conv_1_1 = ConvBlock(128, 64)
        self.conv_2 = ConvBlock(128, 128, stride=2)
        self.conv_2_1 = ConvBlock(256, 128)
        self.up_2 = ConvBlock(128, 64, kernel=4, stride=2, mode="deconv")
        self.up_1 = ConvBlock(128, 32, kernel=4, stride=2, mode="deconv")
        self.pred = nn.Sequential(ConvBlock(64, 16), nn.Conv2d(16, 1, 3))
        self.global_up_2 = ConvBlock(128, 64, kernel=4, stride=2, mode="deconv")
        self.global_up_1 = ConvBlock(128, 32, kernel=4, stride=2, mode="deconv")
        self.global_pred = nn.Sequential(ConvBlock(64, 16), nn.Conv2d(16, 1, 3))

    @staticmethod
    def accumulate(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """cat[x, mean of the OTHER valid instances] along channels."""
        v = valid.to(x.dtype)[:, None, None, None]
        total = (x * v).sum(dim=0, keepdim=True)
        count = valid.sum().to(x.dtype)
        others = (total - x * v) / (count - 1.0).clamp(min=1.0)
        return torch.cat([x, others], dim=1)

    @staticmethod
    def mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(1, C, h, w) mean over the valid instances."""
        v = valid.to(x.dtype)[:, None, None, None]
        count = valid.sum().to(x.dtype).clamp(min=1.0)
        return (x * v).sum(dim=0, keepdim=True) / count

    def forward(self, image: torch.Tensor, masks: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """image (D, 3, h, w); masks (D, 6, h, w); valid (D,) ->
        (D+1, h, w) logits: [global background, per instance]."""
        acc = lambda x: self.accumulate(x, valid)
        x0 = self.conv_0(torch.cat([image, masks], dim=1))
        x1 = self.conv_1(acc(x0))
        x1 = self.conv_1_1(acc(x1))
        x2 = self.conv_2(acc(x1))
        x2 = self.conv_2_1(acc(x2))

        y2 = self.up_2(x2)
        y1 = self.up_1(torch.cat([y2, x1], dim=1))
        y0 = self.pred[0](torch.cat([y1, x0], dim=1))
        y0 = same_conv(self.pred[1], y0)

        g2 = self.global_up_2(self.mean(x2, valid))
        g1 = self.global_up_1(torch.cat([g2, self.mean(x1, valid)], dim=1))
        g0 = self.global_pred[0](torch.cat([g1, self.mean(x0, valid)], dim=1))
        g0 = same_conv(self.global_pred[1], g0)
        return torch.cat([g0[:, 0], y0[:, 0]], dim=0)


class RefineHead(nn.Module):
    """The refine pass of ONE image (the caller loops over the batch)."""

    def __init__(self, cfg: RefineHeadConfig = RefineHeadConfig()):
        super().__init__()
        self.cfg = cfg
        self.refinement_block = RefinementBlock()

    def forward(self, raw_image: torch.Tensor, soft_masks: torch.Tensor,
                planes: torch.Tensor, depth: torch.Tensor,
                valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw_image (H, W, 3) BGR 0..255; soft_masks (D, H, W) pasted soft
        masks in [0, 1]; planes (D, 3) unit normals (plane head, rays'
        convention); depth (H, W); valid (D,) bool.
        Returns (logits (D+1, hr, wr), plane_params (D, 3))."""
        cfg = self.cfg
        full_h, full_w = depth.shape
        ranges = _ranges_on(full_h, full_w, cfg.focal_length, depth.device)
        d = soft_masks.shape[0]
        hr, wr = cfg.height, cfg.width

        vmask = valid.to(torch.float32)[:, None, None]
        masks = soft_masks * vmask
        plane_params = recompute_plane_offsets(planes, masks, depth, ranges)
        plane_params = torch.where(valid[:, None], plane_params,
                                   torch.zeros_like(plane_params))
        xyz_plane = plane_xyz_module(plane_params, ranges, cfg.max_depth)

        image = _resize((raw_image / 255.0).permute(2, 0, 1), hr, wr)      # (3, hr, wr)
        image = image[None].expand(d, 3, hr, wr)
        masks_r = _resize(masks, hr, wr)                                   # (D, hr, wr)
        xyz_r = _resize(xyz_plane.permute(0, 3, 1, 2), hr, wr)             # (D, 3, hr, wr)
        depth_r = _resize(depth[None], hr, wr)                             # (1, hr, wr)
        # the reference's prev_predictions: [raw depth, mask, XYZ(3), others]
        others = (masks_r * vmask).sum(dim=0, keepdim=True) - masks_r * vmask
        stack = torch.cat([depth_r[None].expand(d, 1, hr, wr), masks_r[:, None],
                           xyz_r, others[:, None]], dim=1)                 # (D, 6, hr, wr)
        logits = self.refinement_block(image, stack, valid)
        return logits, plane_params


def refine_inference_masks(logits: torch.Tensor, valid: torch.Tensor,
                           out_h: int, out_w: int) -> torch.Tensor:
    """argmax over [background, instances] -> per-instance one-hot masks,
    resized to (D, out_h, out_w) float32."""
    d = logits.shape[0] - 1
    gated = torch.cat([logits[:1], torch.where(valid[:, None, None], logits[1:],
                                               torch.full_like(logits[1:], -1e10))])
    winner = gated.argmax(dim=0)                                           # (hr, wr)
    ids = torch.arange(1, d + 1, device=logits.device)[:, None, None]
    return _resize((winner[None] == ids).to(torch.float32), out_h, out_w)


def assign_pred_masks(gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                      pred_masks: torch.Tensor, pred_valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-best-intersection matching (reference
    `assign_pred_mask_with_gt_mask`).  gt_masks (G, H, W) binary;
    pred_masks (D, H, W) soft.  Returns (the GT index per prediction (D,),
    its weight (D,) float32)."""
    rounded = torch.round(pred_masks)
    inter = torch.einsum("ghw,dhw->gd", gt_masks, rounded)
    inter = torch.where(gt_valid[:, None] & pred_valid[None, :], inter,
                        torch.full_like(inter, -1.0))
    segments_gt = inter.argmax(dim=0)                                      # (D,)
    mapping = inter.argmax(dim=1)                                          # (G,)
    mutual = mapping[segments_gt] == torch.arange(pred_masks.shape[0],
                                                  device=pred_masks.device)
    w = (mutual & pred_valid & gt_valid[segments_gt]).to(torch.float32)
    return segments_gt, w


def refine_loss_single(logits: torch.Tensor, gt_masks: torch.Tensor,
                       gt_valid: torch.Tensor, pred_masks: torch.Tensor,
                       pred_valid: torch.Tensor) -> torch.Tensor:
    """Per-image weighted cross-entropy over [background, instances]
    (reference `loss`).  logits (D+1, hr, wr); gt_masks (G, H, W) binary;
    pred_masks (D, H, W) soft, at full resolution, for the assignment.
    Zero for an image without a valid prediction (the reference skips it)."""
    hr, wr = logits.shape[1:]
    seg_idx, w_inst = assign_pred_masks(gt_masks, gt_valid, pred_masks, pred_valid)
    assigned = gt_masks[seg_idx] * w_inst[:, None, None]                   # (D, H, W)
    assigned_r = _resize(assigned, hr, wr)
    bg = 1.0 - assigned_r.amax(dim=0, keepdim=True)
    target = torch.cat([bg, assigned_r], dim=0).argmax(dim=0)              # (hr, wr)
    logp = F.log_softmax(logits, dim=0)
    nll = -torch.gather(logp, 0, target[None])[0]
    weights = torch.cat([torch.ones(1, device=logits.device), w_inst])
    pix_w = weights[target]
    loss = (nll * pix_w).sum() / pix_w.sum().clamp(min=1e-8)
    return torch.where(pred_valid.any(), loss, torch.zeros_like(loss))
