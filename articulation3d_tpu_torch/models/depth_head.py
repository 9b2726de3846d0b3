"""Full-image monocular depth decoder off the FPN pyramid.

Counterpart of `articulation3d_tpu/models/depth_head.py` with the
reference's module names: five lanes `conv{i}` = (3x3 conv 256->128, BN)
+ leaky relu 0.01 on p6..p2, merged coarse to fine by `deconv{i}` =
(nearest 2x upsample, 3x3 conv, BN) + relu with channel concat, a bilinear
resize of the p6 lane onto p5's grid, a 3x3 `depth_pred` and a bilinear
resize to the output size.  BatchNorms (eps 1e-3) run on stored statistics
unless `train=True`, where they normalise with the batch statistics and
update the stored ones as flax's `BatchNorm(momentum=0.99)` does (torch
momentum 0.01; the biased batch variance in both places).  Every bilinear
resize is `F.interpolate(mode="bilinear", align_corners=False)`, which the
JAX package's 2x stencil equals (tests/test_model.py pins it).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import DepthHeadConfig
from ..parallel.dist import all_reduce_sum, global_count, process_count

_DECONV = {1: (128, 128), 2: (256, 128), 3: (256, 128), 4: (256, 128), 5: (256, 64)}


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose mode is an argument, as in flax: eval mode uses the
    stored statistics whatever `self.training` says; train mode normalises
    with the batch mean and biased variance (float32) and moves the stored
    statistics by `momentum` towards them.  torch's own BatchNorm would
    store the unbiased variance instead.

    The variance is taken in two passes, mean((x - mean)^2).  flax's default
    one-pass E[x^2] - E[x]^2 loses the variance's leading digits to
    cancellation where a channel's mean is large against its spread, as on
    the few cells of the coarse lanes: there a 1e-6 change of the input
    moves the head's gradients by 1e-3 of their size (ROADMAP.md section 3).

    The batch statistics are this rank's rows' (JAX's sharded step, where
    `nn.BatchNorm` has no `axis_name`), or with `over_ranks` the global
    batch's (JAX's `make_train_step` over a mesh): then the sums and counts
    are all-reduced for the mean, then the squared deviations for the
    variance, both through a differentiable all-reduce
    (`parallel.dist.all_reduce_sum`)."""

    def forward(self, x: torch.Tensor, train: bool = False,
                over_ranks: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        xf = x.to(torch.float32)
        if not over_ranks or process_count() == 1:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
        else:
            n = global_count(torch.tensor(float(xf.numel() // xf.shape[1]),
                                          device=xf.device))
            mean = all_reduce_sum(xf.sum(dim=(0, 2, 3))) / n
            dev2 = (xf - mean[None, :, None, None]).square().sum(dim=(0, 2, 3))
            var = all_reduce_sum(dev2) / n
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[None, :, None, None]) * inv[None, :, None, None] \
            + self.bias[None, :, None, None]


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class DepthHead(nn.Module):
    def __init__(self, cfg: DepthHeadConfig = DepthHeadConfig(), in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        for i in range(1, 6):
            setattr(self, f"conv{i}", nn.Sequential(
                nn.Conv2d(in_channels, 128, 3, padding=1),
                BatchNorm2d(128, eps=1e-3, momentum=0.01)))
        for i, (cin, cout) in _DECONV.items():
            setattr(self, f"deconv{i}", nn.Sequential(
                nn.Upsample(scale_factor=2, mode="nearest"),
                nn.Conv2d(cin, cout, 3, padding=1),
                BatchNorm2d(cout, eps=1e-3, momentum=0.01)))
        self.depth_pred = nn.Conv2d(64, 1, 3, padding=1)

    def _deconv(self, i: int, x: torch.Tensor, train: bool, over_ranks: bool,
                target_hw=None) -> torch.Tensor:
        up, conv, bn = getattr(self, f"deconv{i}")
        x = up(x)
        if target_hw is not None and tuple(x.shape[2:]) != tuple(target_hw):
            # odd pyramid sizes leave the 2x upsample off the skip's grid
            x = _resize(x, target_hw)
        return F.relu(bn(conv(x).to(torch.float32), train, over_ranks))

    def forward(self, features: Dict[str, torch.Tensor], train: bool = False,
                over_ranks: bool = False) -> torch.Tensor:
        """features: p2..p6 NCHW -> (B, output_height, output_width) float32.
        `train=True` runs the BatchNorms on batch statistics (with
        `over_ranks`, the global batch's) and updates the stored ones."""
        lanes = {}
        for i, name in enumerate(("p6", "p5", "p4", "p3", "p2")):
            conv, bn = getattr(self, f"conv{i + 1}")
            lanes[name] = F.leaky_relu(
                bn(conv(features[name]).to(torch.float32), train, over_ranks), 0.01)
        hw = lambda n: features[n].shape[2:]
        x = self._deconv(1, lanes["p6"], train, over_ranks)
        x = _resize(x, hw("p5"))
        x = self._deconv(2, torch.cat([lanes["p5"], x], 1), train, over_ranks, hw("p4"))
        x = self._deconv(3, torch.cat([lanes["p4"], x], 1), train, over_ranks, hw("p3"))
        x = self._deconv(4, torch.cat([lanes["p3"], x], 1), train, over_ranks, hw("p2"))
        x = self._deconv(5, torch.cat([lanes["p2"], x], 1), train, over_ranks)
        with torch.autocast(x.device.type, enabled=False):
            x = self.depth_pred(x.to(torch.float32))
        x = _resize(x, (self.cfg.output_height, self.cfg.output_width))
        return x[:, 0]


def depth_l1_loss_masked(pred: torch.Tensor, gt: torch.Tensor,
                         over_ranks: bool = False) -> torch.Tensor:
    """Masked L1: the mean of |pred - gt| where gt > 1e-4 (reference
    `depth_head.py:19-21,95`); with `over_ranks` the count of such pixels
    is the global batch's."""
    mask = (gt > 1e-4).to(pred.dtype)
    n = global_count(mask.sum()) if over_ranks else mask.sum()
    return ((pred - gt).abs() * mask).sum() / n.clamp(min=1.0)
