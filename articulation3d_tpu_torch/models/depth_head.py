"""Full-image monocular depth decoder off the FPN pyramid.

Counterpart of `articulation3d_tpu/models/depth_head.py` with the
reference's module names: five lanes `conv{i}` = (3x3 conv 256->128, BN)
+ leaky relu 0.01 on p6..p2, merged coarse to fine by `deconv{i}` =
(nearest 2x upsample, 3x3 conv, BN) + relu with channel concat, a bilinear
resize of the p6 lane onto p5's grid, a 3x3 `depth_pred` and a bilinear
resize to the output size.  BatchNorms (eps 1e-3) run on stored statistics
(eval mode).  Every bilinear resize is `F.interpolate(mode="bilinear",
align_corners=False)`, which the JAX package's 2x stencil equals
(tests/test_model.py pins it).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import DepthHeadConfig

_DECONV = {1: (128, 128), 2: (256, 128), 3: (256, 128), 4: (256, 128), 5: (256, 64)}


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


class DepthHead(nn.Module):
    def __init__(self, cfg: DepthHeadConfig = DepthHeadConfig(), in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        for i in range(1, 6):
            setattr(self, f"conv{i}", nn.Sequential(
                nn.Conv2d(in_channels, 128, 3, padding=1),
                nn.BatchNorm2d(128, eps=1e-3, momentum=0.01)))
        for i, (cin, cout) in _DECONV.items():
            setattr(self, f"deconv{i}", nn.Sequential(
                nn.Upsample(scale_factor=2, mode="nearest"),
                nn.Conv2d(cin, cout, 3, padding=1),
                nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01)))
        self.depth_pred = nn.Conv2d(64, 1, 3, padding=1)

    def _deconv(self, i: int, x: torch.Tensor, target_hw=None) -> torch.Tensor:
        up, conv, bn = getattr(self, f"deconv{i}")
        x = up(x)
        if target_hw is not None and tuple(x.shape[2:]) != tuple(target_hw):
            # odd pyramid sizes leave the 2x upsample off the skip's grid
            x = _resize(x, target_hw)
        return F.relu(bn(conv(x).to(torch.float32)))

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """features: p2..p6 NCHW -> (B, output_height, output_width) float32."""
        lanes = {}
        for i, name in enumerate(("p6", "p5", "p4", "p3", "p2")):
            conv, bn = getattr(self, f"conv{i + 1}")
            lanes[name] = F.leaky_relu(bn(conv(features[name]).to(torch.float32)), 0.01)
        hw = lambda n: features[n].shape[2:]
        x = self._deconv(1, lanes["p6"])
        x = _resize(x, hw("p5"))
        x = self._deconv(2, torch.cat([lanes["p5"], x], 1), hw("p4"))
        x = self._deconv(3, torch.cat([lanes["p4"], x], 1), hw("p3"))
        x = self._deconv(4, torch.cat([lanes["p3"], x], 1), hw("p2"))
        x = self._deconv(5, torch.cat([lanes["p2"], x], 1))
        with torch.autocast(x.device.type, enabled=False):
            x = self.depth_pred(x.to(torch.float32))
        x = _resize(x, (self.cfg.output_height, self.cfg.output_width))
        return x[:, 0]
