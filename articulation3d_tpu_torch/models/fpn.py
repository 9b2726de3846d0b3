"""FPN neck over the ResNet stages (counterpart of `models/fpn.py`).

detectron2 `build_resnet_fpn_backbone` semantics and key names
(`bottom_up`, `fpn_lateral{l}`, `fpn_output{l}`): 1x1 laterals, top-down
nearest 2x upsampling with sum fusion, 3x3 outputs, and p6 as a stride-2
1x1 max pool of p5.  NCHW in and out.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import FPNConfig
from .resnet import ResNet

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
_STAGE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


class FPN(nn.Module):
    def __init__(self, bottom_up: ResNet, cfg: FPNConfig = FPNConfig()):
        super().__init__()
        self.cfg = cfg
        self.bottom_up = bottom_up
        scale = bottom_up.cfg.res2_out_channels / 256
        for name in cfg.in_features:
            lvl = int(name[-1])
            cin = int(_STAGE_CHANNELS[name] * scale)
            setattr(self, f"fpn_lateral{lvl}", nn.Conv2d(cin, cfg.out_channels, 1))
            setattr(self, f"fpn_output{lvl}",
                    nn.Conv2d(cfg.out_channels, cfg.out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom_up = self.bottom_up(x)
        lvls = [int(n[-1]) for n in self.cfg.in_features]
        laterals = [getattr(self, f"fpn_lateral{l}")(bottom_up[f"res{l}"])
                    for l in lvls]
        merged = [None] * len(laterals)
        merged[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(merged[i + 1], scale_factor=2, mode="nearest")
            up = up[:, :, :laterals[i].shape[2], :laterals[i].shape[3]]
            merged[i] = laterals[i] + up
            if self.cfg.fuse_type == "avg":
                merged[i] = merged[i] * 0.5
        out = {f"p{l}": getattr(self, f"fpn_output{l}")(m)
               for l, m in zip(lvls, merged)}
        out["p6"] = F.max_pool2d(out[f"p{lvls[-1]}"], 1, stride=2)
        return out
