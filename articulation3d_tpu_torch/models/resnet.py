"""ResNet backbone with frozen BatchNorm, Caffe layout (stride in the 1x1).

Counterpart of `articulation3d_tpu/models/resnet.py`, as detectron2's
`ResNet` with module names that are the d2 state-dict keys
(`stem.conv1`, `res{2..5}.{block}.{conv1,conv2,conv3,shortcut}` with the
FrozenBN as the conv's `norm` child).  NCHW throughout (cuDNN's layout).
The stem is the plain 7x7/s2 conv: the JAX package's space-to-depth stem
computes the same function for the TPU's matrix unit.

`cfg.remat` (JAX `nn.remat(Bottleneck)`): in a training forward with
grad enabled, each Bottleneck of res2-res5 that takes a gradient runs
through `torch.utils.checkpoint`, so only the blocks' inputs and outputs
stay live and each block's interior is recomputed on the backward pass.
Inference and frozen blocks run as without it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ResNetConfig

_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics (d2 FrozenBatchNorm2d, eps 1e-5)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None].to(x.dtype) + shift[None, :, None, None].to(x.dtype)


class Conv2dNorm(nn.Conv2d):
    """d2 `Conv2d` with its norm as a child (keys `X.weight`, `X.norm.*`)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                         bias=False)
        self.norm = FrozenBatchNorm2d(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1; the stride sits on the first 1x1 when
    stride_in_1x1 (Caffe/MSRA layout of d2 checkpoints)."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int,
                 stride_in_1x1: bool, has_shortcut: bool):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if has_shortcut:
            self.shortcut = Conv2dNorm(cin, cout, 1, stride)
        self.conv1 = Conv2dNorm(cin, bottleneck, 1, s1)
        self.conv2 = Conv2dNorm(bottleneck, bottleneck, 3, s3)
        self.conv3 = Conv2dNorm(bottleneck, cout, 1, 1)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = self.shortcut(x) if hasattr(self, "shortcut") else x
        return F.relu(out + sc)


class BasicStem(nn.Module):
    """7x7/s2 conv + FrozenBN + relu + 3x3/s2 max pool."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.conv1 = Conv2dNorm(3, out_channels, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


class ResNet(nn.Module):
    """Returns {"res2": ..., "res5": ...} NCHW stage outputs."""

    def __init__(self, cfg: ResNetConfig = ResNetConfig()):
        super().__init__()
        if cfg.num_groups != 1:
            raise NotImplementedError("grouped (ResNeXt) blocks are not ported")
        self.cfg = cfg
        self.stem = BasicStem(cfg.stem_out_channels)
        cin = cfg.stem_out_channels
        out_ch, bott = cfg.res2_out_channels, cfg.stem_out_channels
        for i, n_blocks in enumerate(_STAGE_BLOCKS[cfg.depth]):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin if b == 0 else out_ch, bott, out_ch,
                                         stride if b == 0 else 1,
                                         cfg.stride_in_1x1, has_shortcut=b == 0))
            setattr(self, f"res{i + 2}", nn.Sequential(*blocks))
            cin = out_ch
            out_ch *= 2
            bott *= 2
        self.freeze(cfg.freeze_at)

    def freeze(self, freeze_at: int) -> None:
        """d2 `freeze`: the stem (at >= 1) and res2..res{freeze_at} take no
        gradient."""
        stages = [self.stem] + [getattr(self, f"res{i}") for i in range(2, 6)]
        for stage in stages[:max(0, freeze_at)]:
            for prm in stage.parameters():
                prm.requires_grad_(False)

    def _stage(self, stage: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        if not (self.cfg.remat and self.training and torch.is_grad_enabled()):
            return stage(x)
        for block in stage:
            if x.requires_grad or any(p.requires_grad for p in block.parameters()):
                # the blocks draw no random numbers: no RNG state to keep
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        return x

    def forward(self, x):
        x = self.stem(x)
        outputs = {}
        for i in range(2, 6):
            x = self._stage(getattr(self, f"res{i}"), x)
            if f"res{i}" in self.cfg.out_features:
                outputs[f"res{i}"] = x
        return outputs
