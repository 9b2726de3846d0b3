"""FPN neck over the ResNet stages (counterpart of `models/fpn.py`).

detectron2 `build_resnet_fpn_backbone` semantics and key names
(`bottom_up`, `fpn_lateral{l}`, `fpn_output{l}`): 1x1 laterals, top-down
nearest 2x upsampling with sum fusion, 3x3 outputs, and p6 as a stride-2
1x1 max pool of p5.  NCHW in and out.

On the card an inference call replays the trunk from a CUDA graph
(`TrunkGraphs`): the same kernels as the eager forward, with one host
launch in place of the ~780 that ResNet-50 + FPN make a call.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import tracing
from ..config import FPNConfig
from .resnet import ResNet

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
_STAGE_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def graph_key(x: torch.Tensor) -> Optional[tuple]:
    """What selects the kernels of an inference call on `x`, or None where
    the call must run eagerly: off the card, under grad, or inside a stream
    capture already under way."""
    if not x.is_cuda or torch.is_grad_enabled() or torch.cuda.is_current_stream_capturing():
        return None
    cudnn = torch.backends.cudnn
    return (tuple(x.shape), x.stride(), x.dtype, x.device,
            torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda"),
            cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32, torch.is_inference_mode_enabled())


class _Graph:
    __slots__ = ("graph", "x", "out")

    def __init__(self, fn: Callable, x: torch.Tensor):
        if not torch.autograd.profiler._is_profiler_enabled:
            # without it CUPTI reports no kernel of a graph captured before
            # the profiler that traces its replays started
            from torch.profiler._utils import _init_for_cuda_graphs
            _init_for_cuda_graphs()
        self.x = x.clone()
        self.graph = torch.cuda.CUDAGraph()
        # The cache off, the graph records autocast's weight casts; with it
        # on it would read cast copies freed when the caller's region ends.
        with torch.cuda.graph(self.graph), torch.autocast(
                "cuda", dtype=torch.get_autocast_dtype("cuda"),
                enabled=torch.is_autocast_enabled("cuda"), cache_enabled=False):
            self.out = fn(self.x)


class TrunkGraphs:
    """CUDA graphs of one module's forward, one per `graph_key`.

    The first call of a key runs eagerly (the warm-up of cuDNN and of lazy
    initialisation; a key seen once costs no capture), the second captures
    and every call from then on copies its input into the graph's, replays
    and returns copies of the outputs, which the next replay overwrites.
    Counters `trunk.graph_captures` and `trunk.graph_replays`.  The graphs
    read the module's tensors at their addresses: `clear()` wherever they
    may move.  A copy of the table (the module's deepcopy or pickle) is
    empty, since its graphs would read the original's tensors."""

    def __init__(self):
        self._graphs: Dict[tuple, Optional[_Graph]] = {}

    def __reduce__(self):
        return TrunkGraphs, ()

    def clear(self) -> None:
        self._graphs.clear()

    def __call__(self, fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                 x: torch.Tensor, key: tuple) -> Dict[str, torch.Tensor]:
        if key not in self._graphs:
            self._graphs[key] = None
            return fn(x)
        g = self._graphs[key]
        if g is None:
            g = self._graphs[key] = _Graph(fn, x)
            tracing.count("trunk.graph_captures")
        g.x.copy_(x)
        if torch.autograd.profiler._is_profiler_enabled:
            # The profiler gives device work to the innermost op-scope range
            # open at its launch; a replay is no ATen op, and a user-scope
            # `record_function` around it takes no kernels.
            with torch._C._profiler._RecordFunctionFast("trunk::graph_replay"):
                g.graph.replay()
        else:
            g.graph.replay()
        tracing.count("trunk.graph_replays")
        return {k: v.clone() for k, v in g.out.items()}


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
        self.graphs = TrunkGraphs()

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        key = None if self.training else graph_key(x)
        if key is None:
            return self._forward(x)
        return self.graphs(self._forward, x, key)

    def _apply(self, fn, recurse=True):
        self.graphs.clear()
        return super()._apply(fn, recurse)

    def _load_from_state_dict(self, *args, **kwargs):
        self.graphs.clear()
        super()._load_from_state_dict(*args, **kwargs)

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
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
