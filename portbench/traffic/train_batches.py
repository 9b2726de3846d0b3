"""Training batches for the stage-1 cells: a pool of batches drawn from the
seed on the device, in the `train_step` batch contract (uint8 BGR images,
GT boxes padded to the trainer's `max_instances` with a valid flag), which
the training loop cycles through.

Parameters (a traffic file `traffic/<mix>.json` with "generator":
"train_batches"): height, width, ims (images a step), pool_batches
(batches drawn), max_instances (GT rows a batch holds), min_boxes and
max_boxes (GT boxes an image, drawn uniformly), min_side and max_side (a
box's width and height, each drawn uniformly, in pixels), classes (GT
classes, drawn uniformly), calibration (images of the first batch that
set the trunk's frozen BatchNorm statistics; read by the driver).
"""

from __future__ import annotations

from typing import Dict, List

import torch


class Cycle:
    """An endless iterable over the pool's batches, in order, that
    remembers which batch it handed out last (`last`)."""

    def __init__(self, batches: List[Dict[str, torch.Tensor]]):
        self.batches = batches
        self.last = None

    def __iter__(self):
        i = 0
        while True:
            self.last = i % len(self.batches)
            yield self.batches[self.last]
            i += 1


def make_pool(params: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`pool_batches` batches of `ims` images on `device`; the same seed
    gives the same batches, and every seed the same shapes."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 17) % (1 << 63))
    n, g = params["pool_batches"] * params["ims"], params["max_instances"]
    h, w = params["height"], params["width"]
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    counts = torch.randint(params["min_boxes"], params["max_boxes"] + 1, (n, 1),
                           generator=gen, device=device)
    u = torch.rand(n, g, 4, generator=gen, device=device)
    lo, hi = params["min_side"], params["max_side"]
    bw, bh = lo + (hi - lo) * u[..., 0], lo + (hi - lo) * u[..., 1]
    x0, y0 = u[..., 2] * (w - bw), u[..., 3] * (h - bh)
    valid = torch.arange(g, device=device)[None] < counts
    boxes = torch.stack([x0, y0, x0 + bw, y0 + bh], -1) * valid[..., None]
    classes = torch.randint(0, params["classes"], (n, g), generator=gen, device=device) * valid
    b = params["ims"]
    return [{"images": images[i:i + b], "gt_boxes": boxes[i:i + b],
             "gt_classes": classes[i:i + b], "gt_valid": valid[i:i + b]}
            for i in range(0, n, b)]
