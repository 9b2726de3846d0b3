"""Frames for video inference: a pool of uint8 BGR frames drawn from the seed
on the device, handed to the program as host arrays, and cut into the
successive batches of one closed-loop client.

Parameters (a traffic file `traffic/<mix>.json` with "generator": "frames"):
height, width, batch (frames per call), pool (frames drawn; calls cycle
through them), calibration (frames of the pool that set the depth
decoder's BatchNorm statistics).
"""

from __future__ import annotations

import numpy as np
import torch


def make_pool(params: dict, seed: int, device) -> torch.Tensor:
    """(pool, H, W, 3) uint8 frames of uniform noise on `device`; the same
    seed gives the same frames, and every seed the same shapes."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 7) % (1 << 63))
    return torch.randint(0, 256, (params["pool"], params["height"], params["width"], 3),
                         generator=gen, device=device, dtype=torch.uint8)


def batches(pool: np.ndarray, batch: int):
    """Endless successive batches of `batch` frames: (call index, first
    frame's pool index, list of (H, W, 3) arrays)."""
    n = pool.shape[0]
    i = 0
    while True:
        start = (i * batch) % n
        idx = [(start + j) % n for j in range(batch)]
        yield i, idx, [pool[j] for j in idx]
        i += 1
