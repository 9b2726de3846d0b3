"""Training checkpoints with `torch.save`, in detectron2's layout.

Counterpart of `articulation3d_tpu/train/checkpoint.py` (which writes orbax
checkpoints).  A checkpoint is `{"model": d2-schema state dict, "optimizer",
"scheduler", "iteration"}` in `<dir>/model_{iteration - 1:07d}.pth`, the
name d2's `PeriodicCheckpointer` gives it, so `weights.load_torch_state_dict`
reads its "model" entry as a warm start for the next stage.  Loading a d2
`.pth` or `.pkl` for a warm start lives in `weights.py`.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"model_(\d{7})\.pth$")


def save_checkpoint(ckpt_dir: str, model, optimizer, scheduler,
                    iteration: int) -> str:
    """Write the state after `iteration` completed steps; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_{iteration - 1:07d}.pth")
    tmp = path + ".tmp"
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(),
                "iteration": int(iteration)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model, optimizer, scheduler) -> int:
    """Restore model, optimizer and scheduler in place; returns the number
    of completed steps."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    return int(ckpt["iteration"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the most steps in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir) if _NAME.match(n))
    return os.path.join(ckpt_dir, names[-1]) if names else None
