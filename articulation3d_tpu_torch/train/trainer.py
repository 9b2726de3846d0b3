"""Training host loop: the reference `Trainer(DefaultTrainer)` for one card.

Counterpart of `articulation3d_tpu/train/trainer.py`: a model built from the
config, the optimizer and LR schedule, warm start or resume, the loop
around `train_step`, d2-style `metrics.json` lines and a checkpoint every
`solver.checkpoint_period` steps.

Not here yet: the dataset loader (`data/catalog.py`, `data/mapper.py`) and
the evaluation and visualisation hooks wait for the data and evaluation
slices of the port, so `loader` is any iterable of batch dicts in the
`train_step` batch contract (numpy arrays or tensors).  The JAX trainer's
mesh, k-step dispatch and async feeder are TPU-client machinery and are
not ported.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional

import torch

from ..config import Config
from ..models.planercnn import PlaneRCNN
from ..structures import resolve_device
from ..weights import load_torch_state_dict, random_state_dict, warm_start
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .optimizer import build_optimizer
from .train_step import to_device, train_step

logger = logging.getLogger(__name__)


class Trainer:
    """Trains `PlaneRCNN(cfg)` on the card (or on `device`, e.g. "cpu").

    Without `cfg.weights` the model starts from `random_state_dict(cfg.seed)`;
    `resume_or_load` warm-starts from a d2 `.pth`/`.pkl` or resumes from the
    newest checkpoint in `cfg.output_dir`.  Sampling draws come from one
    `torch.Generator` on the device, seeded with `cfg.seed + 1`.
    """

    def __init__(self, cfg: Config, loader: Iterable[Dict], device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loader = loader
        model = PlaneRCNN(cfg)
        warm_start(model, random_state_dict(cfg.seed))
        self.model = model.to(self.device).train()
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.iter = 0

    def resume_or_load(self, resume: bool = False) -> None:
        """Resume model, optimizer, schedule and step count from the newest
        checkpoint in `cfg.output_dir` (with `resume`), else warm-start the
        model's weights from `cfg.weights` when it names a file."""
        if resume:
            path = latest_checkpoint(self.cfg.output_dir)
            if path:
                self.iter = load_checkpoint(path, self.model, self.optimizer,
                                            self.scheduler)
                logger.info("resumed from %s at iteration %d", path, self.iter)
                return
        w = self.cfg.weights
        if w:
            stats = warm_start(self.model, load_torch_state_dict(w))
            logger.info("warm-started from %s: %d loaded, %d fresh, %d dropped, "
                        "%d shape-mismatched", w, len(stats["loaded"]),
                        len(stats["missing"]), len(stats["unexpected"]),
                        len(stats["shape_mismatch"]))

    def train(self, max_iter: Optional[int] = None) -> List[Dict[str, float]]:
        """Run steps until `max_iter` (default `solver.max_iter`) are done.
        Returns this call's per-step records (losses, total_loss, wall_s)."""
        cfg = self.cfg
        max_iter = cfg.solver.max_iter if max_iter is None else max_iter
        os.makedirs(cfg.output_dir, exist_ok=True)
        metrics_path = os.path.join(cfg.output_dir, "metrics.json")
        start = self.iter
        records: List[Dict[str, float]] = []
        it = iter(self.loader)
        t0 = time.perf_counter()
        while self.iter < max_iter:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.loader)
                batch = next(it)
            t_step = time.perf_counter()
            metrics = train_step(self.model, self.optimizer, self.scheduler,
                                 to_device(batch, self.device), self.generator)
            rec = {k: float(v) for k, v in metrics.items()}   # waits for the step
            rec["wall_s"] = time.perf_counter() - t_step
            records.append(rec)
            self.iter += 1
            if self.iter % 20 == 0 or self.iter == start + 1:
                s_per_it = (time.perf_counter() - t0) / (self.iter - start)
                losses = {k: v for k, v in rec.items() if k not in ("total_loss", "wall_s")}
                logger.info("iter %d: total=%.4f (%.3f s/it) %s", self.iter,
                            rec["total_loss"], s_per_it,
                            {k: round(v, 4) for k, v in losses.items()})
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({"iteration": self.iter,
                                        "s_per_it": round(s_per_it, 4),
                                        "total_loss": round(rec["total_loss"], 6),
                                        **{k: round(v, 6) for k, v in losses.items()}})
                            + "\n")
            period = cfg.solver.checkpoint_period
            if period > 0 and self.iter % period == 0:
                save_checkpoint(cfg.output_dir, self.model, self.optimizer,
                                self.scheduler, self.iter)
        return records
