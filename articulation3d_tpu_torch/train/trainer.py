"""Training host loop: the reference `Trainer(DefaultTrainer)`.

Counterpart of `articulation3d_tpu/train/trainer.py`: a model built from the
config, the optimizer and LR schedule, warm start or resume, the loader
over `cfg.datasets_train` (a `PrefetchLoader` around the epoch-shuffled
`DetectionLoader` and the training mapper), the loop around `train_step`,
d2-style `metrics.json` lines, and at step boundaries a checkpoint every
`solver.checkpoint_period` steps, a visualisation every `test.vis_period`
and an evaluation every `test.eval_period` (its failure is logged, not
raised, as in JAX).  `test()` runs the evaluators of `cfg.datasets_test`.

An explicit `loader` (any iterable of batch dicts in the `train_step`
contract) replaces the dataset loader.  The JAX trainer's k-step dispatch
and async feeder are TPU-client machinery and are not ported.

Data parallelism (the JAX trainer's mesh, `trainer.py:54-70`): under a
process group of W > 1 ranks (`parallel.init_distributed`, one process per
card) the schedule goes through `auto_scale_workers(cfg, W)`, the model is
wrapped in DistributedDataParallel, each rank takes its contiguous 1/W of
every global batch of `solver.ims_per_batch` images, in the same
`RandomState(seed + epoch)` order, and steps with `sharded_train_step`,
as JAX's trainer steps with `make_sharded_train_step` (`train_step.py`
holds the step's semantics; `solver.grad_sync_dtype: bfloat16` registers
`parallel.dist.bf16_grad_sync_hook`).  The logged losses are the ranks'
mean, as JAX's are.  The main process alone writes checkpoints (the unwrapped
module's keys, so they resume at any world size), `metrics.json` and the
visualisations; every rank runs the evaluation on its share of the images
with distributed evaluators.  A world of one takes the one-process path.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from .. import tracing
from ..config import Config, auto_scale_workers
from ..data.catalog import get_dataset_dicts, get_metadata
from ..data.mapper import DetectionLoader, PlaneRCNNMapper, PrefetchLoader
from ..models.planercnn import PlaneRCNN
from ..parallel import dist as pdist
from ..parallel import is_main_process, make_mesh, process_count, process_index, shard_batch
from ..structures import resolve_device
from ..weights import load_torch_state_dict, random_state_dict, schema_options, warm_start
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .optimizer import build_optimizer
from .train_step import sharded_train_step, to_device, train_step

logger = logging.getLogger(__name__)


def build_evaluator(dataset_name: str, cfg: Config, output_dir: str,
                    distributed: bool = False):
    """The evaluator of a dataset's registered evaluator type (reference
    `Trainer.build_evaluator`, `tools/train_net.py:25-33`)."""
    etype = get_metadata(dataset_name).evaluator_type
    if etype == "arti":
        from ..evaluation import ArtiEvaluator
        return ArtiEvaluator(dataset_name, cfg, distributed=distributed,
                             output_dir=output_dir)
    if etype == "mp3d":
        from ..evaluation import ScannetEvaluator
        return ScannetEvaluator(dataset_name, cfg, distributed=distributed,
                                output_dir=output_dir)
    raise NotImplementedError(etype)


def build_train_loader(cfg: Config, max_instances: int = 20) -> PrefetchLoader:
    """This rank's share of batches of `solver.ims_per_batch` images from
    `cfg.datasets_train`, reshuffled each epoch from `cfg.seed`, mapped on
    one prefetch thread."""
    records: List[dict] = []
    for name in cfg.datasets_train:
        records.extend(get_dataset_dicts(name))
    mapper = PlaneRCNNMapper(cfg, is_train=True, max_instances=max_instances)
    return PrefetchLoader(DetectionLoader(records, mapper, cfg.solver.ims_per_batch,
                                          shuffle=True, seed=cfg.seed,
                                          rank=process_index(),
                                          world_size=process_count()))


class Trainer:
    """Trains `PlaneRCNN(cfg)` on the card (or on `device`, e.g. "cpu").

    Without `cfg.weights` the model starts from `random_state_dict(cfg.seed)`;
    `resume_or_load` warm-starts from a d2 `.pth`/`.pkl`, a checkpoint of
    this trainer or a directory of them, or resumes from the newest
    checkpoint in `cfg.output_dir`.  Sampling draws come from one
    `torch.Generator` on the device, seeded with `cfg.seed + 1` (on every
    rank).  Batches come from `loader`, or, when it is None, from
    `build_train_loader(cfg, max_instances)`, built at the first step; one
    iterator over it serves every `train` call.  Under a process group an
    explicit `loader` yields global batches, of which each rank keeps its
    rows.  `model` is the PlaneRCNN; `step_model` is what the step calls:
    the model, or its DistributedDataParallel wrapper; `step_fn` is the step
    (`train_step`, or `sharded_train_step` at W > 1).
    """

    def __init__(self, cfg: Config, loader: Optional[Iterable[Dict]] = None, device=None,
                 max_instances: int = 20):
        self.device = resolve_device(device)
        world = process_count()
        cfg = auto_scale_workers(cfg, world)
        self.cfg = cfg
        self.loader = loader
        self._shard = loader is not None and world > 1
        self.max_instances = max_instances
        self._batches = None
        model = PlaneRCNN(cfg)
        warm_start(model, random_state_dict(cfg.seed, **schema_options(cfg.model)))
        self.model = model.to(self.device).train()
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.step_model = self.model
        self.step_fn = train_step
        if world > 1:
            # after build_optimizer: DDP syncs only the parameters that
            # train; the step averages the BatchNorm statistics itself
            ids = ([self.device.index if self.device.index is not None
                    else torch.cuda.current_device()]
                   if self.device.type == "cuda" else None)
            self.step_model = DistributedDataParallel(self.model, device_ids=ids,
                                                      broadcast_buffers=False)
            if cfg.solver.grad_sync_dtype == "bfloat16":    # else DDP's float32 mean
                self.step_model.register_comm_hook(None, pdist.bf16_grad_sync_hook)
            self.step_fn = sharded_train_step
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.iter = 0
        self.test_walls: Dict[str, Dict[str, float]] = {}

    def resume_or_load(self, resume: bool = False) -> None:
        """Resume model, optimizer, schedule and step count from the newest
        checkpoint in `cfg.output_dir` (with `resume`), else warm-start the
        model's weights from `cfg.weights`: a file, or the newest checkpoint
        of a directory (the recipe's stage-3 start from stage 1)."""
        if resume:
            path = latest_checkpoint(self.cfg.output_dir)
            if path:
                self.iter = load_checkpoint(path, self.model, self.optimizer,
                                            self.scheduler)
                logger.info("resumed from %s at iteration %d", path, self.iter)
                return
        w = self.cfg.weights
        if w:
            if os.path.isdir(w):
                path = latest_checkpoint(w)
                if path is None:
                    raise FileNotFoundError(f"no checkpoint in {w}")
                w = path
            stats = warm_start(self.model, load_torch_state_dict(w))
            logger.info("warm-started from %s: %d loaded, %d fresh, %d dropped, "
                        "%d shape-mismatched", w, len(stats["loaded"]),
                        len(stats["missing"]), len(stats["unexpected"]),
                        len(stats["shape_mismatch"]))

    def _next_batch(self):
        if self.loader is None:
            self.loader = build_train_loader(self.cfg, self.max_instances)
        if self._batches is None:
            self._batches = iter(self.loader)
        try:
            batch = next(self._batches)
        except StopIteration:
            self._batches = iter(self.loader)
            batch = next(self._batches)
        return shard_batch(make_mesh(), batch) if self._shard else batch

    def train(self, max_iter: Optional[int] = None) -> List[Dict[str, float]]:
        """Run steps until `max_iter` (default `solver.max_iter`) are done.
        Returns this call's per-step records: the losses, `total_loss`,
        `data_s` (the wait for the batch) and `wall_s` (the step).  Each step
        is the span "train.step" (a call), with the losses' readback
        "train.readback" inside; "train.images" counts the images stepped."""
        cfg = self.cfg
        max_iter = cfg.solver.max_iter if max_iter is None else max_iter
        os.makedirs(cfg.output_dir, exist_ok=True)
        metrics_path = os.path.join(cfg.output_dir, "metrics.json")
        start = self.iter
        records: List[Dict[str, float]] = []
        t0 = time.perf_counter()
        while self.iter < max_iter:
            t_data = time.perf_counter()
            batch = self._next_batch()
            t_step = time.perf_counter()
            with tracing.span("train.step", call=True):
                tracing.count("train.images", int(batch["images"].shape[0]))
                metrics = self.step_fn(self.step_model, self.optimizer, self.scheduler,
                                       to_device(batch, self.device), self.generator)
                with tracing.span("train.readback"):
                    rec = {}
                    for k, v in metrics.items():
                        with tracing.sync("train_readback", v):   # the first waits for the step
                            rec[k] = float(v)
            rec["data_s"] = t_step - t_data
            rec["wall_s"] = time.perf_counter() - t_step
            records.append(rec)
            self.iter += 1
            if is_main_process() and (self.iter % 20 == 0 or self.iter == start + 1):
                s_per_it = (time.perf_counter() - t0) / (self.iter - start)
                losses = {k: v for k, v in rec.items()
                          if k not in ("total_loss", "data_s", "wall_s")}
                logger.info("iter %d: total=%.4f (%.3f s/it) %s", self.iter,
                            rec["total_loss"], s_per_it,
                            {k: round(v, 4) for k, v in losses.items()})
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({"iteration": self.iter,
                                        "s_per_it": round(s_per_it, 4),
                                        "total_loss": round(rec["total_loss"], 6),
                                        **{k: round(v, 6) for k, v in losses.items()}})
                            + "\n")
            self._hooks(metrics_path)
        return records

    def _hooks(self, metrics_path: str) -> None:
        """Checkpoint, visualisation and evaluation whose period the step
        count reaches (the first two on the main process only)."""
        cfg, it = self.cfg, self.iter
        main = is_main_process()
        due = lambda period: period > 0 and it % period == 0
        if main and due(cfg.solver.checkpoint_period):
            save_checkpoint(cfg.output_dir, self.model, self.optimizer, self.scheduler, it)
        if main and due(cfg.test.vis_period):
            try:
                from .vis_hook import save_train_vis
                logger.info("training vis written to %s", save_train_vis(self, it))
            except Exception:  # vis must not kill training
                logger.warning("training vis failed", exc_info=True)
        if due(cfg.test.eval_period):
            try:
                results = self.test()
                if not main:
                    return
                with open(metrics_path, "a") as f:
                    for name, res in results.items():
                        f.write(json.dumps({"iteration": it, "eval_dataset": name,
                                            **{k: float(v) for k, v in res.items()}})
                                + "\n")
            except Exception:  # eval must not kill training
                logger.warning("eval failed", exc_info=True)

    def test(self) -> Dict[str, Dict[str, float]]:
        """Inference over each of `cfg.datasets_test` and its evaluator
        (reference `Trainer.test`, `tools/train_net.py:47-69`).

        Every detection the model keeps (its own `score_thresh_test`)
        reaches the evaluator (conf 0), with its mask RLE-encoded, at a
        batch of `max(ims_per_batch, 1)`.  The model is handed back in train
        mode.  `test_walls[name]` holds the walls of the mapper, inference,
        RLE encoding and the evaluator, in seconds.  Under a process group
        each rank runs a contiguous share of the images and the evaluators
        gather them: the main process returns the results, the others
        empty dicts."""
        from ..utils.rle import rle_encode
        from ..video.pipeline import VideoPipeline

        cfg = self.cfg
        world, rank = process_count(), process_index()
        results = {}
        try:
            pipeline = VideoPipeline(cfg, self.model, batch_size=max(cfg.solver.ims_per_batch, 1),
                                     conf_threshold=0.0, device=self.device,
                                     distributed=False)
            for name in cfg.datasets_test:
                evaluator = build_evaluator(name, cfg, cfg.output_dir, distributed=world > 1)
                evaluator.reset()
                records = get_dataset_dicts(name)
                per = -(-len(records) // world)
                records = records[rank * per:(rank + 1) * per]
                mapper = PlaneRCNNMapper(cfg, is_train=False)
                t0 = time.perf_counter()
                samples = [mapper(rec) for rec in records]
                t1 = time.perf_counter()
                preds = pipeline.run([s["images"] for s in samples])
                t2 = time.perf_counter()
                segms = [[rle_encode(m.astype(np.uint8)) for m in p.masks] for p in preds]
                t3 = time.perf_counter()
                for rec, sample, p, segm, depth in zip(records, samples, preds, segms,
                                                       pipeline.depths):
                    instances = [{
                        "image_id": rec["image_id"],
                        "category_id": int(p.classes[i]),
                        "bbox": [float(p.boxes[i][0]), float(p.boxes[i][1]),
                                 float(p.boxes[i][2] - p.boxes[i][0]),
                                 float(p.boxes[i][3] - p.boxes[i][1])],
                        "score": float(p.scores[i]),
                        "segmentation": segm[i],
                    } for i in range(len(p))]
                    out = {"instances": instances, "pred_rot_axis": p.rot_axis,
                           "pred_tran_axis": p.tran_axis, "pred_plane": p.planes,
                           "depth": depth}
                    evaluator.process([{"image_id": rec["image_id"],
                                        "file_name": rec["file_name"],
                                        "depth": sample.get("gt_depth")}], [out])
                results[name] = evaluator.evaluate()
                t4 = time.perf_counter()
                self.test_walls[name] = {"mapper": t1 - t0, "inference": t2 - t1,
                                         "rle": t3 - t2, "evaluator": t4 - t3}
                logger.info("eval %s: %s", name, results[name])
        finally:
            self.model.train()
        return results
