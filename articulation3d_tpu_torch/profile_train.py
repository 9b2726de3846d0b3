"""Stage profile of a training step on the card.

    python -m articulation3d_tpu_torch.profile_train [--stage 1|3] [--ims 16] [--steps 3] \\
        [--device cuda]

The counterpart of `tools/profile_train.py`: times nested prefixes of the
training step and the training pooler alone, so that the step's time can
be put down to its stages as `profile_inference` does for inference:

  * features fwd, features fwd+bwd
  * depth head fwd, depth head fwd+bwd        (stage 3: the decoder on
                                               fixed features, eval-mode BN)
  * loss fwd (full train forward)             `train_step.compute_losses`
  * loss fwd+bwd (value_and_grad)             and its backward
  * full step (grad+optimizer)                `train_step.train_step`
  * train pool fwd / fwd+bwd (kernel | gather)
      `ops/roi_align_cuda.py::multilevel_roi_align_train`, impl "cuda"
      (K1 forward, K2 backward) and "torch" (the gather under autograd), on
      512 random boxes per image (`RandomState(0)`, up to 0.3 of the
      image wide and tall) over the features' p2..p5

The config is the stage's preset (`step1_bbox_config()` or
`step3_plane_config()`) at `--ims` images, `base_lr` 0.002, 480x640; the
weights are `weights.random_state_dict(0)` as drawn (no detection bias);
the batch is `train_batch`, the synthetic batch of
`tools/train_on_chip.py`.  The feature and depth rows read the normalised
float32 images; the loss and step rows take the raw uint8 batch and
normalise it inside, as the step does.  Each run of the loss and step
rows draws from a generator seeded with 42 (JAX's fixed key); the full
step updates the model, so each run starts one SGD step further on (JAX
runs each from the same state; at the warm-up learning rate, about 2e-6,
the work is the same).

A backward row returns the gradients it computes, by parameter name
(`torch.autograd.grad`; the parameters' `.grad` is left alone), and the
timing loop reads back their sum, as JAX's rows reduce theirs.
"features fwd+bwd" differentiates JAX's parameters of the trunk: every one
but those of the stem and res2, which the ResNet's `freeze_at` stops in
both packages, on a copy of the trunk whose flags say so whatever the
stage freezes (stage 3 freezes the whole trunk).  JAX's frozen BatchNorms
keep their scale, shift and statistics as parameters, so `jax.grad` takes
their gradients too; the copy makes those four buffers of each frozen
BatchNorm parameters for the row.  The other backward rows take the
stage's trainable parameters: frozen modules take no gradient, as in the
step.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .profiling import Around, Row, Stage, device_label, markdown_table, reduce_sum, time_rows


def train_config(stage: int, ims: int, height: int, width: int):
    """The stage's preset at `ims` images per batch, base_lr 0.002 and a
    `height` x `width` input, with the depth output at the input size
    (`tools/train_on_chip.py::_config`)."""
    from .config import step1_bbox_config, step3_plane_config
    if stage not in (1, 3):
        raise ValueError(f"stage must be 1 or 3, got {stage}")
    cfg = step1_bbox_config() if stage == 1 else step3_plane_config()
    solver = dataclasses.replace(cfg.solver, ims_per_batch=ims, base_lr=0.002)
    model = cfg.model
    if (height, width) != (cfg.input.height, cfg.input.width):
        model = dataclasses.replace(
            model, depth_head=dataclasses.replace(
                model.depth_head, output_height=height, output_width=width))
    return cfg.replace(solver=solver, model=model,
                       input=dataclasses.replace(cfg.input, height=height, width=width))


def train_batch(cfg, b: int, g: int = 4) -> dict:
    """The synthetic batch of `tools/train_on_chip.py::_batch`, draw for
    draw: `g` box-shaped GT instances per image, planes (0, 0, 1), both
    axes (0.6, 0.8, 0.1, 1.0), depth |randn| + 1 metres and raw uint8
    images.  Its fields are ones the step reads (`train_step.py`'s batch
    contract): float `gt_masks` and `gt_depth`, as JAX's."""
    h, w = cfg.input.height, cfg.input.width
    rs = np.random.RandomState(0)
    bs = max(20, min(h, w) // 5)           # GT box scale follows the input
    boxes = []
    for _ in range(b * g):
        x1 = rs.uniform(0, w - 2 * bs)
        y1 = rs.uniform(0, h - 2 * bs)
        boxes.append([x1, y1, x1 + rs.uniform(bs, 2 * bs), y1 + rs.uniform(bs, 2 * bs)])
    boxes = np.asarray(boxes, np.float32).reshape(b, g, 4)
    masks = np.zeros((b, g, h, w), np.float32)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2 = boxes[i, j].astype(int)
            masks[i, j, y1:y2, x1:x2] = 1.0
    dh, dw = cfg.model.depth_head.output_height, cfg.model.depth_head.output_width
    axis = np.tile(np.asarray([0.6, 0.8, 0.1, 1.0], np.float32), (b, g, 1))
    return {
        "images": rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        "gt_boxes": boxes,
        "gt_classes": rs.randint(0, 2, (b, g)).astype(np.int32),
        "gt_valid": np.ones((b, g), bool),
        "gt_masks": masks,
        "gt_planes": np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (b, g, 1)),
        "gt_rot_axis": axis,
        "gt_tran_axis": axis.copy(),
        "gt_depth": np.abs(rs.randn(b, dh, dw)).astype(np.float32) + 1.0,
    }


def pool_boxes(ims: int, n: int, h: int, w: int) -> np.ndarray:
    """(ims, n, 4) float32: the training pool rows' random boxes
    (`tools/profile_train.py`), 8 to 0.3 x the image wide and tall."""
    rs = np.random.RandomState(0)
    x1 = rs.uniform(0, w * 0.7, (ims, n)).astype(np.float32)
    y1 = rs.uniform(0, h * 0.7, (ims, n)).astype(np.float32)
    x2 = x1 + rs.uniform(8, w * 0.3, (ims, n))
    y2 = y1 + rs.uniform(8, h * 0.3, (ims, n))
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


POOL_LABELS = {"cuda": "kernel", "torch": "gather"}   # JAX's "pallas" and "xla"


def pool_stages(roi_feats: Sequence[torch.Tensor], boxes: torch.Tensor, *, impl: str,
                output_size: int, sampling_ratio: int) -> List[Stage]:
    """The two training-pool rows of one route (`impl` "cuda" or
    "torch"): the pooled ROIs, and the gradient of their sum with respect
    to the p2..p5 maps."""
    from .models.planercnn import ROI_STRIDES
    from .ops.roi_align_cuda import multilevel_roi_align_train
    kw = dict(strides=ROI_STRIDES, output_size=output_size, sampling_ratio=sampling_ratio,
              aligned=True, impl=impl)

    @torch.no_grad()
    def fwd():
        return multilevel_roi_align_train(roi_feats, boxes, **kw)

    def fwd_bwd():
        fs = [f.detach().requires_grad_() for f in roi_feats]
        return torch.autograd.grad(multilevel_roi_align_train(fs, boxes, **kw).sum(), fs)

    label, n = POOL_LABELS[impl], boxes.shape[1]
    return [(f"train pool fwd ({label}, {n} rois/im)", fwd),
            (f"train pool fwd+bwd ({label})", fwd_bwd)]


def _trunk_copy(model):
    """`model` with a copy of its backbone whose parameters are JAX's and
    take gradients as JAX's do: the frozen BatchNorms' buffers become
    parameters, and all take gradients but those of the stages the
    ResNet's `freeze_at` stops; the other modules are shared."""
    from .models.resnet import FrozenBatchNorm2d
    shared = {id(m): m for name, m in model.named_children() if name != "backbone"}
    trunk = copy.deepcopy(model, shared)
    for m in trunk.backbone.modules():
        if isinstance(m, FrozenBatchNorm2d):
            for name in ("weight", "bias", "running_mean", "running_var"):
                setattr(m, name, torch.nn.Parameter(m._buffers.pop(name)))
    trunk.backbone.requires_grad_(True)
    trunk.backbone.bottom_up.freeze(model.config.model.resnet.freeze_at)
    return trunk


def named_grads(loss: torch.Tensor, module: torch.nn.Module,
                prefix: str) -> Dict[str, torch.Tensor]:
    """{prefix + name: d loss / d parameter} over `module`'s parameters
    that take gradients."""
    named = [(prefix + n, p) for n, p in module.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g for (n, _), g in zip(named, grads)}


def stages(model, optimizer, scheduler, batch: dict) -> List[Stage]:
    """The rows of `tools/profile_train.py` over `model` (a PlaneRCNN in
    train mode, its optimizer and scheduler from `build_optimizer`) and
    `batch` (tensors on the model's device): [(name, fn)]."""
    from .train.train_step import compute_losses, train_step

    cfg = model.config
    images = batch["images"]
    dev = images.device
    mean = torch.tensor(cfg.input.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.input.pixel_std, dtype=torch.float32, device=dev)
    imgs_f = (images.to(torch.float32) - mean) / std
    key = lambda: torch.Generator(device=dev).manual_seed(42)
    trainable = lambda m: [p for p in m.parameters() if p.requires_grad]

    @torch.no_grad()
    def features():
        return model.features(imgs_f)

    trunk = _trunk_copy(model)

    def features_grad():
        return named_grads(reduce_sum(trunk.features(imgs_f)), trunk.backbone, "backbone.")

    rows: List[Stage] = [("features fwd", features), ("features fwd+bwd", features_grad)]
    feats = features()
    if cfg.model.depth_on:
        def depth(h):
            with model._autocast(dev):
                return h(feats).to(torch.float32).sum()

        rows += [("depth head fwd", torch.no_grad()(lambda: depth(model.depth_head))),
                 ("depth head fwd+bwd", lambda: named_grads(
                     depth(model.depth_head), model.depth_head, "depth_head."))]

    def loss_grad():
        losses = compute_losses(model, batch, key())
        total = sum(v.to(torch.float32) for v in losses.values())
        return torch.autograd.grad(total, trainable(model), allow_unused=True)

    def full_step():
        metrics = train_step(model, optimizer, scheduler, batch, key())
        return metrics["total_loss"], [p.detach() for p in model.parameters()]

    rows += [("loss fwd (full train forward)",
              torch.no_grad()(lambda: compute_losses(model, batch, key()))),
             ("loss fwd+bwd (value_and_grad)", loss_grad),
             ("full step (grad+optimizer)", full_step)]

    roi_feats = model.roi_features(feats, training=True)
    bcfg = cfg.model.box_head
    boxes = torch.from_numpy(pool_boxes(images.shape[0], cfg.model.roi_heads.batch_size_per_image,
                                        cfg.input.height, cfg.input.width)).to(dev)
    for impl in POOL_LABELS:
        rows += pool_stages(roi_feats, boxes, impl=impl, output_size=bcfg.pooler_resolution,
                            sampling_ratio=bcfg.pooler_sampling_ratio)
    return rows


def train_model(cfg, device):
    """PlaneRCNN(cfg) in train mode on `device` with the seeded weights
    (the keys it has), and its optimizer and scheduler."""
    from .models.planercnn import PlaneRCNN
    from .train.optimizer import build_optimizer
    from .weights import random_state_dict, schema_options, warm_start
    model = PlaneRCNN(cfg)
    warm_start(model, random_state_dict(0, **schema_options(cfg.model)))
    model = model.to(device).train()
    optimizer, scheduler = build_optimizer(cfg, model)
    return model, optimizer, scheduler


def main(argv=None, cfg=None, around: Optional[Around] = None) -> List[Row]:
    """Runs the CLI; `cfg` replaces `train_config(stage, ims, 480, 640)`
    (the tests pass a small one) and `around` runs each row's timing
    (`profiling.time_rows`).  Returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", type=int, default=1, choices=(1, 3))
    ap.add_argument("--ims", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from .structures import resolve_device
    from .train.train_step import to_device

    device = resolve_device(args.device)
    cfg = cfg if cfg is not None else train_config(args.stage, args.ims, 480, 640)
    label = device_label(device)
    print(f"# {label}, stage {args.stage}, ims {args.ims}", flush=True)
    t0 = time.perf_counter()
    model, optimizer, scheduler = train_model(cfg, device)
    batch = to_device(train_batch(cfg, args.ims), device)
    print(f"# init {time.perf_counter() - t0:.1f}s", flush=True)
    rows = time_rows(stages(model, optimizer, scheduler, batch), args.steps, args.ims,
                     width=36, around=around)
    heading = (f"## Training stage table (stage {args.stage}, ims={args.ims}, {label}, "
               f"random weights)")
    print(markdown_table(heading, rows, args.ims, unit="images/s"), flush=True)
    return rows


if __name__ == "__main__":
    main()
