"""Optimizer: SGD with momentum, WarmupMultiStepLR and module-path freezing.

Counterpart of `articulation3d_tpu/train/optimizer.py` (reference solver:
SGD momentum 0.9, base LR 1e-3, linear warmup from factor 1e-3 over 1000
iterations, x0.1 decays at the configured steps, weight decay 1e-4).

Freezing keeps the reference's `MODEL.FREEZE` contract: entries are d2
module paths ("backbone", "proposal_generator", "roi_heads.box_head",
"roi_heads.box_predictor", "roi_heads.mask_head", ..., "depth_head",
"roi_heads"), and a parameter is frozen when its d2 name lies under one of
them.  The port's parameter names are the d2 keys, so "backbone" covers the
FPN (`backbone.fpn_*`) as the JAX mapping does (JAX optimizer.py:54-55).
Frozen parameters get `requires_grad_(False)` and stay out of the
optimizer.  The ResNet's own `freeze_at` (stem and res2) is applied when
the model is built (`models/resnet.py`).

Weight decay applies to every trainable parameter except the BatchNorm
affine parameters (d2 `WEIGHT_DECAY_NORM: 0.0`).  The optional elementwise
gradient clip (`solver.clip_gradients`) runs before the decay, as
`optax.clip` before `add_decayed_weights` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..config import Config


def param_is_frozen(name: str, freeze: Sequence[str]) -> bool:
    """Does the d2 parameter name (e.g. "backbone.fpn_output2.weight") lie
    under a frozen module path?"""
    return any(name == f or name.startswith(f + ".") for f in freeze)


def freeze_mask(model: nn.Module, freeze: Sequence[str]) -> dict:
    """{name: trainable} over the model's parameters, with the frozen
    ones set to `requires_grad_(False)`."""
    mask = {}
    for name, prm in model.named_parameters():
        if param_is_frozen(name, freeze):
            prm.requires_grad_(False)
        mask[name] = prm.requires_grad
    return mask


def _norm_param_names(model: nn.Module) -> set:
    names = set()
    for mname, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._NormBase):
            names.update(f"{mname}.{p}" for p, _ in mod.named_parameters(recurse=False))
    return names


def lr_factor(cfg: Config, step: int) -> float:
    """WarmupMultiStepLR's factor on `solver.base_lr` at `step` (updates
    done so far): JAX `warmup_multistep_schedule` divided by base_lr."""
    s = cfg.solver
    warm = min(max(step / max(s.warmup_iters, 1), 0.0), 1.0)
    factor = s.warmup_factor * (1.0 - warm) + warm
    for milestone in s.steps:
        if step >= milestone:
            factor *= s.gamma
    return factor


def build_optimizer(cfg: Config, model: nn.Module
                    ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """Apply the config's freeze list, then build SGD (momentum, no
    nesterov, no dampening; decay and no-decay groups) and the LambdaLR that
    equals `warmup_multistep_schedule` at every step.  Step the scheduler
    once after each optimizer step."""
    s = cfg.solver
    freeze_mask(model, cfg.model.freeze)
    norms = _norm_param_names(model)
    decay, no_decay = [], []
    for name, prm in model.named_parameters():
        if prm.requires_grad:
            (no_decay if name in norms else decay).append(prm)
    groups = [{"params": decay, "weight_decay": s.weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    opt = torch.optim.SGD([g for g in groups if g["params"]], lr=s.base_lr,
                          momentum=s.momentum, dampening=0.0, nesterov=False)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: lr_factor(cfg, step))
    return opt, sched


def clip_gradients(cfg: Config, model: nn.Module) -> None:
    """The elementwise clip of `solver.clip_gradients`, in place, before
    the optimizer adds the weight decay."""
    if cfg.solver.clip_gradients:
        v = cfg.solver.clip_value
        for prm in model.parameters():
            if prm.grad is not None:
                prm.grad.clamp_(-v, v)
