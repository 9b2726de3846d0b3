"""Static configuration of the PyTorch/CUDA port.

The port keeps its own copy of the configuration dataclasses so that it
imports nothing of the JAX package.  Field names are the JAX package's
(`articulation3d_tpu/config.py`), so every `configs/*.yaml` loads unchanged.
Only `ModelConfig.roi_pooler_impl` takes the port's own values:

  "auto"  the hand-written CUDA kernel for CUDA tensors, the plain torch
          gather formulation for CPU tensors;
  "cuda"  always the kernel wrapper (`ops/roi_align_cuda.py`);
  "torch" always the plain gather formulation (`ops/roi_align.py`), the
          counterpart of the JAX package's "xla".
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple

POOLER_IMPLS = ("auto", "cuda", "torch")


def _tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuple(v) for v in x)
    return x


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    norm: str = "FrozenBN"
    stem_out_channels: int = 64
    res2_out_channels: int = 256
    stride_in_1x1: bool = True
    num_groups: int = 1
    width_per_group: int = 64
    freeze_at: int = 2
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    # recompute each Bottleneck's interior on the backward pass
    # (`models/resnet.py`); the space-to-depth stem is the JAX package's TPU
    # layout: the port's stem is the plain 7x7/s2 conv, the same function
    remat: bool = False
    space_to_depth_stem: bool = False


@dataclass(frozen=True)
class FPNConfig:
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    out_channels: int = 256
    fuse_type: str = "sum"


@dataclass(frozen=True)
class AnchorConfig:
    sizes: Tuple[Tuple[float, ...], ...] = ((32.0,), (64.0,), (128.0,), (256.0,), (512.0,))
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    offset: float = 0.0


@dataclass(frozen=True)
class RPNConfig:
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
    iou_thresholds: Tuple[float, float] = (0.3, 0.7)
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    nms_thresh: float = 0.7
    pre_nms_topk_train: int = 2000
    post_nms_topk_train: int = 1000
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 1000
    bbox_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    smooth_l1_beta: float = 0.0
    loss_weight: float = 1.0
    min_size: float = 0.0
    boundary_thresh: float = -1.0
    head_convs: int = 1


@dataclass(frozen=True)
class BoxHeadConfig:
    num_fc: int = 2
    fc_dim: int = 1024
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 0
    pooler_type: str = "ROIAlignV2"
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    smooth_l1_beta: float = 0.0
    cls_agnostic_bbox_reg: bool = False


@dataclass(frozen=True)
class ROIHeadsConfig:
    in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5")
    num_classes: int = 2
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    iou_threshold: float = 0.5
    proposal_append_gt: bool = True
    score_thresh_test: float = 0.7
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100


@dataclass(frozen=True)
class MaskHeadConfig:
    num_conv: int = 4
    conv_dim: int = 256
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 2
    pooler_type: str = "ROIAlign"
    cls_agnostic: bool = True
    mask_threshold: float = 0.5
    nms: bool = False


@dataclass(frozen=True)
class PlaneHeadConfig:
    num_conv: int = 4
    conv_dim: int = 256
    num_fc: int = 1
    fc_dim: int = 1024
    param_dim: int = 3
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 0
    pooler_type: str = "ROIAlign"
    normal_only: bool = True
    loss_weight: float = 1.0


@dataclass(frozen=True)
class AxisHeadConfig:
    num_conv: int = 4
    conv_dim: int = 256
    num_fc: int = 1
    fc_dim: int = 1024
    pooler_resolution: int = 14
    pooler_sampling_ratio: int = 0
    pooler_type: str = "ROIAlign"
    loss_weight: float = 1.0
    smooth_l1_beta: float = 0.0


@dataclass(frozen=True)
class RefineHeadConfig:
    height: int = 192
    width: int = 256
    max_depth: float = 10.0
    focal_length: float = 571.623718
    loss_weight: float = 1.0


@dataclass(frozen=True)
class DepthHeadConfig:
    loss_weight: float = 1.0
    output_height: int = 480
    output_width: int = 640


@dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    gamma: float = 0.1
    steps: Tuple[int, ...] = (210000, 250000)
    warmup_factor: float = 1e-3
    warmup_iters: int = 1000
    max_iter: int = 1_000_000
    ims_per_batch: int = 16
    checkpoint_period: int = 1000
    clip_gradients: bool = False
    clip_value: float = 1.0
    reference_world_size: int = 0
    # "bfloat16": the W > 1 step syncs gradients through
    # `parallel.dist.bf16_grad_sync_hook`; anything else syncs in float32
    grad_sync_dtype: str = "float32"
    # the JAX trainer's k steps per TPU dispatch; the port steps one at a time
    steps_per_dispatch: int = 1


@dataclass(frozen=True)
class InputConfig:
    height: int = 480
    width: int = 640
    format: str = "BGR"
    pixel_mean: Tuple[float, float, float] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    size_divisibility: int = 32


@dataclass(frozen=True)
class TestConfig:
    eval_gt_box: bool = False
    eval_period: int = 1000
    box_score_threshold: float = 0.1
    vis_period: int = 0


@dataclass(frozen=True)
class ModelConfig:
    meta_architecture: str = "PlaneRCNN"
    mask_on: bool = True
    plane_on: bool = True
    depth_on: bool = True
    axis_on: bool = True
    refine_on: bool = False
    freeze: Tuple[str, ...] = ()
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi_heads: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    box_head: BoxHeadConfig = field(default_factory=BoxHeadConfig)
    mask_head: MaskHeadConfig = field(default_factory=MaskHeadConfig)
    plane_head: PlaneHeadConfig = field(default_factory=PlaneHeadConfig)
    axis_head: AxisHeadConfig = field(default_factory=AxisHeadConfig)
    depth_head: DepthHeadConfig = field(default_factory=DepthHeadConfig)
    refine_head: RefineHeadConfig = field(default_factory=RefineHeadConfig)
    # compute dtype of the conv trunk and heads; weights stay float32
    dtype: str = "bfloat16"
    # "auto" | "cuda" | "torch" (module docstring)
    roi_pooler_impl: str = "auto"
    # serving-only: pool the detection cascade once at the plane/axis
    # convention and feed the mask head from the same tensor
    share_detection_pool: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    test: TestConfig = field(default_factory=TestConfig)
    datasets_train: Tuple[str, ...] = ("arti_train",)
    datasets_test: Tuple[str, ...] = ("arti_val",)
    output_dir: str = "exps/inference"
    # model weights: a d2 .pth/.pkl state dict, or "" for seeded random
    weights: str = ""
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _update_dataclass(obj, overrides: Mapping[str, Any]):
    """Recursively apply a nested dict of overrides to a frozen dataclass."""
    kw = {}
    for key, val in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key {key!r} on {type(obj).__name__}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, Mapping):
            kw[key] = _update_dataclass(cur, val)
        else:
            kw[key] = _tuple(val)
    return dataclasses.replace(obj, **kw)


def auto_scale_workers(cfg: Config, num_workers: int) -> Config:
    """Linear-scaling-rule rewrite of the solver schedule for a new worker
    count (detectron2 ``DefaultTrainer.auto_scale_workers``; the JAX
    package's `config.auto_scale_workers`; the reference only ships the
    knob, `config/config.yaml:332`).  One worker is one process.

    If ``solver.reference_world_size`` is 0 or already equals
    ``num_workers``, the config is returned unchanged.  Otherwise the total
    batch grows with the worker count and the LR scales linearly, while
    the iteration-denominated quantities (max_iter, warmup, decay steps,
    eval and checkpoint periods) shrink so the same number of epochs is
    covered.
    """
    old = cfg.solver.reference_world_size
    if old == 0 or old == num_workers:
        return cfg
    scale = num_workers / old
    s = cfg.solver
    solver = dataclasses.replace(
        s,
        ims_per_batch=int(round(s.ims_per_batch * scale)),
        base_lr=s.base_lr * scale,
        max_iter=int(round(s.max_iter / scale)),
        warmup_iters=int(round(s.warmup_iters / scale)),
        steps=tuple(int(round(x / scale)) for x in s.steps),
        checkpoint_period=int(round(s.checkpoint_period / scale)),
        reference_world_size=num_workers,
    )
    test = dataclasses.replace(cfg.test,
                               eval_period=int(round(cfg.test.eval_period / scale)))
    return dataclasses.replace(cfg, solver=solver, test=test)


def load_config(yaml_path: str | None = None,
                overrides: Mapping[str, Any] | None = None) -> Config:
    """Build a Config, optionally merging a YAML file and a nested override
    dict (same layout as the JAX package's `load_config`)."""
    cfg = Config()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _update_dataclass(cfg, data)
    if overrides:
        cfg = _update_dataclass(cfg, overrides)
    if cfg.model.roi_pooler_impl not in POOLER_IMPLS:
        raise ValueError(f"roi_pooler_impl must be one of {POOLER_IMPLS}, "
                         f"got {cfg.model.roi_pooler_impl!r}")
    return cfg


def inference_config() -> Config:
    """Everything on except refine (reference `config/config.yaml:55-112`)."""
    return Config(
        model=ModelConfig(
            mask_on=True, plane_on=True, depth_on=True, axis_on=True, refine_on=False,
            freeze=(
                "backbone", "proposal_generator",
                "roi_heads.box_head", "roi_heads.box_predictor",
                "roi_heads.axis_head",
            ),
        ),
    )


def serving_config() -> Config:
    """The deployment preset: `inference_config()` with 500 post-NMS
    proposals (not 1000) and 30 detections per image (not 100).

    Equivalence contract (JAX `config.py::serving_config`;
    tests/test_torch_presets.py, and "[serving-preset]" of chip_smoke.py on
    the card):
      * per-box outputs equal the parity caps' for every box both keep;
      * where at most 500 proposals survive RPN NMS the two box stages see
        the same proposals, and the serving detections are exactly parity's
        top 30;
      * where more survive, the extra parity candidates can change
        class-NMS outcomes; the divergence is bounded, not zero.
    """
    cfg = inference_config()
    return cfg.replace(model=dataclasses.replace(
        cfg.model,
        rpn=dataclasses.replace(cfg.model.rpn, post_nms_topk_test=500),
        roi_heads=dataclasses.replace(cfg.model.roi_heads,
                                      detections_per_image=30)))


def step1_bbox_config() -> Config:
    """Stage 1: the detector alone (reference `config/step1_bbox.yaml`)."""
    return Config(
        model=ModelConfig(mask_on=False, plane_on=False, depth_on=False,
                          axis_on=False, refine_on=False),
        solver=SolverConfig(ims_per_batch=16),
        datasets_train=("arti_train",), datasets_test=("arti_val",),
    )


def step2_axis_config() -> Config:
    """Stage 2: the axis head on a frozen detector (reference
    `config/step2_axis.yaml`)."""
    return Config(
        model=ModelConfig(
            mask_on=False, plane_on=False, depth_on=False, axis_on=True,
            refine_on=False,
            freeze=("backbone", "proposal_generator",
                    "roi_heads.box_head", "roi_heads.box_predictor"),
        ),
        solver=SolverConfig(ims_per_batch=16),
        datasets_train=("arti_train",), datasets_test=("arti_val",),
    )


def step3_plane_config() -> Config:
    """Stage 3: mask, plane and depth on a frozen detector and axis head
    (reference `config/step3_plane.yaml`)."""
    return Config(
        model=ModelConfig(
            mask_on=True, plane_on=True, depth_on=True, axis_on=True,
            refine_on=False,
            freeze=("backbone", "proposal_generator",
                    "roi_heads.box_head", "roi_heads.box_predictor",
                    "roi_heads.axis_head"),
        ),
        solver=SolverConfig(ims_per_batch=8),
        datasets_train=("scannet_train",), datasets_test=("scannet_val",),
    )
