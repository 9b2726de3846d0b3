"""The port's stage-3 `train_step` against the benchmark's plain reference
(`portbench/reference/train_s3.py`) on the CPU, on the port's own ROI
sample, read through `tracing.keeping()`.

Tiny shapes (64x96, 2 images, 32 ROIs an image, 64/32 proposals before
and after NMS, the depth decoder's output at 64x96; a width divisible by
32, as 640 is) at the published widths, float32 on both sides, seeded
random weights, GT from the stage-3 cell's generator (painted rectangles,
packed masks, planes, depth with holes), the training pools through
`_TrainPool` (the plain K1 on the CPU).  The step compared is the second,
so the momentum buffers are live.  Tolerances:

  * each loss within 1e-5 relative: both sides sum the same float32 terms
    in other orders (batched against per-image heads, the separable pool
    and crops against the reference's einsum and products);
  * each trained tensor's gradient within 1e-2 of its norm (the norm of
    the difference over the norm of the reference's), and the median over
    each head's tensors within 1e-4: the backward sums its terms in other
    orders, and the two trunks' features differ in their last bits (3e-6
    of their size), so that now and then a ReLU unit of a head's tower
    within that noise of zero flips; one flip among the tower's 3e5 units
    moves the weights' gradients next to it by about 1/sqrt(3e5), 2e-3,
    and leaves the other tensors' alone.  The depth decoder's median within
    1e-2: at this size its coarse lanes' BatchNorms normalise 4 (p6) and
    12 (p5) values a channel, whose mean is large against their spread, so
    the same last-bit differences move every one of its gradients by
    1e-5 to 2e-3 of their size (`models/depth_head.py`).  The biases that
    feed a train-mode BatchNorm have no gradient in exact arithmetic and
    are held below 1e-5 of the depth head's;
  * the depth decoder's stored statistics within 1e-4 of the step's move
    of them: the batch statistics are means over the same float32 values;
  * the update equal: the reference's SGD on the port's own state before
    the step and its gradients is the same float32 arithmetic.

The GT crops the port kept ("train.mask_targets") equal the reference's
wherever its value is not within 1e-4 of the 0.5 threshold.  With the
crops shifted by half a pixel the comparison fails.
"""

import contextlib
import os

import pytest
import torch

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.config import load_config
from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
from articulation3d_tpu_torch.train import targets
from articulation3d_tpu_torch.train.optimizer import build_optimizer
from articulation3d_tpu_torch.train.train_step import train_step
from portbench.drivers.train_step import calibrate_trunk
from portbench.reference import judge_train_s3, train_s1, train_s3
from portbench.traffic import train_planes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 96, 2
OVERRIDES = {"model": {"dtype": "float32", "roi_pooler_impl": "cuda",
                       "rpn": {"pre_nms_topk_train": 64, "post_nms_topk_train": 32},
                       "roi_heads": {"batch_size_per_image": 32},
                       "depth_head": {"output_height": H, "output_width": W}},
             "input": {"height": H, "width": W}, "weights": ""}
TRAFFIC = {"height": H, "width": W, "ims": B, "pool_batches": 1, "max_instances": 6,
           "min_planes": 3, "max_planes": 5, "min_side": 16, "max_side": 60, "min_visible": 8,
           "min_offset": 0.5, "max_offset": 5.0, "depth_grid": [3, 4], "min_depth_mm": 500,
           "max_depth_mm": 8000, "hole_share": 0.1}


def _seeded_weights(model, seed):
    """He-style draws for every tensor of the model's state dict, from one
    CPU generator: convolutions 0.8 sqrt(2 / fan_in), linear layers sqrt(2
    / fan_in), biases N(0, 0.05^2), BatchNorms' scale U(0.6, 1.1), mean
    N(0, 0.1^2), variance U(0.5, 1.5); RPN deltas x0.02."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        n = lambda std: torch.randn(v.shape, generator=gen) * std
        u = lambda a, b: a + (b - a) * torch.rand(v.shape, generator=gen)
        if k.endswith("num_batches_tracked"):
            t = torch.zeros(v.shape)
        elif k.endswith("running_var"):
            t = u(0.5, 1.5)
        elif k.endswith("running_mean"):
            t = n(0.1)
        elif k.endswith("bias"):
            t = n(0.05)
        elif v.dim() == 1:
            t = u(0.6, 1.1)
        elif v.dim() == 4:
            t = n(0.8 * (2.0 / v[0].numel()) ** 0.5)
        else:
            t = n((2.0 / v.shape[1]) ** 0.5)
        if "anchor_deltas" in k:
            t = t * 0.02
        out[k] = t.to(v.dtype)
    return out


@pytest.fixture(scope="module")
def cfg():
    return load_config(os.path.join(ROOT, "configs", "step3_plane.yaml"), OVERRIDES)


@pytest.fixture(scope="module")
def seeded(cfg):
    """The model, its seeded weights with the trunk's frozen BatchNorms
    calibrated on the batch (as the stage-3 cell's driver does: the
    activations stay of order one), and the batch."""
    model = PlaneRCNN(cfg)
    batch = train_planes.make_pool(TRAFFIC, 5, "cpu")[0]
    weights = _seeded_weights(model, 3)
    calibrate_trunk(weights, batch["images"], {"config": {"input": {
        "pixel_mean": list(cfg.input.pixel_mean), "pixel_std": list(cfg.input.pixel_std),
        "size_divisibility": 32}}})
    return model, weights, batch


@contextlib.contextmanager
def _threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _port_step(cfg, seeded, warm=1):
    """`warm` port steps from the seeded weights, then one more: its state
    before, ROI sample, gradients, losses, stored statistics and state
    after."""
    model, weights, batch = seeded
    with _threads(2):
        model.load_state_dict(weights)
        model.train()
        opt, sched = build_optimizer(cfg, model)
        gen = torch.Generator().manual_seed(11)
        for _ in range(warm):
            train_step(model, opt, sched, batch, gen)
        named = {k: p for k, p in model.named_parameters() if p.requires_grad}
        bufs = {k: opt.state[p]["momentum_buffer"].clone() for k, p in named.items()
                if opt.state[p]}
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        grads = {}
        hook = opt.register_step_pre_hook(lambda *_: grads.update(
            {k: p.grad.detach().clone() for k, p in named.items()}))
        with tracing.keeping() as kept:
            metrics = train_step(model, opt, sched, batch, gen)
        hook.remove()
    state = model.state_dict()
    return dict(sd=sd, batch=batch, choices={"rois": kept["train.rois"]["rois"]._asdict()},
                targets=kept["train.mask_targets"]["targets"],
                grads=grads, bufs=bufs, after={k: p.detach().clone() for k, p in named.items()},
                bufs_after={k: opt.state[p]["momentum_buffer"].clone() for k, p in named.items()},
                stats={k: state[k].clone() for k in state if "running" in k},
                losses={k: float(v) for k, v in metrics.items()})


def _conf(cfg):
    m = cfg.model
    return {"model": {"mask_head": {"pooler_resolution": 14, "pooler_sampling_ratio": 2},
                      "plane_head": {"pooler_resolution": 14, "pooler_sampling_ratio": 0,
                                     "loss_weight": m.plane_head.loss_weight},
                      "depth_head": {"output_height": H, "output_width": W,
                                     "loss_weight": m.depth_head.loss_weight}},
            "input": {"pixel_mean": list(cfg.input.pixel_mean),
                      "pixel_std": list(cfg.input.pixel_std), "size_divisibility": 32}}


def _gaps(cfg, got):
    with _threads(2):
        out = train_s3.step(got["sd"], got["batch"], got["choices"], _conf(cfg), block=B)
    loss = {k: abs(got["losses"][k] - float(v)) / abs(float(v))
            for k, v in out["losses"].items()}
    grad = {k: float((got["grads"][k] - g).norm() / g.norm()) for k, g in out["grads"].items()
            if not train_s3.feeds_batch_norm(k)}
    stats = {k: float((got["stats"][k] - v).norm() / (v - got["sd"][k]).norm())
             for k, v in out["stats"].items()}
    return loss, grad, stats


def _medians(grad):
    """The median gradient gap over each head's tensors."""
    out = {}
    for h in train_s3.HEADS:
        v = sorted(x for k, x in grad.items() if train_s3.head_of(k) == h)
        out[h] = v[len(v) // 2]
    return out


def test_the_trained_set_is_the_published_one(cfg, seeded):
    model = seeded[0]
    build_optimizer(cfg, model)
    trained = sorted(k for k, p in model.named_parameters() if p.requires_grad)
    assert trained == sorted(train_s3.trained_keys(model.state_dict()))
    assert {train_s3.head_of(k) for k in trained} == {"mask", "plane", "depth"}


def test_port_step_matches_the_plain_reference(cfg, seeded):
    got = _port_step(cfg, seeded)
    fg = got["choices"]["rois"]["is_fg"]
    assert int(fg.sum()) >= 4, "the sample has too few foreground ROIs to compare"
    loss, grad, stats = _gaps(cfg, got)
    assert set(loss) == set(train_s3.LOSSES) == set(got["losses"]) - {"total_loss"}
    assert max(loss.values()) < 1e-5, loss
    # the GT crops equal the reference's wherever its value is not a tie at 0.5
    assert judge_train_s3.target_violations(got["batch"]["gt_masks_packed"],
                                            got["choices"]["rois"], got["targets"]) == 0
    noise = {k for k in got["grads"] if train_s3.feeds_batch_norm(k)}
    assert set(grad) | noise == set(got["grads"]) and len(noise) == 10
    # the BatchNorm removes any shift: these biases' gradients are rounding noise
    head = torch.cat([got["grads"][k].flatten() for k in got["grads"]
                      if train_s3.head_of(k) == "depth"]).norm()
    assert max(float(got["grads"][k].norm()) for k in noise) < 1e-5 * float(head)
    assert max(grad.values()) < 1e-2, sorted(grad.items(), key=lambda kv: -kv[1])[:5]
    med = _medians(grad)
    assert max(med["mask"], med["plane"]) < 1e-4 and med["depth"] < 1e-2, med
    assert len(stats) == 20 and max(stats.values()) < 1e-4, stats
    s = cfg.solver
    lr = train_s1.lr_at({"base_lr": s.base_lr, "warmup_iters": s.warmup_iters,
                         "warmup_factor": s.warmup_factor, "steps": list(s.steps),
                         "gamma": s.gamma}, 1)
    before = {k: got["sd"][k] for k in got["grads"]}
    new_p, new_b = train_s3.sgd(before, got["grads"], got["bufs"], lr, s.momentum,
                                s.weight_decay)
    for k in new_p:
        assert torch.equal(new_p[k], got["after"][k]), k
        assert torch.equal(new_b[k], got["bufs_after"][k]), k


def test_shifted_mask_targets_fail_the_comparison(cfg, seeded, monkeypatch):
    real = targets.crop_gt_masks

    def shifted(gt_masks, matched_idx, boxes, mask_size, chunk=64):
        return real(gt_masks, matched_idx, boxes + 0.5, mask_size, chunk)

    monkeypatch.setattr(targets, "crop_gt_masks", shifted)
    got = _port_step(cfg, seeded, warm=0)                  # the first step
    loss, grad, stats = _gaps(cfg, got)
    assert loss["loss_mask"] > 1e-4, loss                 # fails the 1e-5 tolerance
    assert judge_train_s3.target_violations(got["batch"]["gt_masks_packed"],
                                            got["choices"]["rois"], got["targets"]) > 0
    med = _medians(grad)
    assert med["mask"] > 1e-2, med                      # fails both gradient tolerances
    # the plane and depth heads are untouched
    assert med["plane"] < 1e-4 and med["depth"] < 1e-2, med
    assert max(v for k, v in grad.items() if train_s3.head_of(k) != "mask") < 1e-2
    assert max(loss[k] for k in ("loss_plane", "depth_loss")) < 1e-5, loss
