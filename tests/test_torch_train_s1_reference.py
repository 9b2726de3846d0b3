"""The port's stage-1 `train_step` against the benchmark's plain reference
(`portbench/reference/train_s1.py`) on the CPU, on the same discrete
choices: the anchors, proposals and ROIs the port's step drew, read
through `tracing.keeping()`.

Tiny shapes (64x96, 2 images, 32 anchors and 32 ROIs an image, 64/32
proposals before/after NMS; a width divisible by 32, as 640 is, since
the reference pads to 32 as detectron2 does and the port's training path
takes the images as they come) at the published widths, float32 on both
sides, seeded random weights (He-style trunk and heads, the box predictor
as detectron2 initialises a fresh one, so that the box stage's gradient
reaches the features), the training pool through `_TrainPool` (the plain
versions of K1 and K2 on the CPU).  The step compared is the second, so
the momentum buffers are live.  Tolerances:

  * each loss within 1e-5 relative: both sides sum the same float32 terms
    through about 60 layers in different orders (batched against blocked
    convolutions, the separable pool against the reference's einsum),
    which moves a loss by about 1e-6 of itself;
  * each trained tensor's gradient within 1e-4 of its norm (the norm of
    the difference over the norm of the reference's): the backward sums
    its terms in other orders again, and ReLU units within float32 noise
    of zero at random weights flip one element's path now and then, so
    elementwise tolerances are not steady; the gradient the box pool
    sends is 0.3-0.4 of most FPN and trunk tensors' here;
  * the update equal: the reference's SGD on the port's own state before
    the step and its gradients is the same float32 arithmetic, operation
    for operation.

With the pool's gradient with respect to the features dropped (the
adjoint patched to return zeros) the comparison fails.
"""

import os

import pytest
import torch

from articulation3d_tpu_torch import tracing
from articulation3d_tpu_torch.config import load_config
from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
from articulation3d_tpu_torch.ops import roi_align_cuda
from articulation3d_tpu_torch.train.optimizer import build_optimizer
from articulation3d_tpu_torch.train.train_step import train_step
from portbench.reference import train_s1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 96, 2
OVERRIDES = {"model": {"dtype": "float32", "roi_pooler_impl": "cuda",
                       "rpn": {"batch_size_per_image": 32, "pre_nms_topk_train": 64,
                               "post_nms_topk_train": 32},
                       "roi_heads": {"batch_size_per_image": 32}},
             "input": {"height": H, "width": W}, "weights": ""}


def _seeded_weights(model, seed):
    """He-style draws for every tensor of the model's state dict, from one
    CPU generator: convolutions 0.8 sqrt(2 / fan_in), linear layers sqrt(2
    / fan_in), biases N(0, 0.05^2), frozen BatchNorms' scale U(0.6, 1.1),
    mean N(0, 0.1^2), variance U(0.5, 1.5); RPN deltas x0.02; the box
    predictor N(0, 0.01^2) / N(0, 0.001^2) with zero biases."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        n = lambda std: torch.randn(v.shape, generator=gen) * std
        u = lambda a, b: a + (b - a) * torch.rand(v.shape, generator=gen)
        if k.endswith("running_var"):
            t = u(0.5, 1.5)
        elif k.endswith("running_mean"):
            t = n(0.1)
        elif ".norm.weight" in k:
            t = u(0.6, 1.1)
        elif "box_predictor" in k:
            t = n(0.01 if "cls_score.weight" in k else 0.001) if k.endswith("weight") \
                else torch.zeros(v.shape)
        elif k.endswith("bias"):
            t = n(0.05)
        elif v.dim() == 4:
            t = n(0.8 * (2.0 / v[0].numel()) ** 0.5)
        else:
            t = n((2.0 / v.shape[1]) ** 0.5)
        if "anchor_deltas" in k:
            t = t * 0.02
        out[k] = t.to(v.dtype)
    return out


def _batch():
    gen = torch.Generator().manual_seed(5)
    return {"images": torch.randint(0, 256, (B, H, W, 3), generator=gen, dtype=torch.uint8),
            "gt_boxes": torch.tensor([[[8, 6, 40, 38], [30, 20, 74, 58], [0, 0, 1, 1]],
                                      [[12, 10, 50, 44], [40, 4, 70, 30], [20, 30, 60, 62]]],
                                     dtype=torch.float32),
            "gt_classes": torch.tensor([[0, 1, 0], [1, 1, 0]]),
            "gt_valid": torch.tensor([[True, True, False], [True, True, True]])}


@pytest.fixture(scope="module")
def cfg():
    return load_config(os.path.join(ROOT, "configs", "step1_bbox.yaml"), OVERRIDES)


def _port_step(cfg):
    """Two port steps from the seeded weights; the second's state before,
    choices, gradients, losses and state after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = PlaneRCNN(cfg)
        model.load_state_dict(_seeded_weights(model, 3))
        model.train()
        opt, sched = build_optimizer(cfg, model)
        gen = torch.Generator().manual_seed(11)
        batch = _batch()
        train_step(model, opt, sched, batch, gen)
        named = {k: p for k, p in model.named_parameters() if p.requires_grad}
        before = {k: p.detach().clone() for k, p in named.items()}
        bufs = {k: opt.state[p]["momentum_buffer"].clone() for k, p in named.items()}
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        grads = {}
        hook = opt.register_step_pre_hook(lambda *_: grads.update(
            {k: p.grad.detach().clone() for k, p in named.items()}))
        with tracing.keeping() as kept:
            metrics = train_step(model, opt, sched, batch, gen)
        hook.remove()
        after = {k: p.detach().clone() for k, p in named.items()}
        bufs_after = {k: opt.state[p]["momentum_buffer"].clone() for k, p in named.items()}
        choices = {"anchors": kept["train.anchors"], "rois": kept["train.rois"]["rois"]._asdict()}
        return dict(sd=sd, batch=batch, choices=choices, grads=grads, before=before, bufs=bufs,
                    after=after, bufs_after=bufs_after, it=1,
                    losses={k: float(v) for k, v in metrics.items()})
    finally:
        torch.set_num_threads(threads)


def _gaps(cfg, got):
    conf = {"model": {"rpn": {"batch_size_per_image": 32},
                      "roi_heads": {"num_classes": 2},
                      "box_head": {"pooler_resolution": 7, "pooler_sampling_ratio": 0}},
            "input": {"pixel_mean": list(cfg.input.pixel_mean),
                      "pixel_std": list(cfg.input.pixel_std), "size_divisibility": 32}}
    out = train_s1.step(got["sd"], got["batch"], got["choices"], conf, block=1)
    loss = {k: abs(got["losses"][k] - float(v)) / abs(float(v))
            for k, v in out["losses"].items()}
    grad = {k: float((got["grads"][k] - g).norm() / g.norm()) for k, g in out["grads"].items()}
    return loss, grad, out


def test_the_trained_set_is_the_published_one(cfg):
    model = PlaneRCNN(cfg)
    build_optimizer(cfg, model)
    trained = sorted(k for k, p in model.named_parameters() if p.requires_grad)
    assert trained == sorted(train_s1.trained_keys(model.state_dict()))


def test_port_step_matches_the_plain_reference(cfg):
    got = _port_step(cfg)
    loss, grad, _ = _gaps(cfg, got)
    assert set(loss) == set(train_s1.LOSSES)
    assert max(loss.values()) < 1e-5, loss
    assert set(grad) == set(got["grads"])
    assert max(grad.values()) < 1e-4, sorted(grad.items(), key=lambda kv: -kv[1])[:5]
    s = cfg.solver
    lr = train_s1.lr_at({"base_lr": s.base_lr, "warmup_iters": s.warmup_iters,
                         "warmup_factor": s.warmup_factor, "steps": list(s.steps),
                         "gamma": s.gamma}, got["it"])
    new_p, new_b = train_s1.sgd(got["before"], got["grads"], got["bufs"], lr, s.momentum,
                                s.weight_decay)
    for k in new_p:
        assert torch.equal(new_p[k], got["after"][k]), k
        assert torch.equal(new_b[k], got["bufs_after"][k]), k


def test_a_dropped_pool_gradient_fails_the_comparison(cfg, monkeypatch):
    def zeros(g, shapes, boxes, record, **kw):
        return [torch.zeros(tuple(s), dtype=torch.float32) for s in shapes]

    monkeypatch.setattr(roi_align_cuda, "multilevel_roi_align_adjoint_cuda", zeros)
    loss, grad, _ = _gaps(cfg, _port_step(cfg))
    assert max(loss.values()) < 1e-5, loss             # the forward is untouched
    fed = {k: v for k, v in grad.items() if train_s1.fed_by_pool(k)}
    assert max(fed.values()) > 1e-2, fed           # fails the 1e-4 tolerance
    assert max(v for k, v in grad.items() if k not in fed) < 1e-4   # the heads' are sound
