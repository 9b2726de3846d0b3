"""The port's training paths at full width on the card: what each step must
compute, not how fast (`portbench/` times the stage-1 step).

Imports neither JAX nor the JAX package; run on the card from the
repository root:

    python -m pytest tests/test_torch_card_train.py --noconftest -m cuda -q

Elsewhere every test skips.  The stage-1 cell is configs/step1_bbox.yaml
(R50-FPN, RPN 2000/1000, 512 ROIs per image, ims 16, 480x640, bf16 trunk)
with warmup_iters 0 and base_lr 0.002 on one synthetic batch, from
`random_state_dict(0)` with the RPN deltas x0.01 and the frozen stem conv
x1/256 (`_train_weights`); TF32 is off throughout.  Cases:

  * stage 1 through `Trainer` (K1 and K2 once a step, a falling loss), and
    K1's record and K2 on the step's own box pool;
  * one float32 step with the kernel pooler against one with the gather
    pooler under autograd, with damped RPN deltas and with slivers;
  * stage 3 with the refine head;
  * the stage-1 step wrapped in DistributedDataParallel over an NCCL group
    of one; two processes over gloo on the one card against one process
    (the sharded step, the global-batch step, the bfloat16 sync, both
    evaluators, the pipeline); `resnet.remat` against the plain trunk;
  * the recipe from a synthetic dataset on disk: stage 1 through
    `train_net` from the loader, `--eval-only --resume`, stage 3 from its
    checkpoint and the ScanNet evaluator, the evaluators' known answers,
    `opt_arti` in two shards and merged.
"""

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_checks import (PLANE_KEY, RECIPE_SPLITS, ROOT, STRIDES, check_bf16_buckets,
                          check_eval_values, check_record, dicts_agree, known_answer_predictions,
                          main_path_err, pallas_moved, param_samples, params_agree, parity_config,
                          record_pools, recording_bf16_hook, recipe_argv, serving_weights,
                          write_recipe_dataset)

pytestmark = pytest.mark.cuda
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _tf32_off()


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _train_weights(rpn_delta_scale: float = 0.01):
    """`random_state_dict(0)` with the RPN anchor-delta weights scaled by
    `rpn_delta_scale` (0.01 by default), and the frozen stem conv scaled by
    1/256: d2's caffe trunk takes raw 0..255 pixels (pixel_std 1), so
    random trunk weights give O(300) features and O(300) gradients, and SGD
    at lr 0.002 diverges within a few steps; the stem and res2 are frozen
    (freeze_at 2), so the scale is a fixed normalisation of the input and
    the features come out O(1).  With the features at that scale, undamped
    deltas (scale 1) still leave the proposals near their anchors; a scale
    of 256 gives the RPN the deltas that O(300) features give it:
    slivers."""
    from articulation3d_tpu_torch.weights import random_state_dict
    sd = random_state_dict(0)
    for k in ("weight", "bias"):
        sd[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= rpn_delta_scale
    sd["backbone.bottom_up.stem.conv1.weight"] *= 1.0 / 256.0
    return sd


def _stage1_config(out, ims: int = 16, grad_sync_dtype: str = "float32", **model_kw):
    from articulation3d_tpu_torch.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", "step1_bbox.yaml"))
    return cfg.replace(weights="", output_dir=str(out),
                       model=dataclasses.replace(cfg.model, **model_kw),
                       solver=dataclasses.replace(cfg.solver, warmup_iters=0, base_lr=0.002,
                                                  ims_per_batch=ims, checkpoint_period=0,
                                                  grad_sync_dtype=grad_sync_dtype))


def _train_batch(cfg, b: int, g: int = 4):
    """`profile_train.train_batch` (np.random.RandomState(0)) with only the
    fields the detector reads."""
    from articulation3d_tpu_torch.profile_train import train_batch
    batch = train_batch(cfg, b, g)
    return {k: batch[k] for k in ("images", "gt_boxes", "gt_classes", "gt_valid")}


def _stage1_trainer(out, ims: int = 16, grad_sync_dtype: str = "float32", **model_kw):
    """The stage-1 `Trainer` at a global batch of `ims` on its one synthetic
    batch, from `_train_weights()`."""
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import load_d2_state_dict
    cfg = _stage1_config(out, ims, grad_sync_dtype, **model_kw)
    batch = _train_batch(cfg, ims)
    trainer = Trainer(cfg, [batch])
    load_d2_state_dict(trainer.model, {k: v for k, v in _train_weights().items()
                                       if k in trainer.model.state_dict()})
    return trainer, batch


@contextlib.contextmanager
def _train_pool_inputs():
    """Keeps, for each call of the training pooler, its inputs, the
    cotangent that reaches its output and the gradients it sends to its
    features (in stage 1 the pooler is the features' only reader)."""
    from articulation3d_tpu_torch.models import planercnn as pmod
    orig, store = pmod.multilevel_roi_align_train, []

    def rec(features, boxes, **kw):
        out = orig(features, boxes, **kw)
        item = {"features": [f.detach() for f in features], "boxes": boxes, "kw": kw,
                "dfeats": [None] * len(features)}
        store.append(item)
        if out.requires_grad:
            out.register_hook(lambda g: item.__setitem__("g", g.detach().clone()))
            for i, f in enumerate(features):
                if f.requires_grad:
                    f.register_hook(lambda d, i=i: item["dfeats"].__setitem__(
                        i, d.detach().clone()))
        return out

    pmod.multilevel_roi_align_train = rec
    try:
        yield store
    finally:
        pmod.multilevel_roi_align_train = orig


def _check_k2(rac, item) -> None:
    """K1's record and K2 against its plain version (1e-4 x max|plain|) on a
    training step's own box-pool inputs and cotangent; K2 takes the
    cotangent as the pooler gets it: invalid rows are skipped by their
    record (ny = 0), as the plain version skips them."""
    feats, boxes, kw = item["features"], item["boxes"], item["kw"]
    g = item["g"].reshape(-1, *item["g"].shape[2:]).contiguous()
    opts = dict(strides=STRIDES, output_size=kw["output_size"],
                sampling_ratio=kw["sampling_ratio"], aligned=kw["aligned"])
    shapes = [f.shape for f in feats]
    record = check_record(rac, feats, boxes, kw["valid"], kw["output_size"],
                          kw["sampling_ratio"], kw["aligned"])
    got = rac.multilevel_roi_align_adjoint_cuda(g, shapes, boxes, record, **opts)
    want = rac.multilevel_roi_align_adjoint_separable(
        g, shapes, rac._prepare(shapes, boxes, valid=kw["valid"], **opts))
    scale = max(float(b.abs().max()) for b in want)
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) <= 1e-4 * scale


def _records(recs) -> list:
    return [{k: v for k, v in r.items() if k not in ("data_s", "wall_s")} for r in recs]


def _loss_gap(a, b) -> float:
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for x, y in zip(a, b) for k in y)


# --------------------------------------------------------------------------- #
# stage 1 and its pooler
# --------------------------------------------------------------------------- #

def test_stage1_steps_and_k2_on_the_steps_own_box_pool(tmp_path):
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    trainer, _ = _stage1_trainer(tmp_path)
    with tracing.recording() as rec:
        recs = trainer.train(2) + trainer.train(22)
    n, totals = len(recs), [r["total_loss"] for r in recs]
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert rec.counter("k1.launches") == n and rec.counter("k2.launches") == n
    assert totals[-1] < totals[0], totals
    with _train_pool_inputs() as store:
        trainer.train(trainer.iter + 1)
    (item,) = store
    _check_k2(rac, item)


@pytest.mark.parametrize("damped", [True, False], ids=["damped", "slivers"])
def test_float32_step_kernel_pooler_against_gather_pooler(tmp_path, damped):
    """One float32 step from the same weights and generator seed with the
    kernel pooler ("cuda": K1 forward, K2 backward) and with the gather
    pooler under autograd ("torch"): losses within 1e-4 relative; the p2
    convs' gradients (which also carry the RPN's) within 1e-3 x max|grad|.
    Then the pooler alone on the kernel run's own features, boxes and
    cotangent: K3's gradients to p2..p5 against the gather's autograd within
    1e-4 x max|grad| per level.  The two runs' own pooler gradients are not
    held to a tolerance: the L1 box loss has a kink, so a float32 difference
    in the forward can flip the sign of a foreground ROI's cotangent.  With
    the RPN deltas at the serving weights' scale (x256) the sampled ROIs
    include slivers, some of which the JAX Pallas kernel pools from a
    coarser level (`pallas_moved`)."""
    from articulation3d_tpu_torch.models.planercnn import PlaneRCNN
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.train.optimizer import freeze_mask
    from articulation3d_tpu_torch.train.train_step import compute_losses, to_device
    from articulation3d_tpu_torch.weights import load_d2_state_dict
    cfg = _stage1_config(tmp_path, dtype="float32")
    batch = to_device(_train_batch(cfg, 16), "cuda")
    names = ("backbone.fpn_output2.weight", "backbone.fpn_lateral2.weight")
    model = PlaneRCNN(cfg)
    sd = _train_weights(rpn_delta_scale=0.01 if damped else 256.0)
    load_d2_state_dict(model, {k: v for k, v in sd.items() if k in model.state_dict()})
    del sd
    model = model.cuda().train()
    freeze_mask(model, cfg.model.freeze)
    res = {}
    for impl in ("cuda", "torch"):
        model.config = cfg.replace(model=dataclasses.replace(cfg.model, roi_pooler_impl=impl))
        model.zero_grad(set_to_none=True)
        with _train_pool_inputs() as store:
            gen = torch.Generator(device="cuda").manual_seed(7)
            losses = compute_losses(model, batch, gen)
            sum(losses.values()).backward()
        item = store[0]
        assert all(d is not None for d in item["dfeats"]) and "g" in item, impl
        grads = {n: dict(model.named_parameters())[n].grad.detach().clone() for n in names}
        res[impl] = ({k: float(v.detach()) for k, v in losses.items()}, grads, item)
    (la, ga, ia), (lb, gb, ib) = res["cuda"], res["torch"]
    kw = ia["kw"]
    check_record(rac, ia["features"], ia["boxes"], kw["valid"], kw["output_size"],
                 kw["sampling_ratio"], kw["aligned"])
    assert bool((ia["boxes"] == ib["boxes"]).all()), "the two runs sampled different ROIs"
    if not damped:
        assert int(pallas_moved(ia["boxes"], kw["valid"], kw["output_size"],
                                kw["sampling_ratio"], kw["aligned"]).sum()) > 0
    assert max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-12) for k in lb) <= 1e-4
    gerr = {n: float((ga[n] - gb[n]).abs().max()) / float(gb[n].abs().max()) for n in names}
    assert all(v <= 1e-3 for v in gerr.values()), gerr
    vjp = {}
    for impl in ("cuda", "torch"):
        fs = [f.clone().requires_grad_(True) for f in ia["features"]]
        out = rac.multilevel_roi_align_train(fs, ia["boxes"], **dict(kw, impl=impl))
        vjp[impl] = torch.autograd.grad(out, fs, grad_outputs=ia["g"])
    scale = [float(b.abs().max()) for b in vjp["torch"]]
    perr = [float((a - b).abs().max()) / max(s, 1e-30)
            for a, b, s in zip(vjp["cuda"], vjp["torch"], scale)]
    assert all(e <= 1e-4 for e in perr), perr
    assert scale[0] > 0, scale


def _stage3_batch(cfg, b: int, g: int = 4):
    """Synthetic stage-3 batch: `_train_batch`'s images and boxes, box-shaped
    packed masks, planes (unit normal x offset), axes and u16 depth."""
    h, w = cfg.input.height, cfg.input.width
    batch = _train_batch(cfg, b, g)
    rs = np.random.RandomState(1)
    masks = np.zeros((b, g, h, w), bool)
    for i in range(b):
        for j in range(g):
            x1, y1, x2, y2 = batch["gt_boxes"][i, j].astype(int)
            masks[i, j, y1 + 2:y2 - 2, x1 + 2:x2 - 2] = True
    normals = rs.randn(b, g, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    axis = lambda: np.concatenate([rs.randn(b, g, 3), np.ones((b, g, 1))], -1)
    batch.update(gt_masks_packed=np.packbits(masks, axis=-1),
                 gt_planes=(normals * rs.uniform(1, 4, (b, g, 1))).astype(np.float32),
                 gt_rot_axis=axis().astype(np.float32), gt_tran_axis=axis().astype(np.float32),
                 gt_depth_mm=rs.randint(500, 5000, (b, h, w)).astype(np.uint16))
    return batch


def test_refine_head_training_steps(tmp_path):
    """configs/step3_plane.yaml with `model.refine_on true` at ims 4 (cut
    from 8) and score threshold 0 (at random weights the 3-way softmax
    gives every class about 1/3, below the shipped 0.7, and the cascade
    would hand the refine head no detection): 12 steps on one synthetic
    batch, K1 five times a step (the sampled ROIs' three pools and the
    cascade's two no-grad pools), no K2 (frozen trunk), a falling
    `refine_loss`, and K1 against its plain version on the first step's
    five pools."""
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.config import load_config
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.weights import warm_start
    cfg = load_config(os.path.join(ROOT, "configs", "step3_plane.yaml"))
    heads = dataclasses.replace(cfg.model.roi_heads, score_thresh_test=0.0)
    cfg = cfg.replace(weights="", output_dir=str(tmp_path),
                      model=dataclasses.replace(cfg.model, refine_on=True, roi_heads=heads),
                      solver=dataclasses.replace(cfg.solver, ims_per_batch=4,
                                                 warmup_iters=0, base_lr=0.002))
    trainer = Trainer(cfg, [_stage3_batch(cfg, 4)])
    warm_start(trainer.model, _train_weights())
    with tracing.recording() as rec:
        pools = record_pools(5)
        try:
            recs = trainer.train(2)
        finally:
            pools.restore()
        recs += trainer.train(12)
    n, refine = len(recs), [r["refine_loss"] for r in recs]
    cascade = [kw for _, _, kw in pools.calls[3:]]
    assert len(pools.calls) == 5 and all(kw["training"] and kw["resolution"] == 14
                                         for kw in cascade), [kw for _, _, kw in pools.calls]
    main_path_err(rac, pools.calls)
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert rec.counter("k1.launches") == 5 * n and rec.counter("k2.launches") == 0
    assert np.mean(refine[-3:]) < np.mean(refine[:3]), refine


# --------------------------------------------------------------------------- #
# data parallelism and remat
# --------------------------------------------------------------------------- #

def test_ddp_group_of_one_against_the_unwrapped_step(tmp_path):
    """An NCCL process group of one and the stage-1 step wrapped in
    DistributedDataParallel against the unwrapped step from the same state:
    two steps' losses within 1e-4 relative; the parameters after them
    within 1e-2 x the change two steps make (+ 1e-6 x the magnitude),
    the kernels' bfloat16 tolerance, since the bfloat16 trunk rounds weight
    gradients summed in an order that varies from run to run on the card
    (cuDNN's weight gradients, K2's atomics); K1 and K2 of the wrapped step
    against their plain versions on its own inputs."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    from articulation3d_tpu_torch.parallel import init_distributed, process_count
    assert init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl" and process_count() == 1
        plain, _ = _stage1_trainer(tmp_path / "plain")
        wrapped, _ = _stage1_trainer(tmp_path / "wrapped")
        wrapped.step_model = DistributedDataParallel(wrapped.model, device_ids=[0],
                                                     broadcast_buffers=False)
        before = param_samples(plain.model)
        assert all(np.array_equal(v, before[n]) for n, v in param_samples(wrapped.model).items())
        recs_plain = plain.train(2)
        with tracing.recording() as rec, _train_pool_inputs() as store:
            pools = record_pools(1)
            try:
                recs = wrapped.train(2)
            finally:
                pools.restore()
        assert rec.counter("k1.launches") == 2 and rec.counter("k2.launches") == 2
        assert _loss_gap(_records(recs), _records(recs_plain)) <= 1e-4
        assert params_agree(param_samples(wrapped.model), param_samples(plain.model), before,
                            rel=1e-2) <= 1.0
        main_path_err(rac, pools.calls)
        _check_k2(rac, store[0])
    finally:
        dist.destroy_process_group()


def test_remat_against_the_plain_trunk(tmp_path):
    """The stage-1 step with `resnet.remat` off and on from the same state:
    the first two steps' losses within 1e-4 relative and the parameters
    after them within 1e-2 x the change (+ 1e-6 x the magnitude); K1 and K2
    of a remat step against their plain versions on its own inputs."""
    from articulation3d_tpu_torch import tracing
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    base = _stage1_config(tmp_path).model.resnet
    runs = []
    with tracing.recording() as rec:
        for remat in (False, True):
            trainer, _ = _stage1_trainer(tmp_path / str(remat),
                                         resnet=dataclasses.replace(base, remat=remat))
            assert trainer.model.backbone.bottom_up.cfg.remat == remat
            before = param_samples(trainer.model)
            recs = trainer.train(2)
            runs.append(dict(before=before, after=param_samples(trainer.model),
                             records=_records(recs)))
        pools = record_pools(1)
        with _train_pool_inputs() as store:
            try:
                trainer.train(trainer.iter + 1)
            finally:
                pools.restore()
    off, on = runs
    assert all(np.array_equal(on["before"][n], off["before"][n]) for n in off["before"])
    assert all(np.isfinite(v) for r in runs for rec_ in r["records"] for v in rec_.values())
    assert params_agree(on["after"], off["after"], off["before"], rel=1e-2) <= 1.0
    assert _loss_gap(on["records"], off["records"]) <= 1e-4
    assert rec.counter("k1.launches") == rec.counter("k2.launches") == 2 * 2 + 1
    main_path_err(rac, pools.calls)
    _check_k2(rac, store[0])


@pytest.fixture(scope="module")
def recipe_data(tmp_path_factory):
    """The recipe's synthetic 480x640 dataset (48 train, 16 val, 16 test
    records, a quarter of them negative, u16 depth, two 32-frame val clips),
    registered under the arti_* and scannet_* names."""
    from articulation3d_tpu_torch.data.catalog import register_builtin_datasets
    root = str(tmp_path_factory.mktemp("datasets"))
    splits = write_recipe_dataset(root)
    register_builtin_datasets(root)
    yield root, splits
    register_builtin_datasets()


def _emulated_sharded_steps(trainer, batch, steps: int) -> list:
    """The W = 2 sharded step (`sharded_train_step`) emulated in one
    process: per step, the gradients of each half of the global batch (the
    global batch's per-image generators, each half its own losses and
    normalisers and BatchNorm statistics), their mean, the mean of the two
    halves' new running statistics, then the clip and the update."""
    from articulation3d_tpu_torch.train.targets import per_image_keys
    from articulation3d_tpu_torch.train.train_step import (_update, compute_losses,
                                                           running_statistics, to_device)
    model, dev = trainer.model, trainer.device
    b = batch["images"].shape[0]
    halves = [to_device({k: v[h * b // 2:(h + 1) * b // 2] for k, v in batch.items()}, dev)
              for h in range(2)]
    params = [p for p in model.parameters() if p.requires_grad]
    stats = running_statistics(model)
    recs = []
    for _ in range(steps):
        gens = per_image_keys(trainer.generator, b)
        old = [s.clone() for s in stats]
        grads, new_stats, metrics = [], [], []
        for h, half in enumerate(halves):
            for s, o in zip(stats, old):
                s.copy_(o)
            trainer.optimizer.zero_grad(set_to_none=True)
            losses = compute_losses(model, half, gens[h * b // 2:(h + 1) * b // 2])
            total = sum(v.to(torch.float32) for v in losses.values())
            total.backward()
            grads.append([p.grad.clone() for p in params])
            new_stats.append([s.clone() for s in stats])
            metrics.append({**{k: float(v.detach()) for k, v in losses.items()},
                            "total_loss": float(total.detach())})
        with torch.no_grad():
            for p, g0, g1 in zip(params, *grads):
                p.grad.copy_(g0 / 2 + g1 / 2)
            for s, s0, s1 in zip(stats, *new_stats):
                s.copy_((s0 + s1) / 2)
        _update(model, trainer.optimizer, trainer.scheduler)
        trainer.iter += 1
        recs.append({k: (metrics[0][k] + metrics[1][k]) / 2 for k in metrics[0]})
    return recs


def _ranks_payload(distributed: bool, out: str, data_root: str) -> dict:
    """What the two processes and the one process compare, from each rank
    or from this process: float32 stage-1 steps at a global batch of 16
    (each rank its share), then the two evaluators through `Trainer.test`
    and `VideoPipeline` on a val clip.

    Each rank: two steps of the `Trainer`'s own step (`sharded_train_step`);
    two steps of the global-batch step (`train_step`, JAX's
    `make_train_step` over a mesh) from a fresh trainer; one step with
    `solver.grad_sync_dtype: bfloat16` whose buckets are held to JAX's order
    (two ranks).  One process: two steps of the emulated sharded step, and
    two steps of `Trainer` at 16 (the global batch)."""
    import torch.distributed as dist

    from articulation3d_tpu_torch.parallel import dist as pdist
    from articulation3d_tpu_torch.train.train_step import train_step
    from articulation3d_tpu_torch.train.trainer import Trainer
    from articulation3d_tpu_torch.video.io import read_frames
    from articulation3d_tpu_torch.video.pipeline import VideoPipeline
    from articulation3d_tpu_torch.weights import load_d2_state_dict

    res = {}
    trainer, batch = _stage1_trainer(out, dtype="float32")       # parity in float32
    res["before"] = param_samples(trainer.model)
    if distributed:
        res["step_fn"] = trainer.step_fn.__name__
        recs = trainer.train(2)
    else:
        recs = _emulated_sharded_steps(trainer, batch, 2)
    res["sharded"] = {"records": _records(recs), "after": param_samples(trainer.model)}
    del trainer
    trainer, _ = _stage1_trainer(out, dtype="float32")
    trainer.step_fn = train_step                      # the global-batch step
    recs = trainer.train(2)
    res["global"] = {"records": _records(recs), "after": param_samples(trainer.model),
                     "wrapped": type(trainer.step_model).__name__}
    del trainer
    if distributed and dist.get_world_size() == 2:
        buckets: list = []
        hook = pdist.bf16_grad_sync_hook
        pdist.bf16_grad_sync_hook = recording_bf16_hook(buckets)
        try:
            trainer, _ = _stage1_trainer(out, dtype="float32", grad_sync_dtype="bfloat16")
        finally:
            pdist.bf16_grad_sync_hook = hook
        trainer.train(1)
        res["bf16"] = check_bf16_buckets(buckets, dist.get_world_size())
        del trainer, buckets
    torch.cuda.empty_cache()
    cfg = parity_config()
    cfg = cfg.replace(datasets_test=("arti_val", "scannet_val"), output_dir=os.path.join(
        out, "eval"), solver=dataclasses.replace(cfg.solver, ims_per_batch=8))
    ev = Trainer(cfg, [])
    load_d2_state_dict(ev.model, serving_weights(cfg))
    res["eval"] = ev.test()
    clips = os.path.join(data_root, "clips")
    frames, _ = read_frames(os.path.join(clips, sorted(os.listdir(clips))[0]), 480, 640)
    pipe = VideoPipeline(ev.cfg, ev.model, batch_size=8, conf_threshold=0.0,
                         distributed=distributed)
    preds = pipe.run(frames)
    res["preds"] = [{f: getattr(p, f) for f in ("boxes", "classes")} for p in preds]
    del ev, pipe
    torch.cuda.empty_cache()
    return res


def _rank_worker(rank: int, world: int, store: str, out: str, data_root: str) -> None:
    """One rank of `test_ranks_against_one_process`: `init_distributed`
    picks NCCL when every rank has its own card and gloo otherwise (NCCL
    refuses two ranks on one device); the payload is pickled to
    OUT/rank{R}.pkl."""
    import torch.distributed as dist

    from articulation3d_tpu_torch.data.catalog import register_builtin_datasets
    from articulation3d_tpu_torch.parallel import barrier, init_distributed, process_count
    _tf32_off()
    assert init_distributed(f"file://{store}", world, rank, timeout_s=600)
    expected = "nccl" if world <= torch.cuda.device_count() else "gloo"
    assert dist.get_backend() == expected and process_count() == world
    register_builtin_datasets(data_root)
    payload = _ranks_payload(True, os.path.join(out, f"rank{rank}"), data_root)
    barrier()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)
    dist.destroy_process_group()


@pytest.mark.parametrize("per_card", [False, True], ids=["two_on_one_card", "one_per_card"])
def test_ranks_against_one_process(recipe_data, tmp_path, per_card):
    """Two processes on one card over gloo, or one process per card over
    NCCL where there are several, each with its share of a float32 global
    batch of 16, against this process: the `Trainer`'s sharded step
    against its emulation (the mean of the two halves' gradients, each half
    with its own normalisers) and the global-batch step against one
    process at 16, two steps each: losses within 1e-3 relative, parameters
    within 1e-3 x the change (+ 1e-6 x the magnitude), the replicas equal;
    the bfloat16 sync bit-equal to ((g0/2).bfloat16() +
    (g1/2).bfloat16()).bfloat16().float() of the ranks' own buckets and
    unlike the float32 sync (two ranks); `Trainer.test` with both evaluators
    distributed over arti_val and scannet_val within 1e-6 of one process;
    `VideoPipeline` over a 32-frame val clip split over the ranks with the
    same detections per frame, boxes within 1e-3 px."""
    world = torch.cuda.device_count() if per_card else 2
    if per_card and world < 2:
        pytest.skip("one rank per card needs more than one card")
    data_root = recipe_data[0]
    out = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    code = ("import sys, test_torch_card_train as t; "
            "t._rank_worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world),
                               os.path.join(out, "store"), out, data_root], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-8000:]}"
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    one = _ranks_payload(False, os.path.join(out, "one"), data_root)
    for step in ("sharded", "global"):
        assert max(_loss_gap(t[step]["records"], one[step]["records"]) for t in ranks) <= 1e-3
        assert max(params_agree(t[step]["after"], one[step]["after"], one["before"])
                   for t in ranks) <= 1.0
        assert all(np.array_equal(ranks[0][step]["after"][n], t[step]["after"][n])
                   for t in ranks[1:] for n in ranks[0][step]["after"])
    assert all(t["step_fn"] == "sharded_train_step" for t in ranks)
    assert one["global"]["wrapped"] == "PlaneRCNN"
    assert all(t["global"]["wrapped"] == "DistributedDataParallel" for t in ranks)
    if world == 2:
        bf = [t["bf16"] for t in ranks]
        assert all(b["exact"] and b["off_f32"] > 0 and b["buckets"] > 0 for b in bf), bf
    assert all(t["eval"] == {name: {} for name in one["eval"]} for t in ranks[1:])
    eval_err = {n: dicts_agree(ranks[0]["eval"][n], one["eval"][n]) for n in one["eval"]}
    assert all(e <= 1e-6 for e in eval_err.values()), eval_err
    assert len(one["preds"]) == 32
    for t in ranks:
        for a, b in zip(t["preds"], one["preds"]):
            assert len(a["boxes"]) == len(b["boxes"]) and np.array_equal(a["classes"],
                                                                         b["classes"])
            if len(b["boxes"]):
                assert float(np.abs(a["boxes"] - b["boxes"]).max()) <= 1e-3


# --------------------------------------------------------------------------- #
# the recipe from a dataset on disk
# --------------------------------------------------------------------------- #

def _count_launches(fn):
    from articulation3d_tpu_torch import tracing
    with tracing.recording() as rec:
        res = fn()
    return res, rec.counter("k1.launches"), rec.counter("k2.launches")


@pytest.fixture(scope="module")
def recipe_stage1(recipe_data, tmp_path_factory):
    """Stage 1 through `train_net.main` on configs/step1_bbox.yaml from the
    loader over arti_train (ims 16, 22 steps), from `_train_weights()`
    without the heads it does not train, as a `.pth` in `weights`."""
    from articulation3d_tpu_torch import train_net
    out = str(tmp_path_factory.mktemp("recipe"))
    init = os.path.join(out, "init_weights.pth")
    heads = ("roi_heads.mask_head.", "roi_heads.plane_head.", "roi_heads.axis_head.",
             "depth_head.")
    torch.save({k: v for k, v in _train_weights().items() if not k.startswith(heads)}, init)
    out1 = os.path.join(out, "stage1")
    (trainer, recs), k1, k2 = _count_launches(lambda: train_net.main(
        recipe_argv("step1_bbox", out1, init, 22, "--max-iter", "22")))
    trainer._batches.close()            # its prefetch thread stops
    yield dict(out=out, init=init, out1=out1, ims=trainer.cfg.solver.ims_per_batch, recs=recs,
               k1=k1, k2=k2)
    torch.cuda.empty_cache()


def test_recipe_stage1_from_the_loader(recipe_stage1):
    from articulation3d_tpu_torch.train.checkpoint import latest_checkpoint
    recs, k1, k2 = recipe_stage1["recs"], recipe_stage1["k1"], recipe_stage1["k2"]
    totals = [r["total_loss"] for r in recs]
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert k1 == len(recs) == 22 and k2 == len(recs), (k1, k2)
    assert np.mean(totals[-3:]) < np.mean(totals[:3]), totals
    assert all(r["data_s"] >= 0 and r["wall_s"] > 0 for r in recs), recs
    ckpt1 = latest_checkpoint(recipe_stage1["out1"])
    assert ckpt1 and ckpt1.endswith("model_0000021.pth"), ckpt1


@pytest.fixture(scope="module")
def recipe_eval(recipe_stage1):
    """`--eval-only --resume` on arti_val at score threshold 0, with the
    first three pools' inputs."""
    from articulation3d_tpu_torch import train_net
    pools = record_pools(3)
    try:
        (trainer, results), k1, _ = _count_launches(lambda: train_net.main(
            recipe_argv("step1_bbox", recipe_stage1["out1"], recipe_stage1["init"], 22,
                        "--eval-only", "--resume")))
    finally:
        pools.restore()
    yield dict(iter=trainer.iter, training=trainer.model.training, results=results,
               pools=pools.calls, k1=k1,
               preds=os.path.join(recipe_stage1["out1"], "instances_predictions.pth"))
    torch.cuda.empty_cache()


def test_recipe_eval_only_resume(recipe_data, recipe_eval):
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    res = recipe_eval["results"]["arti_val"]
    check_eval_values(res, "arti_val")
    assert recipe_eval["iter"] == 22 and recipe_eval["training"]
    assert {"bbox/AP", "segm/AP", "auroc", "bbox - arti_rot", "bbox+axis - arti_tran"} <= set(res)
    dumped = torch.load(recipe_eval["preds"], weights_only=False)
    assert len(dumped) == len(recipe_data[1]["val"])
    assert all(len(p["instances"]) == 100 for p in dumped), [len(p["instances"]) for p in dumped]
    assert recipe_eval["k1"] > 0
    main_path_err(rac, recipe_eval["pools"])


@pytest.fixture(scope="module")
def recipe_stage3(recipe_stage1):
    """Stage 3 on configs/step3_plane.yaml warm-started from stage 1's
    checkpoint (ims 8, 12 steps, packed masks and u16 depth), then
    `Trainer.test` on scannet_val; the first step's and the first test
    batch's three pools."""
    from articulation3d_tpu_torch import train_net
    from articulation3d_tpu_torch.train.checkpoint import latest_checkpoint
    out3 = os.path.join(recipe_stage1["out"], "stage3")
    pools = record_pools(3)
    try:
        (trainer, recs), k1, k2 = _count_launches(lambda: train_net.main(recipe_argv(
            "step3_plane", out3, latest_checkpoint(recipe_stage1["out1"]), 12,
            "--max-iter", "12")))
    finally:
        pools.restore()
    calls = pools.calls
    batch = next(trainer.loader.loader.epoch(0))
    pools = record_pools(3)
    try:
        results, k1_test, _ = _count_launches(trainer.test)
    finally:
        pools.restore()
    yield dict(recs=recs, k1=k1, k2=k2, batch=batch, results=results, k1_test=k1_test,
               training=trainer.model.training, pools=calls + pools.calls,
               ckpt=latest_checkpoint(out3))
    trainer._batches.close()
    torch.cuda.empty_cache()


def test_recipe_stage3_then_scannet_eval(recipe_stage3):
    from articulation3d_tpu_torch.ops import roi_align_cuda as rac
    recs, batch = recipe_stage3["recs"], recipe_stage3["batch"]
    assert all(np.isfinite(v) for r in recs for v in r.values()), recs
    assert batch["gt_masks_packed"].dtype == np.uint8 and batch["gt_depth_mm"].dtype == np.uint16
    assert {"loss_mask", "loss_plane", "depth_loss"} <= set(recs[0]), set(recs[0])
    assert recipe_stage3["k1"] > 0 and recipe_stage3["k2"] == 0
    res3 = recipe_stage3["results"]["scannet_val"]
    assert recipe_stage3["training"] and PLANE_KEY in res3 and "depth_l1_dist" in res3
    assert all(np.isfinite(float(v)) for v in res3.values()), res3
    assert recipe_stage3["k1_test"] > 0
    assert any(kw.get("training") for _, _, kw in recipe_stage3["pools"])
    main_path_err(rac, recipe_stage3["pools"])


def test_recipe_evaluators_known_answers(recipe_data, tmp_path):
    """The val GT as predictions gives bbox and bbox+axis AP 1.0 per class
    and AUROC 1.0; axes turned by 90 degrees bbox+axis AP 0; GT planes
    plane AP 1.0."""
    from articulation3d_tpu_torch.data.catalog import get_dataset_dicts
    from articulation3d_tpu_torch.evaluation import ArtiEvaluator, ScannetEvaluator
    val = get_dataset_dicts("arti_val")
    known = {}
    for rotate in (False, True):
        ev = ArtiEvaluator("arti_val", output_dir=str(tmp_path / "known"))
        ev._predictions = known_answer_predictions(val, rotate_axes=rotate)
        known[rotate] = ev.evaluate()
    sev = ScannetEvaluator("scannet_val")
    scan_val = get_dataset_dicts("scannet_val")
    for rec, p in zip(scan_val, known_answer_predictions(scan_val)):
        sev.process([{"image_id": rec["image_id"], "file_name": rec["file_name"]}],
                    [{"instances": p["instances"],
                      "pred_plane": [a["plane"] for a in rec["annotations"]]}])
    scan = sev.evaluate()
    for c in ("arti_rot", "arti_tran"):
        assert known[False][f"bbox - {c}"] == 1.0 and known[False][f"bbox+axis - {c}"] == 1.0
        assert known[True][f"bbox+axis - {c}"] == 0.0
    assert known[False]["auroc"] == 1.0 and scan[PLANE_KEY] == 1.0


def test_opt_arti_in_two_shards_then_merged(recipe_data, recipe_eval, recipe_stage3, tmp_path,
                                            monkeypatch):
    """`opt_arti` with conf 0 from stage 3's checkpoint over the val clips in
    two SLURM shards, then `--load-results`."""
    import yaml

    from articulation3d_tpu_torch import opt_arti
    with open(os.path.join(ROOT, "configs", "config.yaml")) as f:
        opt_cfg = yaml.safe_load(f)
    opt_cfg["weights"] = recipe_stage3["ckpt"]
    opt_cfg["model"]["roi_heads"] = {"score_thresh_test": 0.0}
    opt_cfg["model"]["roi_pooler_impl"] = "cuda"
    cfg_path = str(tmp_path / "opt_arti.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(opt_cfg, f)
    opt_out = str(tmp_path / "opt_arti")
    argv = ["--config", cfg_path, "--input", recipe_eval["preds"], "--output", opt_out,
            "--dataset", "arti_val", "--video-root", os.path.join(recipe_data[0], "clips"),
            "--conf-threshold", "0"]
    monkeypatch.setenv("SLURM_ARRAY_TASK_MAX", "1")
    k1 = 0
    for task in ("0", "1"):
        monkeypatch.setenv("SLURM_ARRAY_TASK_ID", task)
        r, k1_task, _ = _count_launches(lambda: opt_arti.main(argv))
        assert r is None
        k1 += k1_task
    monkeypatch.delenv("SLURM_ARRAY_TASK_ID")
    merged = opt_arti.main(argv + ["--load-results"])
    shards = sorted(n for n in os.listdir(opt_out) if n.startswith("predictions_"))
    n_pred = sum(len(torch.load(os.path.join(opt_out, s), weights_only=False)["predictions"])
                 for s in shards)
    check_eval_values(merged, "arti_val")
    assert shards == ["predictions_0000.pth", "predictions_0001.pth"], shards
    assert n_pred == 2 * RECIPE_SPLITS["val"][1] and k1 >= 2 * 4 * 3, (n_pred, k1)
    assert {"bbox - arti_rot", "auroc"} <= set(merged)
