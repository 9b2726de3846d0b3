"""Port vs JAX: the refine head and the DRPN head, on the CPU in float32.

Inputs are drawn with numpy from fixed seeds; JAX parameters (flax's init,
or numpy draws in flax's layout) reach the port through
`weights.state_dict_from_jax`, so its refine-head and DRPN name map and
its flip of the transposed-conv kernels are under test too.

  * each helper of `models/refine_head.py` equals JAX's, or agrees within
    1e-6 x max |JAX| (float32 arithmetic in another order); the plane
    offsets, means over 768 pixels, within 1e-5 (sums in another order:
    measured 1.5e-6);
  * flax's "SAME" padding: the stride-2 3x3 conv pads at the end on even
    sizes, and the 4x4 stride-2 transposed conv is torch's
    `ConvTranspose2d(k=4, s=2, p=1)` with the kernel flipped (1e-6);
  * `RefineHead` at the JAX test's tiny config (32x40, D = 4, two valid):
    logits within 1e-4 x max |JAX| (twelve float32 conv layers summed in
    another order);
  * `refine_inference_masks` pixel-equal to JAX at the 0.5 threshold, away
    from pixels whose interpolated value lies within 1e-6 of it (a tie);
  * a tiny `PlaneRCNN.inference` (64x96, 8 detections, 32 proposals) with
    `refine_on` and the DRPN head: its refine pass on JAX's own detections
    at the tolerances above, and end to end (see the test for why wider);
  * the refine head's gradients through its loss on identical inputs
    within 1e-4 x max |JAX| (one tiny train step with `refine_on` is in
    `tests/test_torch_refine_train.py`, so that its JAX compile runs in
    another xdist worker);
  * the DRPN head alone (`head_convs=5`, the JAX test's shapes): the same
    proposals.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as flax_nn

from articulation3d_tpu import config as jcfg
from articulation3d_tpu.models import refine_head as jrh
from articulation3d_tpu.models.planercnn import PlaneRCNN as JaxPlaneRCNN
from articulation3d_tpu.models.rpn import RPN as JaxRPN
from articulation3d_tpu.train.checkpoint import port_detectron2_state_dict

from articulation3d_tpu_torch import config as pcfg
from articulation3d_tpu_torch.models import refine_head as prh
from articulation3d_tpu_torch.models.planercnn import build_model
from articulation3d_tpu_torch.models.rpn import RPN as PortRPN
from articulation3d_tpu_torch.ops.preprocess import preprocess_images
from articulation3d_tpu_torch.structures import Detections
from articulation3d_tpu_torch.weights import state_dict_from_jax
from test_torch_train import _np_tree
from torch_oracle import bias_state_dict_for_detections, he_state_dict

H, W = 64, 80
D = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, scale):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(float(np.abs(want).max()), 1e-30))


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #

def test_refine_ranges_equal_jax():
    np.testing.assert_array_equal(prh.refine_ranges(48, 64, 571.623718).numpy(),
                                  jrh.refine_ranges(48, 64, 571.623718))


def test_plane_xyz_module_matches_jax():
    rs = np.random.RandomState(0)
    ranges = jrh.refine_ranges(24, 32)
    planes = rs.randn(5, 3).astype(np.float32)
    planes[2] = 0.0                                  # a padded row
    planes[3] = [0.0, 1e-6, 0.0]                     # near-zero offset
    want = jrh.plane_xyz_module(jnp.asarray(planes), jnp.asarray(ranges), 10.0)
    got = prh.plane_xyz_module(_t(planes), _t(ranges), 10.0)
    assert got.shape == (5, 24, 32, 3)
    _close(got, want, 1e-6)
    # the zero row's guard: a zero gradient, not NaN
    p = _t(planes).requires_grad_()
    prh.plane_xyz_module(p, _t(ranges)).sum().backward()
    assert bool(torch.isfinite(p.grad).all()) and bool((p.grad[2] == 0).all())


def test_recompute_plane_offsets_matches_jax():
    rs = np.random.RandomState(1)
    ranges = jrh.refine_ranges(24, 32)
    normals = rs.randn(4, 3).astype(np.float32)
    masks = rs.rand(4, 24, 32).astype(np.float32)
    masks[3] = 0.0
    depth = (np.abs(rs.randn(24, 32)) + 1.0).astype(np.float32)
    want = jrh.recompute_plane_offsets(*(jnp.asarray(a) for a in (normals, masks, depth,
                                                                   ranges)))
    got = prh.recompute_plane_offsets(_t(normals), _t(masks), _t(depth), _t(ranges))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("src,dst", [((480, 640), (192, 256)), ((20, 24), (48, 64)),
                                     ((37, 41), (16, 20))])
def test_resize_matches_jax(src, dst):
    x = np.random.RandomState(2).randn(3, *src).astype(np.float32)
    want = jrh._resize(jnp.asarray(x), *dst)
    got = prh._resize(_t(x), *dst)
    assert tuple(got.shape) == (3, *dst)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("hw", [(10, 12), (9, 11)])
def test_same_padding_and_deconv_alignment_match_flax(hw):
    """One stride-2 3x3 conv and one 4x4 stride-2 transposed conv, at an
    even and an odd size, with flax's kernels converted as `weights.py`
    converts them (conv HWIO -> OIHW; deconv flipped, then (I, O, H, W))."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, *hw, 5).astype(np.float32)
    conv = flax_nn.Conv(6, (3, 3), strides=(2, 2), padding="SAME")
    deconv = flax_nn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="SAME")
    for layer, mode in ((conv, "conv"), (deconv, "deconv")):
        params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = {"kernel": jnp.asarray(rs.randn(*params["kernel"].shape), jnp.float32),
                  "bias": jnp.asarray(rs.randn(6), jnp.float32)}
        want = np.asarray(flax_nn.relu(layer.apply({"params": params}, jnp.asarray(x))))
        k = np.asarray(params["kernel"])
        block = prh.ConvBlock(5, 6, kernel=k.shape[0], stride=2, mode=mode)
        block.conv.weight.data = _t(k.transpose(3, 2, 0, 1) if mode == "conv"
                                    else k[::-1, ::-1].transpose(2, 3, 0, 1))
        block.conv.bias.data = _t(params["bias"])
        got = block(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach()
        assert tuple(got.shape) == want.shape, mode
        _close(got, want, 1e-6)


def test_accumulate_and_mean_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(4, 5, 6, 3).astype(np.float32)
    x[3] = 1e6                                      # a padded row's garbage
    valid = np.asarray([True, True, False, False])
    want = jrh.RefinementBlock._accumulate(jnp.asarray(x), jnp.asarray(valid))
    got = prh.RefinementBlock.accumulate(_t(x).permute(0, 3, 1, 2), _t(valid))
    _close(got.permute(0, 2, 3, 1), want, 1e-6)
    want = jrh.RefinementBlock._mean(jnp.asarray(x), jnp.asarray(valid))
    got = prh.RefinementBlock.mean(_t(x).permute(0, 3, 1, 2), _t(valid))
    _close(got.permute(0, 2, 3, 1), want, 1e-6)


def _masks_pair(rs):
    gt = np.zeros((3, H, W), np.float32)
    gt[0, 0:20, 0:20] = 1
    gt[1, 30:50, 30:50] = 1
    gt[2, 5:60, 40:78] = 1
    pred = np.zeros((D, H, W), np.float32)
    pred[0, 2:18, 2:18] = 0.9
    pred[1, 32:48, 32:48] = 0.9
    pred[2, 31:49, 31:49] = 0.9
    pred[3] = rs.rand(H, W)
    return gt, pred


@pytest.mark.parametrize("gt_valid,pred_valid", [
    ([True, True, False], [True, True, True, False]),
    ([True, True, True], [True, False, True, True])])
def test_assign_pred_masks_equals_jax(gt_valid, pred_valid):
    gt, pred = _masks_pair(np.random.RandomState(5))
    args = (gt, np.asarray(gt_valid), pred, np.asarray(pred_valid))
    want = jrh.assign_pred_masks(*(jnp.asarray(a) for a in args))
    got = prh.assign_pred_masks(*(_t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pred_valid", [[True, True, True, False], [False] * D])
def test_refine_loss_single_matches_jax(pred_valid):
    rs = np.random.RandomState(6)
    gt, pred = _masks_pair(rs)
    logits = rs.randn(D + 1, 32, 40).astype(np.float32) * 3
    args = (logits, gt, np.asarray([True, True, False]), pred, np.asarray(pred_valid))
    want = float(jrh.refine_loss_single(*(jnp.asarray(a) for a in args)))
    got = float(prh.refine_loss_single(*(_t(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (want == 0.0) == (not any(pred_valid))


def _tie_free_equal(got, want, thresh=0.5, tie=1e-6):
    """`got >= thresh` equals `want >= thresh` wherever want is not within
    `tie` of the threshold; returns the number of tie pixels skipped."""
    want = np.asarray(want)
    away = np.abs(want - thresh) > tie
    np.testing.assert_array_equal((np.asarray(got) >= thresh)[away], (want >= thresh)[away])
    return int((~away).sum())


def test_refine_inference_masks_match_jax():
    rs = np.random.RandomState(7)
    logits = rs.randn(D + 1, 32, 40).astype(np.float32)
    valid = np.asarray([True, False, True, True])
    want = jrh.refine_inference_masks(jnp.asarray(logits), jnp.asarray(valid), H, W)
    got = prh.refine_inference_masks(_t(logits), _t(valid), H, W)
    assert tuple(got.shape) == (D, H, W)
    _close(got, want, 1e-6)
    _tie_free_equal(got.numpy(), want)
    assert float(got[1].abs().max()) == 0.0 and float(got.sum()) > 0


# --------------------------------------------------------------------------- #
# RefineHead alone
# --------------------------------------------------------------------------- #

def _refine_inputs(rs, h=H, w=W, d=D):
    image = rs.randint(0, 255, (h, w, 3)).astype(np.float32)
    masks = np.zeros((d, h, w), np.float32)
    masks[0, 5:25, 5:25] = 0.8
    masks[1, 30:50, 30:60] = 0.9
    planes = rs.randn(d, 3).astype(np.float32)
    planes /= np.linalg.norm(planes, axis=1, keepdims=True)
    depth = (np.abs(rs.randn(h, w)) + 1.0).astype(np.float32)
    valid = np.asarray([True, True] + [False] * (d - 2))
    return image, masks, planes, depth, valid


def _port_refine_head(cfg, jax_params):
    """A port RefineHead holding flax's refine-head parameters."""
    sd = state_dict_from_jax({"refine_head": jax_params}, num_classes=2)
    assert len(sd) == 26 and all(k.startswith("refine_head.") for k in sd)
    head = prh.RefineHead(cfg)
    head.load_state_dict({k[len("refine_head."):]: _t(v) for k, v in sd.items()})
    return head


def test_refine_head_matches_jax():
    jc, pc = jcfg.RefineHeadConfig(height=32, width=40), pcfg.RefineHeadConfig(height=32,
                                                                               width=40)
    args = _refine_inputs(np.random.RandomState(8))
    jargs = [jnp.asarray(a) for a in args]
    head = jrh.RefineHead(jc)
    variables = head.init(jax.random.PRNGKey(0), *jargs)
    want_logits, want_planes = jax.jit(head.apply)(variables, *jargs)
    port = _port_refine_head(pc, variables["params"])
    with torch.no_grad():
        logits, planes = port(*(_t(a) for a in args))
    assert tuple(logits.shape) == (D + 1, 32, 40)
    _close(logits, want_logits, 1e-4)
    _close(planes, want_planes, 1e-6)
    assert float(planes[2:].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# the whole model: inference and one train step
# --------------------------------------------------------------------------- #

def _fill_conv_tree(tree, rs, bias=None):
    """Seeded He-style numpy draws for every conv of a flax subtree (HWIO
    kernels; transposed-conv kernels likewise by their input width)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill_conv_tree(v, rs, bias)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:3]))
            out[k] = (rs.randn(*v.shape) * 0.8 * np.sqrt(2.0 / fan_in)).astype(np.float32)
        else:
            out[k] = (rs.randn(*v.shape) * 0.05).astype(np.float32)
    return out


def _jax_variables(jc, sd, refine_pred_bias=0.0):
    """The d2 state dict ported into JAX; the DRPN stack and the refine head,
    which the d2 schema of the oracle lacks, from numpy draws."""
    shapes = jax.eval_shape(
        lambda r: JaxPlaneRCNN(jc).init(r, jnp.zeros((1, jc.input.height, jc.input.width, 3)),
                                        method=JaxPlaneRCNN.inference),
        jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, batch_stats, _ = port_detectron2_state_dict(sd, zeros["params"],
                                                        zeros["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, params)
    params = dict(params)
    rs = np.random.RandomState(9)
    if jc.model.rpn.head_convs > 1:
        head = dict(params["rpn"]["head"])
        for i in range(jc.model.rpn.head_convs):
            head[f"conv_{i}"] = _fill_conv_tree(head[f"conv_{i}"], rs)
        params["rpn"] = dict(params["rpn"], head=head)
    if jc.model.refine_on:
        refine = _fill_conv_tree(params["refine_head"], rs)
        # lift the instance logits so some pixels leave the background
        refine["refinement_block"]["pred"]["bias"] += np.float32(refine_pred_bias)
        params["refine_head"] = refine
    return params, _np_tree(batch_stats)


def _infer_cfgs():
    def build(m, impl):
        model = m.ModelConfig(
            rpn=m.RPNConfig(pre_nms_topk_test=32, post_nms_topk_test=32, head_convs=5),
            roi_heads=m.ROIHeadsConfig(detections_per_image=8, score_thresh_test=0.0),
            depth_head=m.DepthHeadConfig(output_height=64, output_width=96),
            refine_head=m.RefineHeadConfig(height=32, width=48),
            refine_on=True, dtype="float32", roi_pooler_impl=impl)
        return m.Config(model=model, input=m.InputConfig(height=64, width=96))
    return build(jcfg, "xla"), build(pcfg, "torch")


@pytest.fixture(scope="module")
def infer_parity():
    jc, pc = _infer_cfgs()
    sd = bias_state_dict_for_detections(he_state_dict(0))
    # eval-mode BatchNorms on the oracle's random statistics put the depth
    # near 4e8 m: scale its last conv so the refine head sees metres; and
    # soften the mask logits (|x| ~ 30 otherwise, where float32 noise of
    # the logits moves the probabilities by 2e-3, tests/test_torch_model.py)
    for k, f in (("depth_head.depth_pred.weight", 1e-8), ("depth_head.depth_pred.bias", 1e-8),
                 ("roi_heads.mask_head.predictor.weight", 0.02)):
        sd[k] = (sd[k] * f).astype(np.float32)
    params, batch_stats = _jax_variables(jc, sd, refine_pred_bias=2.0)
    variables = {"params": params, "batch_stats": batch_stats}
    image = np.random.RandomState(1).randint(0, 255, (1, 64, 96, 3)).astype(np.uint8)
    images = preprocess_images(_t(image), height=64, width=96)
    jimages = jnp.asarray(images.numpy())
    j = _np_tree(jax.jit(lambda v, x: JaxPlaneRCNN(jc).apply(
        v, x, method=JaxPlaneRCNN.inference))(variables, jimages))
    # JAX's refine pass on its own detections and depth, for the same-input check
    jref = _np_tree(JaxPlaneRCNN(jc).apply(variables, jimages, j["detections"],
                                           jnp.asarray(j["depth"]),
                                           method=JaxPlaneRCNN._refine))
    model = build_model(pc, device="cpu", state_dict=state_dict_from_jax(params, batch_stats))
    return dict(j=j, jref=jref, p=model.inference(images), model=model, images=images)


def test_refine_pass_on_jax_detections_matches_jax(infer_parity):
    """`PlaneRCNN._refine` (soft masks pasted at threshold -1, the 0.1 score
    gate, the raw image from the inverted preprocess, the per-image loop)
    on JAX's detections and depth: soft masks equal, plane offsets within
    1e-5 and logits within 1e-4 x max |JAX|, and the masks that inference
    returns from those logits pixel-equal away from ties."""
    jd, jref = infer_parity["j"]["detections"], infer_parity["jref"]
    dets = Detections(boxes=_t(jd.boxes), scores=_t(jd.scores), classes=_t(jd.classes),
                      valid=_t(jd.valid), masks=_t(jd.masks), planes=_t(jd.planes))
    with torch.no_grad():
        got = infer_parity["model"]._refine(infer_parity["images"], dets,
                                            _t(infer_parity["j"]["depth"]))
    np.testing.assert_array_equal(got["valid"].numpy(), jref["valid"])
    _close(got["soft_masks"], jref["soft_masks"], 1e-6)
    _close(got["plane_params"], jref["plane_params"], 1e-5)
    _close(got["logits"], jref["logits"], 1e-4)
    full = prh.refine_inference_masks(got["logits"][0], got["valid"][0], 64, 96)
    want = jrh.refine_inference_masks(jnp.asarray(jref["logits"][0]),
                                      jnp.asarray(jref["valid"][0]), 64, 96)
    _tie_free_equal(full.numpy(), want)
    assert float(full.sum()) > 100


def test_refined_inference_matches_jax(infer_parity):
    """End to end: the same detections (boxes within 1e-2 px, the gate of
    `tests/test_torch_model.py`), then the refined masks on 99.9 % of the
    pixels and the refined planes within 5e-3 x max |JAX|: boxes a few
    1e-3 px apart move the pasted soft masks' edges by up to 4e-3, which the
    random-weight U-Net carries into its logits (measured 8 of 49152 mask
    pixels and 6e-4 of the planes)."""
    jd, pd = infer_parity["j"]["detections"], infer_parity["p"]["detections"]
    valid = np.asarray(jd.valid[0])
    np.testing.assert_array_equal(pd.valid[0].numpy(), valid)
    assert valid.sum() >= 4
    np.testing.assert_allclose(pd.boxes[0].numpy()[valid], jd.boxes[0][valid], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(pd.scores[0].numpy()[valid], jd.scores[0][valid], rtol=0,
                               atol=1e-4)
    full_j = infer_parity["j"]["full_masks"][0] >= 0.5
    full_p = infer_parity["p"]["full_masks"][0].numpy() >= 0.5
    assert full_p.shape == full_j.shape == (8, 64, 96)
    assert full_j.sum() > 100                    # the refined masks are not empty
    assert (full_p != full_j).mean() <= 1e-3
    _close(pd.planes[0].numpy()[valid], jd.planes[0][valid], 5e-3)


def test_refine_head_gradients_match_jax():
    """The refine head and its loss on identical inputs: the loss within
    1e-6 relative and every parameter's gradient within 1e-4 x max |JAX|
    (measured 2.4e-6)."""
    jc, pc = jcfg.RefineHeadConfig(height=32, width=40), pcfg.RefineHeadConfig(height=32,
                                                                               width=40)
    args = _refine_inputs(np.random.RandomState(8))
    jargs = [jnp.asarray(a) for a in args]
    head = jrh.RefineHead(jc)
    shapes = head.init(jax.random.PRNGKey(0), *jargs)["params"]
    params = _fill_conv_tree(jax.tree_util.tree_map(np.asarray, shapes), np.random.RandomState(9))
    params["refinement_block"]["pred"]["bias"] += np.float32(2.0)
    gt, _ = _masks_pair(np.random.RandomState(5))
    gt_valid = np.asarray([True, True, False])

    def loss(p):
        logits, _ = head.apply({"params": p}, *jargs)
        return jrh.refine_loss_single(logits, jnp.asarray(gt), jnp.asarray(gt_valid),
                                      jargs[1], jargs[4])

    want, grads = jax.jit(jax.value_and_grad(loss))(params)
    jgrad = state_dict_from_jax({"refine_head": _np_tree(grads)}, num_classes=2)
    port = _port_refine_head(pc, params)
    targs = [_t(a) for a in args]
    logits, _ = port(*targs)
    got = prh.refine_loss_single(logits, _t(gt), _t(gt_valid), targs[1], targs[4])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for name, prm in port.named_parameters():
        _close(prm.grad.numpy(), jgrad["refine_head." + name], 1e-4)


# --------------------------------------------------------------------------- #
# DRPN
# --------------------------------------------------------------------------- #

def test_drpn_head_matches_jax():
    """`head_convs=5` at the JAX test's shapes (tests/test_model.py:137-167),
    random features and numpy-drawn weights: the same proposals."""
    cfg_j = jcfg.RPNConfig(head_convs=5, pre_nms_topk_test=16, post_nms_topk_test=16)
    cfg_p = pcfg.RPNConfig(head_convs=5, pre_nms_topk_test=16, post_nms_topk_test=16)
    rs = np.random.RandomState(10)
    sizes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    feats = {f"p{i}": rs.randn(1, h, w, 256).astype(np.float32)
             for i, (h, w) in zip(range(2, 7), sizes)}
    rpn = JaxRPN(cfg_j, jcfg.AnchorConfig())
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    v = rpn.init(jax.random.PRNGKey(0), jfeats, image_height=64, image_width=80)
    params = _fill_conv_tree(jax.tree_util.tree_map(np.asarray, v["params"]), rs)
    want, _ = jax.jit(lambda p, f: rpn.apply({"params": p}, f, image_height=64,
                                             image_width=80))(params, jfeats)
    sd = state_dict_from_jax({"rpn": params}, num_classes=2)
    assert sorted(k for k in sd if ".conv." in k)[0] == "proposal_generator.rpn_head.conv.0.bias"
    port = PortRPN(cfg_p, pcfg.AnchorConfig())
    port.load_state_dict({k[len("proposal_generator."):]: _t(x) for k, x in sd.items()})
    with torch.no_grad():
        got = port({k: _t(x).permute(0, 3, 1, 2) for k, x in feats.items()},
                   image_height=64, image_width=80)
    valid = np.asarray(want["valid"][0])
    np.testing.assert_array_equal(got["valid"][0].numpy(), valid)
    assert valid.sum() >= 8
    np.testing.assert_allclose(got["boxes"][0].numpy()[valid],
                               np.asarray(want["boxes"][0])[valid], rtol=0, atol=1e-3)
    _close(got["scores"][0].numpy()[valid], np.asarray(want["scores"][0])[valid], 1e-5)
