"""Weights in the detectron2 checkpoint schema.

The port's parameter names ARE the d2 state-dict keys, so a released
`model_final.pth` loads with `load_state_dict`.  This module holds:

  * `d2_key_shapes`: every key and shape of the PlaneRCNN R50-FPN
    checkpoint (mask, plane, axis and depth heads), with the refine head
    (`refine_head.refinement_block.*`, keys of the port's own: no released
    checkpoint carries them) and the DRPN's conv stack
    (`proposal_generator.rpn_head.conv.{i}`) where the config has them
    (`schema_options`);
  * `random_state_dict`: seeded He-style weights in that schema (the same
    draws as the test oracle's `he_state_dict`), for runs without a
    checkpoint, and `bias_for_detections`, which lifts their RPN objectness
    and foreground class logits so that detections survive scoring (the
    weights of the committed oracle fixtures `golden_oracle_biased_*`);
  * `load_d2_state_dict` / `load_torch_state_dict`: loading with a check
    that only `num_batches_tracked`, anchor buffers and the pixel
    statistics may be missing or unexpected;
  * `warm_start`: d2's shape-tolerant warm start for training stages;
  * `state_dict_from_jax`: the JAX package's parameters -> this schema, the
    inverse of its checkpoint porter (`train/checkpoint.py::_map_name`,
    `_convert`), kept here as the port's own copy.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# first-FC spatial shapes (H, W, C) of the pooled map feeding the fc
_FC_SHAPES = {
    ("box_head", "fc1"): (7, 7, 256),
    ("plane_head", "tower", "plane_fc1"): (14, 14, 256),
    ("axis_head", "tower_R", "axis_R_fc1"): (14, 14, 256),
    ("axis_head", "tower_T", "axis_T_fc1"): (14, 14, 256),
}
# torch BatchNorm entry -> (JAX collection, leaf) of flax BatchNorm
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


# the refine head's conv blocks: (d2 name, in, out, kernel, kind, flax path
# under refine_head/refinement_block); "pred.1" and "global_pred.1" are
# plain convs, the others hold theirs as `.conv`
_REFINE = (
    ("conv_0", 9, 32, 3, "conv", ("ConvBlock_0", "Conv_0")),
    ("conv_1", 64, 64, 3, "conv", ("ConvBlock_1", "Conv_0")),
    ("conv_1_1", 128, 64, 3, "conv", ("ConvBlock_2", "Conv_0")),
    ("conv_2", 128, 128, 3, "conv", ("ConvBlock_3", "Conv_0")),
    ("conv_2_1", 256, 128, 3, "conv", ("ConvBlock_4", "Conv_0")),
    ("up_2", 128, 64, 4, "deconv", ("ConvBlock_5", "ConvTranspose_0")),
    ("up_1", 128, 32, 4, "deconv", ("ConvBlock_6", "ConvTranspose_0")),
    ("pred.0", 64, 16, 3, "conv", ("ConvBlock_7", "Conv_0")),
    ("pred.1", 16, 1, 3, "conv", ("pred",)),
    ("global_up_2", 128, 64, 4, "deconv", ("global_up_2", "ConvTranspose_0")),
    ("global_up_1", 128, 32, 4, "deconv", ("global_up_1", "ConvTranspose_0")),
    ("global_pred.0", 64, 16, 3, "conv", ("global_pred_conv", "Conv_0")),
    ("global_pred.1", 16, 1, 3, "conv", ("global_pred",)),
)


def _refine_key(name: str) -> str:
    leaf = "" if name.endswith(".1") else ".conv"
    return f"refine_head.refinement_block.{name}{leaf}"


def schema_options(model_cfg) -> Dict[str, Any]:
    """The `d2_key_shapes` / `random_state_dict` options a model config
    needs: {} for the shipped heads, else refine=True and/or rpn_convs."""
    opts: Dict[str, Any] = {}
    if model_cfg.refine_on:
        opts["refine"] = True
    if model_cfg.rpn.head_convs != 1:
        opts["rpn_convs"] = int(model_cfg.rpn.head_convs)
    return opts


def d2_key_shapes(num_classes: int = 2, refine: bool = False,
                  rpn_convs: int = 1) -> Dict[str, tuple]:
    """{d2 state-dict key: shape} of PlaneRCNN R50-FPN with mask, plane,
    axis and depth heads; with `refine`, the refine head's keys at the end;
    with `rpn_convs` > 1, the DRPN's stack `rpn_head.conv.{i}` in place of
    `rpn_head.conv`."""
    shapes: Dict[str, tuple] = {}

    def conv(key, o, i, k):
        shapes[f"{key}.weight"] = (o, i, k, k)

    def convb(key, o, i, k):
        conv(key, o, i, k)
        shapes[f"{key}.bias"] = (o,)

    def frozen_bn(key, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{s}"] = (c,)

    def torch_bn(key, c):
        frozen_bn(key, c)
        shapes[f"{key}.num_batches_tracked"] = ()

    def linear(key, o, i):
        shapes[f"{key}.weight"] = (o, i)
        shapes[f"{key}.bias"] = (o,)

    conv("backbone.bottom_up.stem.conv1", 64, 3, 7)
    frozen_bn("backbone.bottom_up.stem.conv1.norm", 64)
    stage_spec = {2: (3, 64, 64), 3: (4, 128, 256), 4: (6, 256, 512), 5: (3, 512, 1024)}
    for s, (blocks, width, cin) in stage_spec.items():
        out = width * 4
        for b in range(blocks):
            base = f"backbone.bottom_up.res{s}.{b}"
            bin_ = cin if b == 0 else out
            if b == 0:
                conv(f"{base}.shortcut", out, bin_, 1)
                frozen_bn(f"{base}.shortcut.norm", out)
            conv(f"{base}.conv1", width, bin_, 1)
            frozen_bn(f"{base}.conv1.norm", width)
            conv(f"{base}.conv2", width, width, 3)
            frozen_bn(f"{base}.conv2.norm", width)
            conv(f"{base}.conv3", out, width, 1)
            frozen_bn(f"{base}.conv3.norm", out)
    for lvl, cin in ((2, 256), (3, 512), (4, 1024), (5, 2048)):
        convb(f"backbone.fpn_lateral{lvl}", 256, cin, 1)
        convb(f"backbone.fpn_output{lvl}", 256, 256, 3)
    convb("proposal_generator.rpn_head.conv", 256, 256, 3)
    convb("proposal_generator.rpn_head.objectness_logits", 3, 256, 1)
    convb("proposal_generator.rpn_head.anchor_deltas", 12, 256, 1)
    linear("roi_heads.box_head.fc1", 1024, 256 * 7 * 7)
    linear("roi_heads.box_head.fc2", 1024, 1024)
    linear("roi_heads.box_predictor.cls_score", num_classes + 1, 1024)
    linear("roi_heads.box_predictor.bbox_pred", num_classes * 4, 1024)
    for i in range(1, 5):
        convb(f"roi_heads.mask_head.mask_fcn{i}", 256, 256, 3)
    shapes["roi_heads.mask_head.deconv.weight"] = (256, 256, 2, 2)
    shapes["roi_heads.mask_head.deconv.bias"] = (256,)
    convb("roi_heads.mask_head.predictor", 1, 256, 1)
    for i in range(1, 5):
        convb(f"roi_heads.plane_head.plane_conv{i}", 256, 256, 3)
    linear("roi_heads.plane_head.plane_fc1", 1024, 256 * 14 * 14)
    linear("roi_heads.plane_head.param_pred", 3, 1024)
    for rt in ("R", "T"):
        for i in range(1, 5):
            convb(f"roi_heads.axis_head.axis_{rt}_conv{i}", 256, 256, 3)
        linear(f"roi_heads.axis_head.axis_{rt}_fc1", 1024, 256 * 14 * 14)
    linear("roi_heads.axis_head.rotation", 2, 1024)
    linear("roi_heads.axis_head.offset", 1, 1024)
    linear("roi_heads.axis_head.translation", 2, 1024)
    for i in range(1, 6):
        convb(f"depth_head.conv{i}.0", 128, 256, 3)
        torch_bn(f"depth_head.conv{i}.1", 128)
    for i, (cin, cout) in {1: (128, 128), 2: (256, 128), 3: (256, 128),
                           4: (256, 128), 5: (256, 64)}.items():
        convb(f"depth_head.deconv{i}.1", cout, cin, 3)
        torch_bn(f"depth_head.deconv{i}.2", cout)
    convb("depth_head.depth_pred", 1, 64, 3)
    for i in range(5):
        shapes[f"proposal_generator.anchor_generator.cell_anchors.{i}"] = (3, 4)
    shapes.update(_extra_key_shapes(refine, rpn_convs))
    if rpn_convs > 1:
        for s in ("weight", "bias"):
            del shapes[f"proposal_generator.rpn_head.conv.{s}"]
    return shapes


def _extra_key_shapes(refine: bool, rpn_convs: int) -> Dict[str, tuple]:
    """The DRPN's and the refine head's keys."""
    shapes: Dict[str, tuple] = {}
    if rpn_convs > 1:
        for i in range(rpn_convs):
            shapes[f"proposal_generator.rpn_head.conv.{i}.weight"] = (256, 256, 3, 3)
            shapes[f"proposal_generator.rpn_head.conv.{i}.bias"] = (256,)
    if refine:
        for name, cin, cout, k, kind, _ in _REFINE:
            key = _refine_key(name)
            shapes[f"{key}.weight"] = (cin, cout, k, k) if kind == "deconv" else (cout, cin, k, k)
            shapes[f"{key}.bias"] = (cout,)
    return shapes


def random_state_dict(seed: int = 0, refine: bool = False,
                      rpn_convs: int = 1) -> Dict[str, np.ndarray]:
    """Seeded He-style weights in the d2 schema, activations O(1) through
    the trunk.  Box deltas and class logits are damped so boxes stay on the
    image and scores do not saturate; depth-head convs are damped so the
    decoder (running on random BN statistics) stays O(1).  The 208 M draws
    of a seed are made once per process; each call returns fresh copies.
    The DRPN's and the refine head's keys (`schema_options`) are drawn
    from a second stream, `RandomState([seed, 1])`, so the shipped keys
    keep their values."""
    out = {k: v.copy() for k, v in _random_arrays(seed).items()}
    extra = _extra_key_shapes(refine, rpn_convs)
    if extra:
        rs = np.random.RandomState([seed, 1])
        out.update({k: _draw(rs, k, s) for k, s in extra.items()})
    if rpn_convs > 1:
        for s in ("weight", "bias"):
            del out[f"proposal_generator.rpn_head.conv.{s}"]
    return out


@functools.lru_cache(maxsize=2)
def _random_arrays(seed: int) -> Dict[str, np.ndarray]:
    rs = np.random.RandomState(seed)
    return {k: _draw(rs, k, s) for k, s in d2_key_shapes().items()}


def _is_deconv(key: str) -> bool:
    """A ConvTranspose weight (in, out, k, k) outside the depth head."""
    return (("deconv" in key and "depth_head" not in key)
            or bool(re.fullmatch(r"refine_head\.refinement_block\.(global_)?up_\d\.conv\.weight",
                                 key)))


def _draw(rs: np.random.RandomState, k: str, s: tuple) -> np.ndarray:
    """One key's seeded draw (the rules of `random_state_dict`)."""
    if k.endswith("running_var"):
        v = rs.uniform(0.5, 1.5, s).astype(np.float32)
    elif k.endswith("running_mean"):
        v = (rs.randn(*s) * 0.1).astype(np.float32)
    elif ".norm.weight" in k or (k.endswith(".1.weight") and "depth_head" in k) \
            or (k.endswith(".2.weight") and "depth_head" in k):
        v = rs.uniform(0.6, 1.1, s).astype(np.float32)
    elif k.endswith("num_batches_tracked"):
        v = np.zeros(s, np.int64)
    elif k.endswith(".bias") or ".norm.bias" in k:
        v = (rs.randn(*s) * 0.05).astype(np.float32)
    elif len(s) == 4:
        fan_in = s[1] * s[2] * s[3]
        if _is_deconv(k):
            fan_in = s[0] * s[2] * s[3]     # ConvTranspose (in, out, k, k)
        v = (rs.randn(*s) * 0.8 * np.sqrt(2.0 / fan_in)).astype(np.float32)
    elif len(s) == 2:
        v = (rs.randn(*s) * np.sqrt(2.0 / s[1])).astype(np.float32)
    else:
        v = rs.randn(*s).astype(np.float32)
    if "anchor_deltas" in k:
        v = (v * 0.02).astype(np.float32)
    elif "bbox_pred" in k or "cls_score" in k:
        v = (v * 0.002).astype(np.float32)
    elif "depth_head" in k and len(s) == 4:
        v = (v * 0.1).astype(np.float32)
    return v


def bias_for_detections(sd: Mapping[str, np.ndarray], objectness: float = 4.0,
                        foreground: float = 6.0) -> Dict[str, np.ndarray]:
    """A copy of `sd` with `objectness` added to the RPN's objectness bias
    and `foreground` to every class logit's bias but the background's (the
    last), so a population of proposals and detections survives scoring
    and NMS."""
    out = dict(sd)
    k_obj = "proposal_generator.rpn_head.objectness_logits.bias"
    k_cls = "roi_heads.box_predictor.cls_score.bias"
    out[k_obj] = (np.asarray(sd[k_obj]) + objectness).astype(np.float32)
    cls = np.array(sd[k_cls], np.float32)
    cls[:-1] += foreground
    out[k_cls] = cls
    return out


def _ignorable(key: str) -> bool:
    return (key.endswith("num_batches_tracked") or ".anchor_generator." in key
            or key in ("pixel_mean", "pixel_std"))


def load_d2_state_dict(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> None:
    """Load a d2-schema state dict (numpy arrays or tensors).  Raises if a
    key other than num_batches_tracked / anchor buffers / pixel statistics
    is missing or unexpected."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in list(missing) + list(unexpected) if not _ignorable(k)]
    if bad:
        raise KeyError(f"state dict does not match the model: {bad[:10]}")


def warm_start(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> Dict[str, list]:
    """d2's warm start (`DetectionCheckpointer` without resume): keys the
    model has with the same shape load; the model's other keys keep their
    values (a head the checkpoint lacks); checkpoint keys the model lacks or
    whose shape differs are skipped.  Returns the key lists."""
    own = model.state_dict()
    stats: Dict[str, list] = {"loaded": [], "missing": [], "unexpected": [],
                              "shape_mismatch": []}
    load = {}
    for k, v in state_dict.items():
        v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if k not in own:
            stats["unexpected"].append(k)
        elif tuple(own[k].shape) != tuple(v.shape):
            stats["shape_mismatch"].append(k)
        else:
            load[k] = v
            stats["loaded"].append(k)
    stats["missing"] = [k for k in own if k not in load]
    model.load_state_dict(load, strict=False)
    return stats


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a d2 checkpoint (.pth via torch.load, .pkl via pickle) as
    {key: numpy array}; a top-level {"model": ...} wrapper is unwrapped."""
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict) and "model" in data:
        data = data["model"]
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in data.items()}


# --------------------------------------------------------------------------- #
# JAX parameters -> d2 schema
# --------------------------------------------------------------------------- #

def _jax_path(key: str) -> Optional[Tuple[Tuple[str, ...], str]]:
    """d2 key -> (JAX parameter path, kind), kind in {conv, deconv, linear,
    bias, frozen_bn, torch_bn}; None for keys without a JAX parameter."""
    last = key.rsplit(".", 1)[-1]
    wb = lambda kind: ("kernel", kind) if last == "weight" else ("bias", "bias")

    m = re.fullmatch(r"backbone\.bottom_up\.stem\.conv1\.(weight|norm\.(\w+))", key)
    if m:
        if m.group(2):
            return ("backbone", "stem", "norm", m.group(2)), "frozen_bn"
        return ("backbone", "stem", "conv", "kernel"), "conv"
    m = re.fullmatch(r"backbone\.bottom_up\.res(\d)\.(\d+)\.(conv\d|shortcut)\.(weight|norm\.(\w+))", key)
    if m:
        base = ("backbone", f"res{m.group(1)}_{m.group(2)}", m.group(3))
        if m.group(5):
            return base + ("norm", m.group(5)), "frozen_bn"
        return base + ("conv", "kernel"), "conv"
    m = re.fullmatch(r"backbone\.fpn_(lateral|output)(\d)\.(weight|bias)", key)
    if m:
        name = f"lateral_res{m.group(2)}" if m.group(1) == "lateral" else f"output_p{m.group(2)}"
        leaf, kind = wb("conv")
        return ("fpn", name, leaf), kind
    m = re.fullmatch(r"proposal_generator\.rpn_head\.conv\.(\d+)\.(weight|bias)", key)
    if m:   # the DRPN's stack (JAX train/checkpoint.py:215-221)
        leaf, kind = wb("conv")
        return ("rpn", "head", f"conv_{m.group(1)}", leaf), kind
    m = re.fullmatch(r"refine_head\.refinement_block\.([\w.]+?)(?:\.conv)?\.(weight|bias)", key)
    if m:
        name = m.group(1)
        blk = next(b for b in _REFINE if b[0] == name)
        leaf, kind = wb(blk[4])
        return ("refine_head", "refinement_block") + blk[5] + (leaf,), kind
    m = re.fullmatch(r"proposal_generator\.rpn_head\.(conv|objectness_logits|anchor_deltas)\.(weight|bias)", key)
    if m:
        leaf, kind = wb("conv")
        return ("rpn", "head", m.group(1), leaf), kind
    m = re.fullmatch(r"roi_heads\.(box_head|box_predictor)\.(fc\d|cls_score|bbox_pred)\.(weight|bias)", key)
    if m:
        leaf, kind = wb("linear")
        return ("box_head", m.group(2), leaf), kind
    m = re.fullmatch(r"roi_heads\.mask_head\.(mask_fcn\d|deconv|predictor)\.(weight|bias)", key)
    if m:
        leaf, kind = wb("deconv" if m.group(1) == "deconv" else "conv")
        return ("mask_head", m.group(1), leaf), kind
    m = re.fullmatch(r"roi_heads\.plane_head\.(plane_(?:conv|fc)\d|param_pred)\.(weight|bias)", key)
    if m:
        mod = m.group(1)
        leaf, kind = wb("conv" if "conv" in mod else "linear")
        path = ("plane_head", mod) if mod == "param_pred" else ("plane_head", "tower", mod)
        return path + (leaf,), kind
    m = re.fullmatch(r"roi_heads\.axis_head\.(axis_([RT])_(conv|fc)\d|rotation|offset|translation)\.(weight|bias)", key)
    if m:
        mod = m.group(1)
        leaf, kind = wb("conv" if m.group(3) == "conv" else "linear")
        path = ("axis_head", f"tower_{m.group(2)}", mod) if m.group(2) else ("axis_head", mod)
        return path + (leaf,), kind
    m = re.fullmatch(r"depth_head\.(conv(\d)\.0|deconv(\d)\.1|depth_pred)\.(weight|bias)", key)
    if m:
        mod = ((f"conv{m.group(2)}", "conv") if m.group(2)
               else (f"deconv{m.group(3)}_conv",) if m.group(3) else ("depth_pred",))
        leaf, kind = wb("conv")
        return ("depth_head",) + mod + (leaf,), kind
    m = re.fullmatch(r"depth_head\.(conv(\d)\.1|deconv(\d)\.2)\.(weight|bias|running_mean|running_var)", key)
    if m:
        mod = (f"conv{m.group(2)}", "bn") if m.group(2) else (f"deconv{m.group(3)}_bn",)
        return ("depth_head",) + mod + (m.group(4),), "torch_bn"
    return None


def _get(tree: Mapping, path: Tuple[str, ...]):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return np.asarray(node)


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                        num_classes: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The JAX package's (params, batch_stats) -> d2-schema state dict.

    Inverts `train/checkpoint.py::_convert`: conv HWIO -> OIHW; deconv
    (flax ConvTranspose, HW in out) flipped in both spatial axes, then
    transposed to torch's (in, out, H, W); linear transposed, with the first-FC
    (H*W*C, O) kernels reordered to d2's (O, C*H*W); FrozenBN as is; depth
    BN scale/bias from `params` and mean/var from `batch_stats`.  Keys whose
    module the JAX model does not have (a head switched off) are left out.
    """
    batch_stats = batch_stats or {}
    if num_classes is None:
        num_classes = int(_get(params, ("box_head", "cls_score", "kernel")).shape[1]) - 1
    head = params.get("rpn", {}).get("head", {})
    rpn_convs = sum(1 for k in head if re.fullmatch(r"conv_\d+", k)) or 1
    out: Dict[str, np.ndarray] = {}
    for key in d2_key_shapes(num_classes, refine="refine_head" in params,
                             rpn_convs=rpn_convs):
        mapped = _jax_path(key)
        if mapped is None:
            continue
        path, kind = mapped
        if kind == "torch_bn":
            tree, leaf = _BN_LEAVES[path[-1]]
            v = _get(params if tree == "params" else batch_stats, path[:-1] + (leaf,))
        else:
            v = _get(params, path)
        if v is None:
            continue
        if kind == "conv":
            v = v.transpose(3, 2, 0, 1)
        elif kind == "deconv":
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        elif kind == "linear":
            shape = next((s for pre, s in _FC_SHAPES.items()
                          if path[:len(pre)] == pre), None)
            if shape is None:
                v = v.T
            else:
                h, w, c = shape
                o = v.shape[1]
                v = v.T.reshape(o, h, w, c).transpose(0, 3, 1, 2).reshape(o, -1)
        out[key] = np.array(v, dtype=np.float32, order="C")
    return out
