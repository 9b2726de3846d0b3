"""Seeded random weights of PlaneRCNN R50-FPN, drawn on the device.

Frozen copies of the repository's weight rules, drawn from a
`torch.Generator` on the device in two large calls (one normal, one
uniform) instead of 208 M host draws:

  * the schema and the draw of every key: `articulation3d_tpu_torch/
    weights.py::d2_key_shapes` (84-169) and `_draw` (220-248): BatchNorm
    variance U(0.5, 1.5), mean N(0, 0.1^2), scale U(0.6, 1.1), biases
    N(0, 0.05^2), convolutions 0.8 * sqrt(2 / fan_in) * N(0, 1), linear
    layers sqrt(2 / fan_in) * N(0, 1); RPN deltas x0.02, box predictor
    x0.002, depth-head convolutions x0.1;
  * the serving damping of the RPN deltas, x0.01 (`chip_smoke.py::
    _serving_weights`, 2124-2141);
  * the detection bias (`weights.py::bias_for_detections`, 251-264): the
    objectness bias lifted by `objectness_bias`; the class logits' biases
    set so that, on the first frames' proposals under the plain reference,
    each foreground class's median logit lies `class_margin` above the
    background's (a fixed lift, as the repository's, leaves the scores to
    the seed: the box head's all-positive features give each class logit a
    common offset of about +-0.7 that changes from seed to seed, and the
    detections per frame then range from 8 to 100);
  * the depth decoder's output moved by `depth_bias` metres (its bias);
  * the depth BatchNorm statistics set from the first frames
    (`chip_smoke.py::_calibrate_depth_bn`, 2143-2164): computed here by the
    plain reference in float32 on the benchmark's own frames.

The same seed gives the same tensors on the same device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_STAGES = {2: (3, 64, 64), 3: (4, 128, 256), 4: (6, 256, 512), 5: (3, 512, 1024)}
_DECONV = {1: (128, 128), 2: (256, 128), 3: (256, 128), 4: (256, 128), 5: (256, 64)}


def key_shapes(num_classes: int = 2) -> Dict[str, Tuple[int, ...]]:
    """{detectron2 key: shape} of PlaneRCNN R50-FPN with mask, plane, axis
    and depth heads, in the checkpoint's order."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(key, o, i, k, bias=False):
        shapes[f"{key}.weight"] = (o, i, k, k)
        if bias:
            shapes[f"{key}.bias"] = (o,)

    def bn(key, c, tracked=False):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{s}"] = (c,)
        if tracked:
            shapes[f"{key}.num_batches_tracked"] = ()

    def linear(key, o, i):
        shapes[f"{key}.weight"] = (o, i)
        shapes[f"{key}.bias"] = (o,)

    conv("backbone.bottom_up.stem.conv1", 64, 3, 7)
    bn("backbone.bottom_up.stem.conv1.norm", 64)
    for s, (blocks, width, cin) in _STAGES.items():
        out = width * 4
        for b in range(blocks):
            base = f"backbone.bottom_up.res{s}.{b}"
            bin_ = cin if b == 0 else out
            if b == 0:
                conv(f"{base}.shortcut", out, bin_, 1)
                bn(f"{base}.shortcut.norm", out)
            conv(f"{base}.conv1", width, bin_, 1)
            bn(f"{base}.conv1.norm", width)
            conv(f"{base}.conv2", width, width, 3)
            bn(f"{base}.conv2.norm", width)
            conv(f"{base}.conv3", out, width, 1)
            bn(f"{base}.conv3.norm", out)
    for lvl, cin in ((2, 256), (3, 512), (4, 1024), (5, 2048)):
        conv(f"backbone.fpn_lateral{lvl}", 256, cin, 1, True)
        conv(f"backbone.fpn_output{lvl}", 256, 256, 3, True)
    conv("proposal_generator.rpn_head.conv", 256, 256, 3, True)
    conv("proposal_generator.rpn_head.objectness_logits", 3, 256, 1, True)
    conv("proposal_generator.rpn_head.anchor_deltas", 12, 256, 1, True)
    linear("roi_heads.box_head.fc1", 1024, 256 * 7 * 7)
    linear("roi_heads.box_head.fc2", 1024, 1024)
    linear("roi_heads.box_predictor.cls_score", num_classes + 1, 1024)
    linear("roi_heads.box_predictor.bbox_pred", num_classes * 4, 1024)
    for i in range(1, 5):
        conv(f"roi_heads.mask_head.mask_fcn{i}", 256, 256, 3, True)
    shapes["roi_heads.mask_head.deconv.weight"] = (256, 256, 2, 2)
    shapes["roi_heads.mask_head.deconv.bias"] = (256,)
    conv("roi_heads.mask_head.predictor", 1, 256, 1, True)
    for i in range(1, 5):
        conv(f"roi_heads.plane_head.plane_conv{i}", 256, 256, 3, True)
    linear("roi_heads.plane_head.plane_fc1", 1024, 256 * 14 * 14)
    linear("roi_heads.plane_head.param_pred", 3, 1024)
    for rt in ("R", "T"):
        for i in range(1, 5):
            conv(f"roi_heads.axis_head.axis_{rt}_conv{i}", 256, 256, 3, True)
        linear(f"roi_heads.axis_head.axis_{rt}_fc1", 1024, 256 * 14 * 14)
    linear("roi_heads.axis_head.rotation", 2, 1024)
    linear("roi_heads.axis_head.offset", 1, 1024)
    linear("roi_heads.axis_head.translation", 2, 1024)
    for i in range(1, 6):
        conv(f"depth_head.conv{i}.0", 128, 256, 3, True)
        bn(f"depth_head.conv{i}.1", 128, tracked=True)
    for i, (cin, cout) in _DECONV.items():
        conv(f"depth_head.deconv{i}.1", cout, cin, 3, True)
        bn(f"depth_head.deconv{i}.2", cout, tracked=True)
    conv("depth_head.depth_pred", 1, 64, 3, True)
    return shapes


def _rule(k: str, s: Tuple[int, ...]):
    """(kind, a, b) of one key: "uniform" on [a, b), "normal" a * N(0, 1) + b,
    or "zeros"; damping included."""
    if k.endswith("num_batches_tracked"):
        return "zeros", 0.0, 0.0
    if k.endswith("running_var"):
        return "uniform", 0.5, 1.5
    if k.endswith("running_mean"):
        return "normal", 0.1, 0.0
    if ".norm.weight" in k or ("depth_head" in k and (k.endswith(".1.weight")
                                                      or k.endswith(".2.weight"))):
        # as in the repository's rule, this also takes the depth decoder's
        # 3x3 weights `deconv{i}.1.weight`, which the x0.1 damping then scales
        f = 0.1 if len(s) == 4 else 1.0
        return "uniform", 0.6 * f, 1.1 * f
    if k.endswith(".bias"):
        std = 0.05
    elif len(s) == 4:
        fan_in = s[1] * s[2] * s[3]
        if "deconv" in k and "depth_head" not in k:
            fan_in = s[0] * s[2] * s[3]             # ConvTranspose (in, out, k, k)
        std = 0.8 * (2.0 / fan_in) ** 0.5
    else:
        std = (2.0 / s[1]) ** 0.5
    if "anchor_deltas" in k:
        std *= 0.02
    elif "bbox_pred" in k or "cls_score" in k:
        std *= 0.002
    elif "depth_head" in k and len(s) == 4:
        std *= 0.1
    return "normal", std, 0.0


def _numel(s) -> int:
    n = 1
    for d in s:
        n *= int(d)
    return n


def draw(seed: int, device, *, rpn_delta_scale: float, objectness_bias: float,
         depth_bias: float = 0.0, num_classes: int = 2) -> Dict[str, torch.Tensor]:
    """The state dict of `seed` on `device` (float32; num_batches_tracked
    int64).  The depth BatchNorms' statistics and the class biases are the
    drawn ones until `calibrate` sets them."""
    shapes = key_shapes(num_classes)
    rules = {k: _rule(k, s) for k, s in shapes.items()}
    n_normal = sum(_numel(shapes[k]) for k, r in rules.items() if r[0] == "normal")
    n_uniform = sum(_numel(shapes[k]) for k, r in rules.items() if r[0] == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = {"normal": 0, "uniform": 0}
    for k, s in shapes.items():
        kind, a, b = rules[k]
        if kind == "zeros":
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
            continue
        n = _numel(s)
        src = normal if kind == "normal" else uniform
        v = src[at[kind]:at[kind] + n].view(s)
        at[kind] += n
        out[k] = v * a + b if kind == "normal" else a + (b - a) * v
    for k in ("weight", "bias"):
        out[f"proposal_generator.rpn_head.anchor_deltas.{k}"] *= rpn_delta_scale
    out["proposal_generator.rpn_head.objectness_logits.bias"] += objectness_bias
    out["depth_head.depth_pred.bias"] += depth_bias
    return out


def draw_for(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """`draw` with the rule parameters of a configuration file's
    "weights" entry."""
    w = config["weights"]
    return draw(seed, device, rpn_delta_scale=w["rpn_delta_scale"],
                objectness_bias=w["objectness_bias"], depth_bias=w["depth_bias"],
                num_classes=len(w["class_margin"]))


@torch.no_grad()
def calibrate(sd: Dict[str, torch.Tensor], frames: torch.Tensor,
              config: dict) -> Dict[str, torch.Tensor]:
    """Set, in `sd`, the depth decoder's BatchNorm statistics to the batch
    statistics (mean, biased variance) of uint8 `frames` (B, H, W, 3) under
    the plain float32 reference, one train-mode pass; and the class logits'
    biases so that on the first two frames' proposals each foreground
    class's median logit lies the configuration's `class_margin` above the
    background's.  Returns the entries set."""
    from .reference import planercnn as ref
    net = ref.Net(sd)
    cfg = config["config"]
    inp = cfg["input"]
    h, w = frames.shape[1:3]
    out: Dict[str, torch.Tensor] = {}
    with ref.exact_float32():
        x = ref.preprocess(frames, inp["pixel_mean"], inp["pixel_std"],
                           inp["size_divisibility"])
        feats = net.backbone(x)
        net.depth(feats, (h, w), calib=out)
        sd.update(out)
        logits = []
        for i in range(min(2, frames.shape[0])):
            fi = {k: v[i:i + 1] for k, v in feats.items()}
            lg, dl = net.rpn_head(fi)
            props = ref.select_proposals(fi, lg, dl, h, w, cfg["model"]["rpn"])
            logits.append(net.box_logits(ref.roi_align(fi, props["boxes"], 7, 0, True))[0])
        med = torch.cat(logits).median(dim=0).values
    key = "roi_heads.box_predictor.cls_score.bias"
    margin = torch.tensor(config["weights"]["class_margin"], dtype=torch.float32,
                          device=med.device)
    bias = sd[key].clone()
    bias[:-1] += margin - (med[:-1] - med[-1])
    sd[key] = bias
    out[key] = bias
    return out
