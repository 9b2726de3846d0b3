"""Plain PyTorch PlaneRCNN inference (R50-FPN, RPN, box, mask, plane, axis
and depth heads), written from the published model for judging the port.

It imports nothing of the program and reads nothing the program made: it
takes the benchmark's own state dict (detectron2 key names, see
`portbench/weights.py`) and computes every stage again in float32 with TF32
off, one image at a time.  Sources: the reference PlaneRCNN and detectron2
semantics (FrozenBN, stride_in_1x1, FPN with LastLevelMaxPool, the RPN's
per-level top-k + NMS and global top-k, Fast R-CNN class-wise NMS,
ROIAlign(V2), `paste_masks_in_image`'s grid_sample, the depth decoder of
`modeling/depth_net/depth_head.py` and the plane-offset re-estimation of
`PlaneRCNN_Branch.process`).  A frozen, generalised copy of the repository's
test oracle (`tests/torch_oracle.py`) on the card, batched over ROIs.

`Prec` selects the arithmetic of the convolutions and linear layers:
float32; float8 (e4m3, one scale per tensor, products summed in float32)
for the control that must be judged not correct; or bfloat16 operands,
with which the judge measures how far bfloat16 rounding alone moves the
depth map of a frame (its yardstick for the depth, see `judge.py`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SCALE_CLAMP = math.log(1000.0 / 16.0)
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
FOCAL_EVAL = 571.623718
_STAGES = {2: 3, 3: 4, 4: 6, 5: 3}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Prec:
    """Operand rounding of convolutions and linear layers.  `kind` is
    "float32" (none), "bfloat16" (operands and results rounded to bfloat16,
    products summed in float32, as autocast computes) or "float8" (e4m3
    operands with a per-tensor scale, float32 results)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        if self.kind == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A layer's result: rounded to bfloat16 in that mode, as autocast
        stores it; kept in float32 otherwise."""
        return y.to(torch.bfloat16).to(torch.float32) if self.kind == "bfloat16" else y


F32 = Prec("float32")


class Net:
    """The network's layers over a d2-schema state dict (float32 tensors on
    one device).  `lowp` is the precision of the layers the program runs in
    its compute dtype (trunk, FPN, RPN head, head towers, depth decoder);
    the predictors the program keeps in float32 stay float32."""

    def __init__(self, sd: Dict[str, torch.Tensor], lowp: Prec = F32):
        self.sd = sd
        self.lowp = lowp

    # ---------------------------------------------------------------- layers
    def conv(self, x, key, stride=1, pad=None, bias=True, prec=None):
        w = self.sd[f"{key}.weight"]
        p = (w.shape[-1] - 1) // 2 if pad is None else pad
        pr = prec or self.lowp
        b = self.sd[f"{key}.bias"] if bias else None
        return pr.out(F.conv2d(pr.q(x), pr.q(w), b, stride=stride, padding=p))

    def linear(self, x, key, prec=None):
        pr = prec or self.lowp
        return pr.out(F.linear(pr.q(x), pr.q(self.sd[f"{key}.weight"]), self.sd[f"{key}.bias"]))

    def frozen_bn(self, x, key, eps=1e-5):
        s = self.sd
        scale = s[f"{key}.weight"] * (s[f"{key}.running_var"] + eps).rsqrt()
        shift = s[f"{key}.bias"] - s[f"{key}.running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def conv_norm(self, x, key, stride=1):
        return self.frozen_bn(self.conv(x, key, stride=stride, bias=False), f"{key}.norm")

    # ----------------------------------------------------------------- trunk
    def backbone(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 3, H, W) preprocessed -> {p2..p6} float32 NCHW."""
        pre = "backbone.bottom_up"
        x = F.relu(self.conv_norm(x, f"{pre}.stem.conv1", stride=2))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        res = {}
        for s, blocks in _STAGES.items():
            for b in range(blocks):
                key = f"{pre}.res{s}.{b}"
                stride = 2 if (b == 0 and s > 2) else 1     # stride on the first 1x1
                out = F.relu(self.conv_norm(x, f"{key}.conv1", stride))
                out = F.relu(self.conv_norm(out, f"{key}.conv2"))
                out = self.conv_norm(out, f"{key}.conv3")
                sc = self.conv_norm(x, f"{key}.shortcut", stride) if b == 0 else x
                x = F.relu(out + sc)
            res[s] = x
        lat = {l: self.conv(res[l], f"backbone.fpn_lateral{l}") for l in (2, 3, 4, 5)}
        merged = {5: lat[5]}
        for l in (4, 3, 2):
            up = F.interpolate(merged[l + 1], scale_factor=2, mode="nearest")
            merged[l] = lat[l] + up[:, :, :lat[l].shape[2], :lat[l].shape[3]]
        feats = {f"p{l}": self.conv(merged[l], f"backbone.fpn_output{l}") for l in (2, 3, 4, 5)}
        feats["p6"] = F.max_pool2d(feats["p5"], 1, stride=2)
        return feats

    # ------------------------------------------------------------------- RPN
    def rpn_head(self, feats, scales: Optional[list] = None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per level: logits (B, H*W*A) and deltas (B, H*W*A, 4), (y, x,
        anchor).  With a list `scales`, also appends per level the sums of
        |weight x input| over the terms of each logit (B, H*W*A) and delta
        (B, H*W*A, 4): the scales of their rounding errors."""
        pre = "proposal_generator.rpn_head"
        logits, deltas = [], []
        flat = lambda x, k: x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, k)
        for name in ("p2", "p3", "p4", "p5", "p6"):
            t = F.relu(self.conv(feats[name], f"{pre}.conv"))
            lg = self.conv(t, f"{pre}.objectness_logits")
            dl = self.conv(t, f"{pre}.anchor_deltas")
            logits.append(flat(lg, 1)[..., 0])
            deltas.append(flat(dl, 4))
            if scales is not None:
                w_obj = self.sd[f"{pre}.objectness_logits.weight"].abs()
                w_del = self.sd[f"{pre}.anchor_deltas.weight"].abs()
                scales.append((flat(F.conv2d(t.abs(), w_obj), 1)[..., 0],
                               flat(F.conv2d(t.abs(), w_del), 4)))
        return logits, deltas

    # ----------------------------------------------------------------- heads
    def box_logits(self, pooled: torch.Tensor, scales: Optional[list] = None):
        """(R, 256, 7, 7) -> class logits (R, C+1), deltas (R, C*4); with a
        list `scales`, also appends their rounding scales (sums of |weight x
        input|), shaped alike."""
        x = pooled.flatten(1)
        x = F.relu(self.linear(x, "roi_heads.box_head.fc1"))
        x = F.relu(self.linear(x, "roi_heads.box_head.fc2"))
        pre = "roi_heads.box_predictor"
        if scales is not None:
            scales.append(tuple(x.abs() @ self.sd[f"{pre}.{k}.weight"].abs().t()
                                for k in ("cls_score", "bbox_pred")))
        return (self.linear(x, f"{pre}.cls_score", prec=F32),
                self.linear(x, f"{pre}.bbox_pred", prec=F32))

    def box_head(self, pooled: torch.Tensor):
        """(R, 256, 7, 7) -> class probabilities (R, C+1), deltas (R, C*4)."""
        logits, deltas = self.box_logits(pooled)
        return torch.softmax(logits, -1), deltas

    def mask_logits(self, pooled: torch.Tensor, scales: Optional[list] = None
                    ) -> torch.Tensor:
        """(R, 256, 14, 14) -> mask logits (R, 28, 28); with a list `scales`,
        also appends the sum of |weight x input| of each logit (R, 28, 28)."""
        pre = "roi_heads.mask_head"
        x = pooled
        for i in range(1, 5):
            x = F.relu(self.conv(x, f"{pre}.mask_fcn{i}"))
        q = self.lowp.q
        x = F.relu(self.lowp.out(F.conv_transpose2d(
            q(x), q(self.sd[f"{pre}.deconv.weight"]), self.sd[f"{pre}.deconv.bias"], stride=2)))
        if scales is not None:
            scales.append(F.conv2d(x.abs(), self.sd[f"{pre}.predictor.weight"].abs())[:, 0])
        return self.conv(x, f"{pre}.predictor", prec=F32)[:, 0]

    def _tower(self, x, prefix):
        for i in range(1, 5):
            x = F.relu(self.conv(x, f"{prefix}_conv{i}"))
        return F.relu(self.linear(x.flatten(1), f"{prefix}_fc1"))

    def _scaled(self, x, key, scales):
        if scales is not None:
            scales.append(x.abs() @ self.sd[f"{key}.weight"].abs().t())
        return self.linear(x, key, prec=F32)

    def plane_raw(self, pooled: torch.Tensor, scales: Optional[list] = None) -> torch.Tensor:
        """The plane parameters before the unit normalisation (with a list
        `scales`, their rounding scales are appended)."""
        t = self._tower(pooled, "roi_heads.plane_head.plane")
        return self._scaled(t, "roi_heads.plane_head.param_pred", scales)

    def axis_raw(self, pooled: torch.Tensor, scales: Optional[list] = None):
        """(rotation (R, 2), offset (R, 1), translation (R, 2)) before the
        unit normalisations (with a list `scales`, their rounding scales
        are appended in that order)."""
        pre = "roi_heads.axis_head"
        xr = self._tower(pooled, f"{pre}.axis_R")
        xt = self._tower(pooled, f"{pre}.axis_T")
        return (self._scaled(xr, f"{pre}.rotation", scales),
                self._scaled(xr, f"{pre}.offset", scales),
                self._scaled(xt, f"{pre}.translation", scales))

    # ----------------------------------------------------------------- depth
    def _bn(self, x, key, calib: Optional[Dict[str, torch.Tensor]]):
        """BatchNorm (eps 1e-3) on stored statistics; with `calib` on the
        batch's mean and biased variance, which are stored into `calib`."""
        s = self.sd
        if calib is None:
            mean, var = s[f"{key}.running_mean"], s[f"{key}.running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
            calib[f"{key}.running_mean"], calib[f"{key}.running_var"] = mean, var
        inv = (var + 1e-3).rsqrt() * s[f"{key}.weight"]
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + s[f"{key}.bias"][None, :, None, None]

    def depth(self, feats, out_hw: Tuple[int, int],
              calib: Optional[Dict[str, torch.Tensor]] = None,
              scales: Optional[list] = None) -> torch.Tensor:
        """{p2..p6} -> (B, H_out, W_out) depth in metres; with a list
        `scales`, the rounding scale of the last convolution, resized
        alike, is appended."""
        pre = "depth_head"
        lanes = {}
        for i, name in enumerate(("p6", "p5", "p4", "p3", "p2")):
            x = self.conv(feats[name], f"{pre}.conv{i + 1}.0")
            lanes[name] = F.leaky_relu(self._bn(x, f"{pre}.conv{i + 1}.1", calib), 0.01)

        def deconv(i, x, hw=None):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if hw is not None and tuple(x.shape[2:]) != tuple(hw):
                x = resize(x, hw)
            return F.relu(self._bn(self.conv(x, f"{pre}.deconv{i}.1"), f"{pre}.deconv{i}.2",
                                   calib))

        hw = lambda n: feats[n].shape[2:]
        x = resize(deconv(1, lanes["p6"]), hw("p5"))
        x = deconv(2, torch.cat([lanes["p5"], x], 1), hw("p4"))
        x = deconv(3, torch.cat([lanes["p4"], x], 1), hw("p3"))
        x = deconv(4, torch.cat([lanes["p3"], x], 1), hw("p2"))
        x = deconv(5, torch.cat([lanes["p2"], x], 1))
        if scales is not None:
            scales.append(resize(F.conv2d(x.abs(), self.sd[f"{pre}.depth_pred.weight"].abs(),
                                          padding=1), out_hw)[:, 0])
        x = self.conv(x, f"{pre}.depth_pred", prec=F32)
        return resize(x, out_hw)[:, 0]


def resize(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def unit(v: torch.Tensor) -> torch.Tensor:
    n = v.norm(dim=-1, keepdim=True)
    return torch.where(n > 0, v / n.clamp(min=1e-12), torch.zeros_like(v))


# --------------------------------------------------------------------------- #
# inputs and boxes
# --------------------------------------------------------------------------- #
def preprocess(frames: torch.Tensor, pixel_mean: Sequence[float],
               pixel_std: Sequence[float], divisibility: int = 32) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR -> (B, 3, H', W') float32, normalised and
    zero-padded to a multiple of `divisibility` (frames at the model size)."""
    x = frames.to(torch.float32)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    h, w = x.shape[2:]
    ph, pw = (-h) % divisibility, (-w) % divisibility
    return F.pad(x, (0, pw, 0, ph)) if (ph or pw) else x


def level_anchors(fh: int, fw: int, stride: int, size: float, device) -> torch.Tensor:
    """(fh*fw*3, 4) anchors, (y, x, anchor) order, ratios (0.5, 1, 2), offset 0."""
    cell = []
    for ar in (0.5, 1.0, 2.0):
        w = math.sqrt(size * size / ar)
        h = ar * w
        cell.append([-w / 2, -h / 2, w / 2, h / 2])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)
    sy, sx = torch.meshgrid(torch.arange(fh, device=device, dtype=torch.float32) * stride,
                            torch.arange(fw, device=device, dtype=torch.float32) * stride,
                            indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1)
    return (shifts[:, :, None] + cell[None, None]).reshape(-1, 4)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = (deltas[..., 2] / weights[2]).clamp(max=SCALE_CLAMP)
    dh = (deltas[..., 3] / weights[3]).clamp(max=SCALE_CLAMP)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def clip(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], -1)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS (suppress iou > thresh), kept indices by descending score,
    ties in input order."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(-scores, kind="stable")
    b = boxes[order].astype(np.float64)
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    sup = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0) > thresh
    alive = np.ones(len(b), bool)
    keep = []
    for i in range(len(b)):
        if alive[i]:
            keep.append(i)
            alive &= ~sup[i]
    return order[np.asarray(keep, np.int64)]


def box_levels(boxes: torch.Tensor) -> torch.Tensor:
    """detectron2's FPN level of each box: floor(4 + log2(sqrt(area) / 224)),
    clipped to 2..5."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-8))
    return lvl.clamp(2, 5).to(torch.int64)


def _axis_weights(lo, size, p, grid, n_cells):
    """(R, P, n_cells) ROIAlign weights of one axis: the mean over `grid`
    samples per bin of the bilinear weights (zero outside [-1, n])."""
    r = lo.shape[0]
    bins = size / p
    i = torch.arange(p * grid, device=lo.device, dtype=torch.float32)
    pos = lo[:, None] + (torch.floor(i / grid) + (i % grid + 0.5) / grid) * bins[:, None]
    inside = (pos >= -1.0) & (pos <= n_cells)
    pos = pos.clamp(min=0.0)
    low = torch.floor(pos).to(torch.int64)
    edge = low >= n_cells - 1
    low = torch.where(edge, torch.full_like(low, n_cells - 1), low)
    high = torch.where(edge, low, low + 1)
    pos = torch.where(edge, low.to(pos.dtype), pos)
    frac = pos - low.to(pos.dtype)
    wts = torch.zeros(r, p * grid, n_cells, device=lo.device)
    ok = inside.to(pos.dtype)
    wts.scatter_add_(2, low[..., None], ((1 - frac) * ok)[..., None])
    wts.scatter_add_(2, high[..., None], (frac * ok)[..., None])
    return wts.reshape(r, p, grid, n_cells).sum(2) / grid


def roi_align(feats: Dict[str, torch.Tensor], boxes: torch.Tensor, p: int, ratio: int,
              aligned: bool, chunk: int = 64) -> torch.Tensor:
    """Multilevel ROIAlign of one image: feats {p2..p5} (1, C, H, W), boxes
    (R, 4) -> (R, C, p, p), each ROI from its detectron2 level; `ratio` 0
    samples ceil(size / p) points per bin and axis, uncapped."""
    c = feats["p2"].shape[1]
    out = torch.zeros(boxes.shape[0], c, p, p, device=boxes.device)
    if boxes.shape[0] == 0:
        return out
    levels = box_levels(boxes)
    off = 0.5 if aligned else 0.0
    for lvl in range(2, 6):
        sel = torch.nonzero(levels == lvl).flatten()
        if sel.numel() == 0:
            continue
        f = feats[f"p{lvl}"][0]
        n_y, n_x = f.shape[1], f.shape[2]
        b = boxes[sel] / STRIDES[f"p{lvl}"] - off
        ys, xs = b[:, 3] - b[:, 1], b[:, 2] - b[:, 0]
        if not aligned:
            ys, xs = ys.clamp(min=1.0), xs.clamp(min=1.0)
        if ratio > 0:
            gy = gx = torch.full_like(ys, ratio, dtype=torch.int64)
        else:
            gy = torch.ceil(ys / p).to(torch.int64).clamp(min=1)
            gx = torch.ceil(xs / p).to(torch.int64).clamp(min=1)
        pairs = torch.unique(torch.stack([gy, gx], 1), dim=0).tolist()
        for g_y, g_x in pairs:
            grp = torch.nonzero((gy == g_y) & (gx == g_x)).flatten()
            for s in range(0, grp.numel(), chunk):
                idx = grp[s:s + chunk]
                wy = _axis_weights(b[idx, 1], ys[idx], p, g_y, n_y)
                wx = _axis_weights(b[idx, 0], xs[idx], p, g_x, n_x)
                out[sel[idx]] = torch.einsum("rph,chw,rqw->rcpq", wy, f, wx)
    return out


def paste_soft(masks: torch.Tensor, boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, M, M) soft masks into (N, h, w) at their boxes, bilinear with zero
    padding (`paste_masks_in_image`: grid_sample, align_corners=False)."""
    n = masks.shape[0]
    if n == 0:
        return torch.zeros(0, h, w, device=masks.device)
    dev = masks.device
    y = torch.arange(h, device=dev, dtype=torch.float32) + 0.5
    x = torch.arange(w, device=dev, dtype=torch.float32) + 0.5
    x0, y0, x1, y1 = boxes.unbind(-1)
    gy = (y[None] - y0[:, None]) / (y1 - y0).clamp(min=1e-6)[:, None] * 2 - 1
    gx = (x[None] - x0[:, None]) / (x1 - x0).clamp(min=1e-6)[:, None] * 2 - 1
    grid = torch.stack([gx[:, None, :].expand(n, h, w), gy[:, :, None].expand(n, h, w)], -1)
    return F.grid_sample(masks[:, None], grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)[:, 0]


def eval_rays(h: int, w: int, device) -> torch.Tensor:
    """(3, h, w) back-projection rays of the EVAL intrinsics (focal
    571.623718, principal point (319.5, 239.5))."""
    k = np.array([[FOCAL_EVAL, 0.0, 319.5], [0.0, FOCAL_EVAL, 239.5], [0.0, 0.0, 1.0]])
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    homo = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)], 0)
    return torch.from_numpy((np.linalg.inv(k) @ homo).reshape(3, h, w).astype(np.float32)).to(
        device)


def override_offsets(planes: torch.Tensor, masks: torch.Tensor, depth: torch.Tensor,
                     rays: torch.Tensor) -> torch.Tensor:
    """Stored plane params (N, 3) -> the same normals with the offset taken as
    the mean of n . xyz over each (N, h, w) mask; empty masks keep theirs.
    Stored (a, b, c) is camera (a, -c, b)."""
    cam = torch.stack([planes[:, 0], -planes[:, 2], planes[:, 1]], -1)
    offset = cam.norm(dim=1)
    normal = cam / offset.clamp(min=1e-8)[:, None]
    xyz = rays * depth[None]
    m = masks.to(torch.float32)
    count = m.sum(dim=(1, 2))
    ndotxyz = torch.einsum("dc,chw->dhw", normal, xyz)
    new = normal * ((ndotxyz * m).sum(dim=(1, 2)) / count.clamp(min=1.0))[:, None]
    stored = torch.stack([new[:, 0], new[:, 2], -new[:, 1]], -1)
    return torch.where((count > 0)[:, None], stored, planes)


# --------------------------------------------------------------------------- #
# the whole inference of one frame (the control's path)
# --------------------------------------------------------------------------- #
def infer_frame(net: Net, frame: torch.Tensor, cfg: dict) -> dict:
    """One uint8 (H, W, 3) frame through the whole model: the outputs the
    program returns for it (boxes, scores, classes, bool masks, planes after
    the offset override, rot/tran axes, depth in mm-truncated metres) and
    its proposals (boxes, logits, valid)."""
    h, w = frame.shape[:2]
    m = cfg["model"]
    x = preprocess(frame[None], cfg["input"]["pixel_mean"], cfg["input"]["pixel_std"],
                   cfg["input"]["size_divisibility"])
    feats = net.backbone(x)
    logits, deltas = net.rpn_head(feats)
    props = select_proposals(feats, logits, deltas, h, w, m["rpn"])
    probs, deltas = net.box_head(roi_align(feats, props["boxes"], 7, 0, True))
    dets = select_detections(probs, deltas, props["boxes"], h, w, m["roi_heads"])
    out = cascade(net, feats, dets["boxes"], dets["classes"], h, w)
    depth = net.depth(feats, (h, w))[0]
    masks = out["soft"] >= m["mask_head"]["mask_threshold"]
    planes = override_offsets(out["planes"], masks, depth, eval_rays(h, w, frame.device))
    depth_out = torch.trunc((depth * 1000.0).clamp(0.0, 65535.0)) / 1000.0
    return {"proposals": props, "boxes": dets["boxes"], "scores": dets["scores"],
            "classes": dets["classes"], "masks": masks, "planes": planes,
            "rot_axis": out["rot"], "tran_axis": out["tran"], "depth": depth_out}


def anchors_of(feats) -> List[torch.Tensor]:
    """The anchors of p2..p6 (sizes 32..512)."""
    return [level_anchors(*feats[name].shape[2:], STRIDES[name], 32.0 * 2 ** i,
                          feats[name].device)
            for i, name in enumerate(("p2", "p3", "p4", "p5", "p6"))]


def select_proposals(feats, logits, deltas, h: int, w: int, rpn_cfg: dict) -> dict:
    """detectron2 `find_top_rpn_proposals` for one image, from the RPN
    head's per-level logits (1, n) and deltas (1, n, 4)."""
    pre_k, post_k = rpn_cfg["pre_nms_topk_test"], rpn_cfg["post_nms_topk_test"]
    thresh = rpn_cfg["nms_thresh"]
    boxes_all, scores_all = [], []
    for i, anchors in enumerate(anchors_of(feats)):
        lg = logits[i][0]
        k = min(pre_k, lg.numel())
        idx = torch.sort(-lg, stable=True).indices[:k]
        bx = clip(decode(deltas[i][0][idx], anchors[idx], (1.0, 1.0, 1.0, 1.0)), h, w)
        ok = ((bx[:, 2] > bx[:, 0]) & (bx[:, 3] > bx[:, 1]) & torch.isfinite(bx).all(-1))
        bx, sc = bx[ok], lg[idx][ok]
        keep = torch.from_numpy(nms(bx.cpu().numpy(), sc.cpu().numpy(), thresh)).to(bx.device)
        boxes_all.append(bx[keep])
        scores_all.append(sc[keep])
    boxes = torch.cat(boxes_all)
    scores = torch.cat(scores_all)
    order = torch.sort(-scores, stable=True).indices[:post_k]
    return {"boxes": boxes[order], "logits": scores[order],
            "valid": torch.ones(order.numel(), dtype=torch.bool, device=boxes.device)}


def candidates(probs: torch.Tensor, deltas: torch.Tensor, proposals: torch.Tensor,
               h: int, w: int) -> torch.Tensor:
    """(R, C, 4) class-specific boxes (weights 10, 10, 5, 5), clipped."""
    c = probs.shape[1] - 1
    return clip(decode(deltas.reshape(-1, c, 4), proposals[:, None, :],
                       (10.0, 10.0, 5.0, 5.0)), h, w)


def select_detections(probs, deltas, proposals, h, w, heads_cfg) -> dict:
    """Fast R-CNN inference of one image: score threshold, class-wise NMS,
    the top `detections_per_image` by score."""
    c = probs.shape[1] - 1
    boxes = candidates(probs, deltas, proposals, h, w).reshape(-1, 4)
    scores = probs[:, :c].reshape(-1)
    classes = torch.arange(c, device=probs.device).repeat(proposals.shape[0])
    sel = torch.nonzero(scores > heads_cfg["score_thresh_test"]).flatten()
    b, s, cl = boxes[sel], scores[sel], classes[sel]
    if sel.numel():
        off = (b.max() + 1.0) * cl.to(torch.float32)
        keep = nms((b + off[:, None]).cpu().numpy(), s.cpu().numpy(), heads_cfg["nms_thresh_test"])
        keep = torch.from_numpy(keep[:heads_cfg["detections_per_image"]]).to(b.device)
        b, s, cl = b[keep], s[keep], cl[keep]
    return {"boxes": b, "scores": s, "classes": cl}


def cascade(net: Net, feats, boxes: torch.Tensor, classes: torch.Tensor, h: int,
            w: int) -> dict:
    """Mask, plane and axis heads at `boxes`: soft masks pasted at (h, w),
    unit plane normals, rot (sin, cos, offset) and tran axes, the raw
    vectors before their normalisation, and the rounding scales (sums of
    |weight x input|) of the mask logits (pasted as the masks are), the
    plane parameters and the rotation, offset and translation outputs."""
    mp = roi_align(feats, boxes, 14, 2, False)
    pp = roi_align(feats, boxes, 14, 0, False)
    ms, ps, axs = [], [], []
    logits = net.mask_logits(mp, ms)
    plane = net.plane_raw(pp, ps)
    r, o, t = net.axis_raw(pp, axs)
    return {"soft": paste_soft(torch.sigmoid(logits), boxes, h, w),
            "mask_scale": paste_soft(ms[0], boxes, h, w),
            "planes": unit(plane), "plane_raw": plane, "plane_scale": ps[0],
            "rot": torch.cat([unit(r), o], -1), "rot_raw": r, "tran": unit(t), "tran_raw": t,
            "axis_scales": axs}
