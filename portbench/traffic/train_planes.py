"""Training batches for the stage-3 cells: a pool of batches drawn from the
seed on the device, in the `train_step` batch contract with the plane
fields (uint8 BGR images; GT boxes, classes and valid flags padded to the
trainer's `max_instances`; the GT masks bit-packed along the width as
`gt_masks_packed`; `gt_planes`; `gt_depth_mm`), which the training loop
cycles through.

Each image holds planes painted in order, later ones over earlier ones:
each an axis-aligned rectangle whose mask is what stays visible of it,
whose box is that mask's tight extent, and which is dropped when fewer
than `min_visible` x `min_visible` of its pixels stay visible.  Every
class is 0 (ScanNet's "plane").  A plane's parameters are a unit normal
drawn uniformly on the hemisphere facing the camera (the stored second
component, the camera's depth axis, positive: n . X = offset > 0 on the
plane) times an offset drawn uniformly.  The depth is a smooth field (a
coarse uniform grid resized bilinearly) in millimetres, with a share of
pixels set to 0 (holes, which the depth loss skips).

Parameters (a traffic file `traffic/<mix>.json` with "generator":
"train_planes"): height, width, ims (images a step), pool_batches
(batches drawn), max_instances (GT rows a batch holds), min_planes and
max_planes (rectangles painted an image, drawn uniformly), min_side and
max_side (a rectangle's width and height, each drawn uniformly, in
pixels), min_visible (the side of the least visible area kept),
min_offset and max_offset (metres), depth_grid ([rows, cols] of the
coarse depth grid), min_depth_mm and max_depth_mm, hole_share,
calibration (images of the first batch that set the trunk's frozen
BatchNorm statistics; read by the driver).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .train_batches import Cycle  # noqa: F401  (the loader the driver cycles)

_BITS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits(masks: torch.Tensor) -> torch.Tensor:
    """`np.packbits(masks, axis=-1)` on the device: (..., W) bool, W a
    multiple of 8 -> (..., W / 8) uint8."""
    w = masks.shape[-1]
    weights = torch.tensor(_BITS, dtype=torch.uint8, device=masks.device)
    bits = masks.to(torch.uint8).reshape(*masks.shape[:-1], w // 8, 8)
    return (bits * weights).sum(-1, dtype=torch.uint8)


def _image(gen: torch.Generator, params: dict, device) -> Dict[str, torch.Tensor]:
    """One image's GT: boxes (G, 4), valid (G,), masks (G, H, W) bool,
    planes (G, 3), the kept planes first in painting order."""
    g, h, w = params["max_instances"], params["height"], params["width"]
    n = int(torch.randint(params["min_planes"], params["max_planes"] + 1, (1,),
                          generator=gen, device=device))
    u = torch.rand(g, 4, generator=gen, device=device)
    lo, hi = params["min_side"], params["max_side"]
    rw = (lo + (hi - lo) * u[:, 0]).clamp(max=w).floor()
    rh = (lo + (hi - lo) * u[:, 1]).clamp(max=h).floor()
    x0 = (u[:, 2] * (w - rw + 1)).floor().clamp(max=w - rw)
    y0 = (u[:, 3] * (h - rh + 1)).floor().clamp(max=h - rh)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    cover = (((ys[None, :, None] >= y0[:, None, None]) & (ys[None, :, None] < (y0 + rh)[:, None, None]))
             & ((xs[None, None, :] >= x0[:, None, None]) & (xs[None, None, :] < (x0 + rw)[:, None, None])))
    cover &= (torch.arange(g, device=device) < n)[:, None, None]
    order = torch.arange(1, g + 1, device=device)[:, None, None]
    top = (cover * order).amax(0)                         # the last plane painted, 0: none
    masks = top[None] == order
    keep = masks.sum((1, 2)) >= params["min_visible"] ** 2
    rank = torch.argsort((~keep).to(torch.int8), stable=True)
    masks, keep = masks[rank] & keep[rank][:, None, None], keep[rank]
    rows, cols = masks.any(2), masks.any(1)
    first = lambda m: torch.where(m.any(1), m.to(torch.int8).argmax(1), 0)
    last = lambda m: torch.where(m.any(1), m.shape[1] - 1 - m.flip(1).to(torch.int8).argmax(1), -1)
    boxes = torch.stack([first(cols), first(rows), last(cols) + 1, last(rows) + 1], -1)
    boxes = boxes.to(torch.float32) * keep[:, None]
    v = torch.randn(g, 3, generator=gen, device=device)
    v[:, 1] = v[:, 1].abs()
    normal = v / v.norm(dim=1, keepdim=True).clamp(min=1e-12)
    offset = params["min_offset"] + (params["max_offset"] - params["min_offset"]) * torch.rand(
        g, generator=gen, device=device)
    return {"boxes": boxes, "valid": keep, "masks": masks,
            "planes": normal * offset[:, None] * keep[:, None]}


def make_pool(params: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`pool_batches` batches of `ims` images on `device`; the same seed
    gives the same batches, and every seed the same shapes."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + 19) % (1 << 63))
    b, h, w = params["ims"], params["height"], params["width"]
    pool = []
    for _ in range(params["pool_batches"]):
        images = torch.randint(0, 256, (b, h, w, 3), generator=gen, device=device,
                               dtype=torch.uint8)
        gts = [_image(gen, params, device) for _ in range(b)]
        gy, gx = params["depth_grid"]
        grid = torch.rand(b, 1, gy, gx, generator=gen, device=device)
        field = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)[:, 0]
        lo, hi = params["min_depth_mm"], params["max_depth_mm"]
        depth = (lo + (hi - lo) * field).round()
        holes = torch.rand(b, h, w, generator=gen, device=device) < params["hole_share"]
        depth = torch.where(holes, torch.zeros_like(depth), depth)
        stack = lambda k: torch.stack([x[k] for x in gts])
        valid = stack("valid")
        pool.append({"images": images, "gt_boxes": stack("boxes"),
                     "gt_classes": torch.zeros(valid.shape, dtype=torch.int64, device=device),
                     "gt_valid": valid, "gt_masks_packed": pack_bits(stack("masks")),
                     "gt_planes": stack("planes"),
                     "gt_depth_mm": depth.to(torch.int32).to(torch.uint16)})
    return pool
