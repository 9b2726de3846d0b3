"""FLOPs (two per multiply-add) of one stage-3 training step of PlaneRCNN
R50-FPN (`step3_plane.yaml`) over a detector frozen after stage 1: the
forward of the frozen trunk, FPN and RPN head on every image and of the
frozen box head on the sampled ROIs; the mask and plane heads' forward and
backward on the foreground ROIs (the rows detectron2's
`select_foreground_proposals` gives them, whatever rows the program runs
them on); the depth decoder's forward and backward on every image.  A
backward counts each convolution's and linear layer's weight gradient and,
where its input takes a gradient, its input gradient (each as many FLOPs as
its forward): the heads' first convolutions and the depth decoder's five
lane convolutions read detached features and take none.  Pooling, resizes,
normalisation, elementwise work, the losses and the optimizer count
nothing; the shapes come from `flops.py`.
"""

from __future__ import annotations

from typing import Dict

from . import flops

LANES = ("p6", "p5", "p4", "p3", "p2")


def head_first_conv() -> int:
    """The first 3x3 convolution of the mask and plane towers on 14x14."""
    return flops.conv(256, 256, 3, 14, 14)


def depth_lanes(h: int, w: int) -> int:
    """The depth decoder's five lane convolutions (256 -> 128 on p6..p2)."""
    pyr = flops.pyramid(h, w)
    return sum(flops.conv(256, 128, 3, *pyr[n]) for n in LANES)


def step_flops(h: int, w: int, images: int, rois: int, fg_rois: int) -> Dict[str, int]:
    """{"forward", "backward"} FLOPs of a step over `images` images at the
    padded (h, w) input with `rois` sampled ROIs in all, `fg_rois` of them
    foreground."""
    img = flops.image_flops(h, w)
    heads = flops.cascade_roi_flops()
    trained = heads["mask"] + heads["plane"]
    fwd = (images * (img["trunk"] + img["fpn"] + img["rpn"] + img["depth"])
           + rois * flops.box_roi_flops() + fg_rois * trained)
    bwd = (images * (2 * img["depth"] - depth_lanes(h, w))
           + fg_rois * (2 * trained - 2 * head_first_conv()))
    return {"forward": fwd, "backward": bwd}


def total(h: int, w: int, images: int, rois: int, fg_rois: int) -> int:
    f = step_flops(h, w, images, rois, fg_rois)
    return f["forward"] + f["backward"]
