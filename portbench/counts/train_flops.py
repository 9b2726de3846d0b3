"""FLOPs (two per multiply-add) of one stage-1 training step of PlaneRCNN
R50-FPN (`step1_bbox.yaml`): the forward of every module the step runs
(trunk, FPN, RPN head on p2-p6, box head and predictor on the sampled
ROIs), and the backward of the trained ones: res3-res5, the FPN, the RPN
head and the box head, each convolution and linear layer counting its
weight gradient and, where its input takes a gradient, its input gradient
(each as many FLOPs as its forward).  The stem and res2 are frozen, so
res3's first block and the FPN's lateral on res2 compute no input
gradient.  Pooling, resizes, normalisation, elementwise work, the losses
and the optimizer count nothing; the shapes come from `flops.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import flops

TRAINED_STAGES = (3, 4, 5)


def layers(h: int, w: int) -> List[Tuple[str, int, bool, bool]]:
    """(name, forward FLOPs, trained, input takes a gradient) of every
    convolution of one image's trunk, FPN and RPN head at the padded (h,
    w) input."""
    out = []
    y, x = flops._out(h, 7, 2, 3), flops._out(w, 7, 2, 3)
    out.append(("stem", flops.conv(3, 64, 7, y, x), False, False))
    y, x = flops._out(y, 3, 2, 1), flops._out(x, 3, 2, 1)
    cin = 64
    for s, (blocks, width) in flops._STAGES.items():
        cout = width * 4
        trained = s in TRAINED_STAGES
        for blk in range(blocks):
            stride = 2 if (blk == 0 and s > 2) else 1
            yo, xo = flops._out(y, 1, stride, 0), flops._out(x, 1, stride, 0)
            # the block's input takes a gradient unless it comes from a frozen stage
            fed = trained and not (s == TRAINED_STAGES[0] and blk == 0)
            out.append((f"res{s}.{blk}.conv1", flops.conv(cin, width, 1, yo, xo), trained, fed))
            out.append((f"res{s}.{blk}.conv2", flops.conv(width, width, 3, yo, xo), trained,
                        trained))
            out.append((f"res{s}.{blk}.conv3", flops.conv(width, cout, 1, yo, xo), trained,
                        trained))
            if blk == 0:
                out.append((f"res{s}.{blk}.shortcut", flops.conv(cin, cout, 1, yo, xo),
                            trained, fed))
            y, x, cin = yo, xo, cout
    pyr = flops.pyramid(h, w)
    for lvl, c in ((2, 256), (3, 512), (4, 1024), (5, 2048)):
        out.append((f"fpn_lateral{lvl}", flops.conv(c, 256, 1, *pyr[f"p{lvl}"]), True, lvl > 2))
        out.append((f"fpn_output{lvl}", flops.conv(256, 256, 3, *pyr[f"p{lvl}"]), True, True))
    for name, hw in pyr.items():
        out.append((f"rpn.{name}.conv", flops.conv(256, 256, 3, *hw), True, True))
        out.append((f"rpn.{name}.objectness", flops.conv(256, 3, 1, *hw), True, True))
        out.append((f"rpn.{name}.deltas", flops.conv(256, 12, 1, *hw), True, True))
    return out


def step_flops(h: int, w: int, images: int, rois: int) -> Dict[str, int]:
    """{"forward", "backward"} FLOPs of a step over `images` images at the
    padded (h, w) input with `rois` sampled ROIs in all."""
    fwd = sum(f for _, f, _, _ in layers(h, w))
    bwd = sum(f * (1 + fed) for _, f, trained, fed in layers(h, w) if trained)
    box = flops.box_roi_flops()
    return {"forward": images * fwd + rois * box,
            "backward": images * bwd + rois * 2 * box}


def total(h: int, w: int, images: int, rois: int) -> int:
    f = step_flops(h, w, images, rois)
    return f["forward"] + f["backward"]
