"""FLOPs (two per multiply-add) of PlaneRCNN R50-FPN inference, from the
shapes of the configuration: the convolutions and linear layers of the
trunk, FPN, RPN head, box head, mask, plane and axis heads and depth
decoder.  Pooling, resizes, normalisation and elementwise work count
nothing.  The heads count only the ROIs the step's inputs need: the valid
proposals of the box head and the valid detections of the cascade, never
the padded slots.
"""

from __future__ import annotations

from typing import Dict

_STAGES = {2: (3, 64), 3: (4, 128), 4: (6, 256), 5: (3, 512)}


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    """A k x k convolution producing (cout, h_out, w_out)."""
    return 2 * cin * cout * k * k * h_out * w_out


def linear(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def pyramid(h: int, w: int) -> Dict[str, tuple]:
    """{p2..p6: (h, w)} of a padded (h, w) input."""
    sizes = {}
    y, x = _out(_out(h, 7, 2, 3), 3, 2, 1), _out(_out(w, 7, 2, 3), 3, 2, 1)
    for lvl in (2, 3, 4, 5):
        if lvl > 2:
            y, x = _out(y, 1, 2, 0), _out(x, 1, 2, 0)
        sizes[f"p{lvl}"] = (y, x)
    sizes["p6"] = (_out(y, 1, 2, 0), _out(x, 1, 2, 0))
    return sizes


def image_flops(h: int, w: int) -> Dict[str, int]:
    """The per-image parts that do not depend on ROIs: trunk, FPN, RPN head
    and depth decoder at the padded (h, w) input."""
    y, x = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    trunk = conv(3, 64, 7, y, x)
    y, x = _out(y, 3, 2, 1), _out(x, 3, 2, 1)
    cin = 64
    for s, (blocks, width) in _STAGES.items():
        cout = width * 4
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 2) else 1
            yo, xo = _out(y, 1, stride, 0), _out(x, 1, stride, 0)
            trunk += conv(cin, width, 1, yo, xo) + conv(width, width, 3, yo, xo) \
                + conv(width, cout, 1, yo, xo)
            if b == 0:
                trunk += conv(cin, cout, 1, yo, xo)
            y, x, cin = yo, xo, cout
    pyr = pyramid(h, w)
    fpn = sum(conv(c, 256, 1, *pyr[f"p{l}"]) + conv(256, 256, 3, *pyr[f"p{l}"])
              for l, c in ((2, 256), (3, 512), (4, 1024), (5, 2048)))
    rpn = sum(conv(256, 256, 3, *hw) + conv(256, 3, 1, *hw) + conv(256, 12, 1, *hw)
              for hw in pyr.values())
    depth = sum(conv(256, 128, 3, *pyr[n]) for n in ("p6", "p5", "p4", "p3", "p2"))
    up = lambda n: (2 * pyr[n][0], 2 * pyr[n][1])
    depth += conv(128, 128, 3, *up("p6"))
    depth += conv(256, 128, 3, *up("p5")) + conv(256, 128, 3, *up("p4")) \
        + conv(256, 128, 3, *up("p3"))
    depth += conv(256, 64, 3, *up("p2")) + conv(64, 1, 3, *up("p2"))
    return {"trunk": trunk, "fpn": fpn, "rpn": rpn, "depth": depth}


def box_roi_flops(num_classes: int = 2) -> int:
    """The box head and predictor of one proposal (7x7x256 pooled)."""
    return (linear(256 * 49, 1024) + linear(1024, 1024)
            + linear(1024, num_classes + 1) + linear(1024, 4 * num_classes))


def _tower() -> int:
    return 4 * conv(256, 256, 3, 14, 14) + linear(256 * 196, 1024)


def cascade_roi_flops() -> Dict[str, int]:
    """The mask, plane and axis heads of one detection (14x14x256 pooled)."""
    mask = 4 * conv(256, 256, 3, 14, 14) + 2 * 256 * 256 * 4 * 14 * 14 \
        + conv(256, 1, 1, 28, 28)
    plane = _tower() + linear(1024, 3)
    axis = 2 * _tower() + linear(1024, 2) + linear(1024, 1) + linear(1024, 2)
    return {"mask": mask, "plane": plane, "axis": axis}


def inference_flops(h: int, w: int, frames: int, box_rois: int, det_rois: int) -> int:
    """FLOPs `frames` images need, with `box_rois` valid proposals and
    `det_rois` valid detections among them."""
    return (frames * sum(image_flops(h, w).values()) + box_rois * box_roi_flops()
            + det_rois * sum(cascade_roi_flops().values()))
