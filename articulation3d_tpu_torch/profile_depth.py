"""Stage profile of the depth decoder on the card.

    python -m articulation3d_tpu_torch.profile_depth [--batch 64] [--steps 5] [--device cuda]

The counterpart of `tools/drive_depth.py`: times the five-lane FPN depth
decoder (`models/depth_head.py::DepthHead`) at the serving config
(`serving_config()`, bfloat16 trunk), split so that the part worth
optimising is measured, not guessed:

  * lanes only (5x conv-bn)   the five 256->128 conv + BN + leaky relu
                              lanes on p6..p2
  * decoder w/o final resize  the decoder with its output at the
                              predictor's grid (twice p2's: 240x320)
  * full decoder              `DepthHead.forward`, with the bilinear
                              resize to 480x640
  * backbone+fpn+decoder      features, then the decoder

The decoder rows run on FPN features computed once on the device; every
row runs in eval mode under the model's autocast, as inference does.
Weights and frames are `profile_inference`'s, the timing loop is
`profiling.time_rows`.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
import time
from typing import List, Optional

import torch
import torch.nn.functional as F

from .profile_inference import profile_images, profile_model
from .profiling import Around, Row, Stage, device_label, markdown_table, time_rows

LANES = ("p6", "p5", "p4", "p3", "p2")


def stages(model, images: torch.Tensor) -> List[Stage]:
    """The rows of `tools/drive_depth.py` over `model` (a PlaneRCNN with
    its depth head, in eval mode) and `images`: [(name, fn)]."""
    head = model.depth_head
    dev = images.device
    with torch.no_grad():
        feats = model.features(images)
    ph, pw = feats["p2"].shape[2:]
    small = copy.copy(head)     # the same weights, output at the predictor's grid
    small.cfg = dataclasses.replace(head.cfg, output_height=2 * ph, output_width=2 * pw)

    @torch.no_grad()
    def lanes_only():
        outs = []
        with model._autocast(dev):
            for i, name in enumerate(LANES):
                conv, bn = getattr(head, f"conv{i + 1}")
                outs.append(F.leaky_relu(bn(conv(feats[name]).to(torch.float32)), 0.01))
        return outs

    @torch.no_grad()
    def decoder(h):
        with model._autocast(dev):
            return h(feats).to(torch.float32)

    @torch.no_grad()
    def feats_plus_depth():
        f = model.features(images)
        with model._autocast(dev):
            return head(f).to(torch.float32)

    return [
        ("lanes only (5x conv-bn)", lanes_only),
        ("decoder w/o final resize", lambda: decoder(small)),
        ("full decoder", lambda: decoder(head)),
        ("backbone+fpn+decoder", feats_plus_depth),
    ]


def main(argv=None, cfg=None, around: Optional[Around] = None) -> List[Row]:
    """Runs the CLI; `cfg` replaces `serving_config()` (the tests pass a
    small one) and `around` runs each row's timing (`profiling.time_rows`).
    Returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from .config import serving_config
    from .structures import resolve_device

    device = resolve_device(args.device)
    cfg = cfg if cfg is not None else serving_config()
    t0 = time.perf_counter()
    model = profile_model(cfg, device)
    images = profile_images(cfg, args.batch, device)
    print(f"# init {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    rows = time_rows(stages(model, images), args.steps, args.batch, width=30, around=around)
    heading = (f"## Depth decoder stage table (batch={args.batch}, {device_label(device)}, "
               f"serving preset)")
    print(markdown_table(heading, rows, args.batch), flush=True)
    return rows


if __name__ == "__main__":
    main()
