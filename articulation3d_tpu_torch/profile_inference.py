"""Stage-level inference profile on the card -> markdown table.

    python -m articulation3d_tpu_torch.profile_inference [--batch 32] [--steps 5] \\
        [--output FILE] [--preset parity|serving] [--device cuda]

The counterpart of `tools/profile_inference.py`: times the inference
program and its prefixes at a batch of random 480x640 frames, with the
model's weights and the frames on the device before the first run.

  * backbone+fpn                 `PlaneRCNN.features`
  * +rpn (proposals)             features, then the RPN in eval mode
  * +box stage (pool+head+NMS)   `inference` with the mask, plane, axis
                                 and depth heads off (K1: the box pool)
  * full inference (kernel)      `inference`, pooler "cuda" (K1 x3)
  * full inference (gather pool) `inference`, pooler "torch"
  * inference w/o depth head     `inference` with the depth head off

Each stage runs twice to warm up; its time is the mean wall of `--steps`
runs, each ending in a host readback (`.item()`) of the float32 sum of
every output.  The port runs eagerly and the host sets its pace, so the
wall, host included, is the number users feel.  A stage that runs out of
device memory gets a "FAILED" row; any other error stops the run.

The weights are `weights.random_state_dict(0)` with the detection biases
of `weights.bias_for_detections`, so that proposals and detections
survive scoring and NMS and fill the cascade and the paste; the compute
dtype is the config's (`parity`: `inference_config()`, `serving`:
`serving_config()`).  The frames are `RandomState(0).randn(b, 480, 640, 3)`
float32, fed to the model as they are, with no preprocessing.

The table goes to stdout; `--output FILE` rewrites only the section of
FILE between `<!-- profile:begin -->` and `<!-- profile:end -->`.  Its
heading names the device (the card's name and power limit).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .profiling import Around, Row, Stage, device_label, markdown_table, time_rows

BEGIN, END = "<!-- profile:begin -->", "<!-- profile:end -->"


def write_section(path: str, block: str) -> None:
    """Rewrite the section of `path` between BEGIN and END with `block`
    (appended when the file has no such section; a new file holds only
    the section under a title)."""
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        text = f"# Inference profile\n\n{BEGIN}\n{END}\n"
    if BEGIN in text and END in text:
        head, rest = text.split(BEGIN, 1)
        _, tail = rest.split(END, 1)
        text = head + BEGIN + "\n" + block + END + tail
    else:
        text += f"\n{BEGIN}\n{block}{END}\n"
    with open(path, "w") as f:
        f.write(text)


# --------------------------------------------------------------------------- #
# the inference stages
# --------------------------------------------------------------------------- #

def profile_config(preset: str):
    from .config import inference_config, serving_config
    if preset not in ("parity", "serving"):
        raise ValueError(f"unknown preset {preset!r}")
    return serving_config() if preset == "serving" else inference_config()


def profile_model(cfg, device):
    """PlaneRCNN(cfg) in eval mode on `device` with the biased seeded
    weights (module docstring)."""
    from .models.planercnn import build_model
    from .weights import bias_for_detections, random_state_dict, schema_options
    sd = bias_for_detections(random_state_dict(0, **schema_options(cfg.model)))
    return build_model(cfg, device=device, state_dict=sd)


def profile_images(cfg, batch: int, device) -> torch.Tensor:
    rs = np.random.RandomState(0)
    images = rs.randn(batch, cfg.input.height, cfg.input.width, 3).astype(np.float32)
    return torch.from_numpy(images).to(device)


def with_model_config(model, **model_kw):
    """The same modules under a config whose `model` fields are replaced:
    `PlaneRCNN` runs only the heads its config turns on, so a view with a
    head off runs the smaller model on the shared weights (flax's apply
    likewise ignores the params of a head that is off)."""
    view = copy.copy(model)
    view.config = model.config.replace(
        model=dataclasses.replace(model.config.model, **model_kw))
    return view


def _inference_outputs(model, images):
    # JAX's `inference` returns the detections and the depth
    out = model.inference(images)
    return out["detections"], out.get("depth")


def stages(model, images: torch.Tensor) -> List[Stage]:
    """The rows of `tools/profile_inference.py` over `model` (a PlaneRCNN
    in eval mode) and preprocessed `images` (B, H, W, 3): [(name, fn)],
    where fn() runs the stage once and returns its outputs."""
    cfg = model.config
    h, w = cfg.input.height, cfg.input.width

    @torch.no_grad()
    def features():
        return model.features(images)

    @torch.no_grad()
    def to_rpn():
        feats = model.features(images)
        with model._autocast(images.device):
            return model.proposal_generator(feats, image_height=h, image_width=w)

    detonly = with_model_config(model, mask_on=False, plane_on=False, axis_on=False,
                                depth_on=False)
    kernel = with_model_config(model, roi_pooler_impl="cuda")
    gather = with_model_config(model, roi_pooler_impl="torch")
    nodepth = with_model_config(model, depth_on=False)
    return [
        ("backbone+fpn", features),
        ("+rpn (proposals)", to_rpn),
        ("+box stage (pool+head+NMS)", lambda: _inference_outputs(detonly, images)),
        ("full inference (kernel)", lambda: _inference_outputs(kernel, images)),
        ("full inference (gather pool)", lambda: _inference_outputs(gather, images)),
        ("inference w/o depth head", lambda: _inference_outputs(nodepth, images)),
    ]


POOL_DTYPE_NOTE = (
    "The kernel rows pool p2-p5 in the compute dtype ({dtype}) and the gather "
    "row in float32 (`PlaneRCNN.roi_features`, as JAX's `planercnn.py:111-114`), "
    "so the two full-inference rows differ in the bytes the pools read as well "
    "as in the pooler.")


def main(argv=None, cfg=None, around: Optional[Around] = None) -> List[Row]:
    """Runs the CLI; `cfg` replaces the preset's config (the tests pass a
    small one) and `around` runs each row's timing (`profiling.time_rows`).
    Returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--output", default=None, help="markdown path")
    ap.add_argument("--preset", choices=("parity", "serving"), default="parity",
                    help="capacity preset; serving = serving_config caps")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from .structures import resolve_device

    device = resolve_device(args.device)
    cfg = cfg if cfg is not None else profile_config(args.preset)
    t0 = time.perf_counter()
    model = profile_model(cfg, device)
    images = profile_images(cfg, args.batch, device)
    print(f"# init {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    rows = time_rows(stages(model, images), args.steps, args.batch, around=around)
    label = device_label(device)
    heading = (f"## Latest measured stage table (batch={args.batch}, {label}, "
               f"{args.preset} preset, biased weights)")
    block = markdown_table(heading, rows, args.batch,
                           [POOL_DTYPE_NOTE.format(dtype=cfg.model.dtype)])
    print(block, flush=True)
    if args.output:
        write_section(args.output, block)
        print(f"wrote {args.output}")
    return rows


if __name__ == "__main__":
    main()
