"""Compare golden tensors against the port, stage by stage (the contract of
`tools/compare_goldens.py`):

    python -m articulation3d_tpu_torch.compare_goldens --goldens golden.npz \\
        --weights model_final.pth [--pooler torch|cuda|auto] \\
        [--score-thresh 0.05] [--device cpu]

The fixture comes from the reference environment (`tools/make_goldens.py`),
from the reference model's stand-in (`tools/make_goldens_oracle.py`), or
from the port itself (`evaluation.goldens.save_goldens`).  The d2
checkpoint (.pth/.pkl) loads into the port's model, `inference_probe` runs
on the stored image, and the per-stage report (max errors and match
fractions, `evaluation.goldens.compare_goldens`) is printed one key per
line.  Fixtures carrying `meta_*` keys rebuild the small config they were
made with; others get the full 480x640 inference config.  The model runs
in float32 on the card unless `--device` names another device.  The
pooler routes take the place of the JAX tool's: "torch" (the gather
formulation, the default, as "xla" is there), "cuda" (the kernels, or
their plain versions off the card, where the JAX tool has "pallas") and
"auto" (the kernels on the card).  Unlike the Pallas kernel, which moves
slivers to a coarser level, both routes pool every ROI from its
detectron2 level, as the reference does: they compute one function and
differ only in the order of float32 sums.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict


def _config_for(goldens: Dict, pooler: str):
    """Model config matching the fixture (meta keys) or the full default."""
    from .config import (Config, DepthHeadConfig, InputConfig, ModelConfig,
                         ROIHeadsConfig, RPNConfig, inference_config)
    if "meta_topk" not in goldens:
        cfg = inference_config()
        return cfg.replace(model=dataclasses.replace(
            cfg.model, dtype="float32", roi_pooler_impl=pooler))
    h, w = goldens["image"].shape[:2]
    topk = int(goldens["meta_topk"])
    dets = int(goldens["meta_dets"])
    model = ModelConfig(
        rpn=RPNConfig(pre_nms_topk_test=topk, post_nms_topk_test=topk,
                      pre_nms_topk_train=topk, post_nms_topk_train=topk),
        roi_heads=ROIHeadsConfig(
            detections_per_image=dets, batch_size_per_image=dets,
            score_thresh_test=float(goldens["meta_score_thresh"])),
        depth_head=DepthHeadConfig(output_height=h, output_width=w),
        dtype="float32", roi_pooler_impl=pooler,
    )
    return Config(model=model, input=InputConfig(height=h, width=w))


def run_compare(goldens_path: str, weights_path: str, *, pooler: str = "torch",
                score_thresh: float = 0.05, device=None) -> Dict[str, float]:
    """Load `weights_path` into the port's model and compare it with the
    fixture; returns the per-stage report."""
    from .evaluation.goldens import compare_goldens, load_goldens
    from .models.planercnn import build_model
    from .weights import load_torch_state_dict

    goldens = load_goldens(goldens_path)
    cfg = _config_for(goldens, pooler)
    state_dict = load_torch_state_dict(weights_path)
    model = build_model(cfg, device=device, state_dict=state_dict)
    print(f"loaded {len(state_dict)} keys from {weights_path} onto "
          f"{next(model.parameters()).device}")
    return compare_goldens(goldens, model, score_thresh=score_thresh)


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        description="Compare golden tensors against the port, stage by stage.")
    ap.add_argument("--goldens", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--pooler", default="torch", choices=["torch", "cuda", "auto"])
    ap.add_argument("--score-thresh", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    report = run_compare(args.goldens, args.weights, pooler=args.pooler,
                         score_thresh=args.score_thresh, device=args.device)
    width = max(len(k) for k in report)
    for k in sorted(report):
        print(f"{k:<{width}}  {report[k]:.6g}")
    return report


if __name__ == "__main__":
    main()
