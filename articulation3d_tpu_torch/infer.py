"""Video -> articulation detections -> temporal fit -> artefacts, on the card.

    python -m articulation3d_tpu_torch.infer --config configs/config.yaml \
        --input video.mp4 --output out/ [--save-obj] [--webvis] \
        [--conf-threshold 0.7] [--batch-size 8] [--device cuda]

The flags and artefacts are those of `tools/inference.py`:

  * the detector (`VideoPipeline`, K1 on the card) over all frames;
  * per frame, the predictions drawn over the frame beside their normal
    map, before and after the temporal fit;
  * `track_planes` and `optimize_planes(..., "3dc")`, with the hypothesis
    sweeps on the card;
  * `output.mp4` (`output.png` for a still image): the fitted frame, its
    normal map and the frame before the fit, side by side;
  * with `--save-obj [--webvis]`, `frame_XXXX/arti_pred.{obj,mtl}` and
    their uv maps for frames 0, 30, 60 and 89.

It also writes `predictions.npz`, the detector's output: per-frame
detection counts (`counts`) and the concatenated boxes, scores, classes,
planes, rot_axis, tran_axis and bit-packed full-image masks
(`masks_packed`, unpack with `np.unpackbits(..., axis=-1, count=width)`).
It prints the walls of inference, track + optimise, visualisation and
export.  Without `weights` in the config the model runs on seeded random
weights.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

OBJ_FRAMES = (0, 30, 60, 89)


def _vis_frame(im: np.ndarray, p, metadata, cls_name_map, conf_threshold: float) -> np.ndarray:
    """Predictions drawn over the frame (RGB) beside their normal map."""
    from .vis.visualizer import ArtiVisualizer, draw_pred, get_normal_map
    seg = draw_pred(ArtiVisualizer(im[:, :, ::-1]), p, metadata, cls_name_map,
                    conf_threshold=conf_threshold)
    if len(p) == 0:
        normal_vis = get_normal_map(np.array([[1.0, 0, 0]]), np.zeros((1, *im.shape[:2])))
    else:
        normal_vis = get_normal_map(p.planes, p.masks)
    return np.concatenate((seg, normal_vis), axis=1)


def run_video(pipeline, frames: Sequence[np.ndarray], fps: Optional[float], output: str,
              conf_threshold: float = 0.7, save_obj: bool = False,
              webvis: bool = False) -> Dict:
    """The CLI's body on in-memory (H, W, 3) BGR frames: detector, fit,
    visualisation and export into `output`.  `fps` None means a still image
    (`output.png`).  The sweeps run on the pipeline's device.  Returns the
    walls of the stages in seconds."""
    from .data.catalog import get_metadata
    from .temporal import optimize_planes, track_planes
    from .video.io import write_video

    random.seed(2020)
    np.random.seed(2020)
    os.makedirs(output, exist_ok=True)
    metadata = get_metadata("arti_train")
    shortened = {"arti_rot": "R", "arti_tran": "T"}
    cls_name_map = [shortened[c] for c in metadata.thing_classes]
    h, w = pipeline.output_height, pipeline.output_width
    walls = {}

    t0 = time.perf_counter()
    preds = pipeline.run(frames, verbose=True)
    walls["inference"] = time.perf_counter() - t0
    print(f"inference: {walls['inference']:.3f}s ({len(frames) / walls['inference']:.1f} "
          f"frames/s incl. first-chunk set-up and readback)")
    for i, wall in enumerate(pipeline.chunk_walls):
        print(f"chunk {i + 1}: {wall:.3f}s")
    _save_predictions(os.path.join(output, "predictions.npz"), preds, w)

    t1 = time.perf_counter()
    org_vis = [_vis_frame(im, p, metadata, cls_name_map, conf_threshold)
               for im, p in zip(frames, preds)]
    walls["visualisation"] = time.perf_counter() - t1

    t2 = time.perf_counter()
    planes = track_planes(preds)
    opt_preds = optimize_planes(preds, planes, "3dc", frames=frames, h=h, w=w,
                                device=pipeline.device)
    walls["track_optimise"] = time.perf_counter() - t2
    print(f"track+optimize: {walls['track_optimise']:.3f}s "
          f"({len(planes['rot']) + len(planes['trans'])} tracks: "
          f"{len(planes['rot'])} rot, {len(planes['trans'])} trans)")

    t3 = time.perf_counter()
    out_frames: List[np.ndarray] = [
        np.concatenate((_vis_frame(im, p, metadata, cls_name_map, 0.7), org), axis=1)
        for im, p, org in zip(frames, opt_preds, org_vis)]
    if fps is not None:
        write_video(os.path.join(output, "output.mp4"), out_frames, fps=fps, bgr=False)
    else:
        import cv2
        cv2.imwrite(os.path.join(output, "output.png"), out_frames[0][:, :, ::-1])
    walls["visualisation"] += time.perf_counter() - t3
    print(f"wrote visualization to {output} ({walls['visualisation']:.3f}s)")

    if save_obj:
        from .export import save_obj_model
        t4 = time.perf_counter()
        for frame_id in OBJ_FRAMES:
            if frame_id < len(frames):
                save_obj_model(opt_preds, frames, frame_id, output, webvis=webvis)
        walls["export"] = time.perf_counter() - t4
        print(f"wrote .obj models ({walls['export']:.3f}s)")
    return walls


def build_model(config, device=None):
    """The detector of `config` in eval mode on `device` (the card unless
    named): weights from `config.weights` (a d2 `.pth`/`.pkl` or a
    checkpoint of `train.Trainer`), else seeded random weights."""
    from .models.planercnn import build_model as build_planercnn
    from .structures import resolve_device
    from .weights import load_torch_state_dict, random_state_dict, schema_options

    device = resolve_device(device)
    if config.weights:
        state_dict = load_torch_state_dict(config.weights)
    else:
        print(f"no weights in the config: random weights from seed {config.seed}")
        state_dict = random_state_dict(config.seed, **schema_options(config.model))
    return build_planercnn(config, device=device, state_dict=state_dict)


def _save_predictions(path: str, preds, width: int) -> None:
    cat = lambda name: np.concatenate([getattr(p, name) for p in preds])
    np.savez_compressed(
        path,
        counts=np.asarray([len(p) for p in preds], np.int64),
        **{k: cat(k) for k in ("boxes", "scores", "classes", "planes",
                               "rot_axis", "tran_axis")},
        masks_packed=np.concatenate(
            [np.packbits(p.masks.astype(bool), axis=-1) for p in preds]),
        width=np.int64(width))
    print(f"wrote {path}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Generate articulation predictions for a video.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--input", required=True, help="input video/png")
    parser.add_argument("--output", required=True, help="output directory")
    parser.add_argument("--save-obj", action="store_true")
    parser.add_argument("--webvis", action="store_true")
    parser.add_argument("--conf-threshold", default=0.7, type=float)
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from .config import load_config
    from .structures import resolve_device
    from .video.io import read_frames
    from .video.pipeline import VideoPipeline

    device = resolve_device(args.device)
    config = load_config(args.config)
    model = build_model(config, device=device)
    pipeline = VideoPipeline(config, model, batch_size=args.batch_size,
                             conf_threshold=args.conf_threshold, device=device)

    t0 = time.perf_counter()
    frames, fps = read_frames(args.input, config.input.height, config.input.width)
    print(f"decoded {len(frames)} frames ({time.perf_counter() - t0:.1f}s)")
    run_video(pipeline, frames, fps, args.output, conf_threshold=args.conf_threshold,
              save_obj=args.save_obj, webvis=args.webvis)


if __name__ == "__main__":
    main()
