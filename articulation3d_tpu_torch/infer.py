"""Video -> per-frame articulation detections, on the card.

    python -m articulation3d_tpu_torch.infer --config configs/config.yaml \
        --input video.mp4 --output out/ [--conf-threshold 0.7] [--batch-size 8]

The flags are those of `tools/inference.py`.  Writes `predictions.npz`:
per-frame detection counts (`counts`) and the concatenated boxes, scores,
classes, planes, rot_axis, tran_axis and bit-packed full-image masks
(`masks_packed`, unpack with `np.unpackbits(..., axis=-1, count=width)`),
and prints per-chunk wall times.  Temporal fitting, the mp4 visualisation
and `--save-obj` are not ported yet; `--save-obj` is an error.
Without `weights` in the config the model runs on seeded random weights.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


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
    if args.save_obj:
        parser.error("--save-obj needs the temporal optimizer and the mesh "
                     "export, which this package does not have yet")

    from .config import load_config
    from .models.planercnn import build_model
    from .structures import resolve_device
    from .video.io import read_frames
    from .video.pipeline import VideoPipeline
    from .weights import load_torch_state_dict, random_state_dict

    device = resolve_device(args.device)
    config = load_config(args.config)
    if config.weights:
        state_dict = load_torch_state_dict(config.weights)
    else:
        print(f"no weights in the config: random weights from seed {config.seed}")
        state_dict = random_state_dict(config.seed)
    model = build_model(config, device=device, state_dict=state_dict)
    pipeline = VideoPipeline(config, model, batch_size=args.batch_size,
                             conf_threshold=args.conf_threshold, device=device)

    t0 = time.perf_counter()
    frames, _ = read_frames(args.input, config.input.height, config.input.width)
    t1 = time.perf_counter()
    print(f"decoded {len(frames)} frames ({t1 - t0:.1f}s)")
    preds = pipeline.run(frames, verbose=True)
    t2 = time.perf_counter()
    print(f"inference: {t2 - t1:.3f}s ({len(frames) / (t2 - t1):.1f} frames/s "
          f"incl. first-chunk set-up and readback)")
    for i, wall in enumerate(pipeline.chunk_walls):
        print(f"chunk {i + 1}: {wall:.3f}s")

    os.makedirs(args.output, exist_ok=True)
    cat = lambda name: np.concatenate([getattr(p, name) for p in preds])
    np.savez_compressed(
        os.path.join(args.output, "predictions.npz"),
        counts=np.asarray([len(p) for p in preds], np.int64),
        **{k: cat(k) for k in ("boxes", "scores", "classes", "planes",
                               "rot_axis", "tran_axis")},
        masks_packed=np.concatenate(
            [np.packbits(p.masks.astype(bool), axis=-1) for p in preds]),
        width=np.int64(config.input.width))
    print(f"wrote {os.path.join(args.output, 'predictions.npz')}")


if __name__ == "__main__":
    main()
