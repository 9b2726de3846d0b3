"""Benchmark evaluation with temporal optimisation, on the card (the
contract of `tools/opt_arti.py`, the reference's `tools/opt_arti.py:33-355`):

    python -m articulation3d_tpu_torch.opt_arti --config configs/config.yaml \\
        --input instances_predictions.pth --output out/ [--dataset arti_test] \\
        [--video-root DIR] [--conf-threshold 0.7] [--batch-size 8] \\
        [--load-results] [--device cpu]

The saved predictions of an evaluation run are grouped by the video id of
their `{youtube11}_{shot}_{frame}_{offset}` file names; each clip
(`{video_root}/{video_id}.mp4`) is run through the detector again, tracked
and optimised ("3dc", sweeps on the card), and the optimised predictions of
the annotated frames go to the `ArtiEvaluator`.  Under a SLURM array
(`SLURM_ARRAY_TASK_ID`, `SLURM_ARRAY_TASK_MAX`) each task takes its share
of the videos and writes `predictions_XXXX.pth`; `--load-results` merges
those shards into one evaluation.
"""

from __future__ import annotations

import argparse
import math
import os
import random
from glob import glob

import numpy as np


def parse_frame_name(file_path):
    """'{youtube11}_{shot}_{frame}_{offset}.png' -> (video_id, offset)."""
    filename = file_path.split("/")[-1]
    prefix = filename.replace(".png", "")
    youtube_id = prefix[:11]
    splits = prefix.split("_")
    shot_id = int(splits[-3])
    frame_id = int(splits[-2])
    frame_offset = int(splits[-1])
    return f"{youtube_id}_{shot_id}_{frame_id}", frame_offset


def _evaluate(args, cfg, predictions):
    from .evaluation import ArtiEvaluator
    evaluator = ArtiEvaluator(args.dataset, cfg, False, output_dir=args.output)
    evaluator.reset()
    evaluator._predictions = predictions
    results = evaluator.evaluate()
    print(results)
    return results


def main(argv=None):
    """Runs the CLI; returns the evaluator's results, or None for a shard."""
    random.seed(2020)
    np.random.seed(2020)

    parser = argparse.ArgumentParser(
        description="Temporal optimization + benchmark evaluation.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--load-results", action="store_true")
    parser.add_argument("--input", required=True,
                        help="instances_predictions.pth from a prior eval run")
    parser.add_argument("--output", required=True)
    parser.add_argument("--dataset", default="arti_test")
    parser.add_argument("--conf-threshold", default=0.7, type=float)
    parser.add_argument("--vis-dir", default=None, type=str)
    parser.add_argument("--vis-num", default=50, type=int)
    parser.add_argument("--video-root", default=None, type=str,
                        help="directory holding {video_id}.mp4 clips")
    parser.add_argument("--batch-size", default=8, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from .config import load_config

    os.makedirs(args.output, exist_ok=True)
    cfg = load_config(args.config)

    if args.load_results:
        predictions, corrs, corrs_opt = [], [], []
        for pred_fpath in sorted(glob(os.path.join(args.output, "predictions_*.pth"))):
            print("reading " + pred_fpath)
            data = torch.load(pred_fpath, weights_only=False)
            predictions.extend(data["predictions"])
            corrs.extend(data["corrs"])
            corrs_opt.extend(data["corrs_opt"])
        for name, arr in (("corr", corrs), ("corr_opt", corrs_opt)):
            a = np.abs(np.asarray(arr, np.float64))
            a = a[~np.isnan(a)]
            print(name, a.mean() if len(a) else float("nan"))
        print(f"[number of predictions]: {len(predictions)}")
        return _evaluate(args, cfg, predictions)

    from .infer import build_model
    from .structures import resolve_device
    from .temporal import check_axis, check_monotonic, optimize_planes, track_planes
    from .video.io import read_frames
    from .video.pipeline import VideoPipeline

    device = resolve_device(args.device)
    predictions_in = torch.load(args.input, weights_only=False)

    video_ids = []
    pred_by_video = {}
    for p in predictions_in:
        video_id, frame_offset = parse_frame_name(p["file_name"])
        if video_id not in video_ids:
            video_ids.append(video_id)
        pred_by_video.setdefault(video_id, {})[frame_offset] = p

    if args.vis_num >= 0:
        video_ids = random.sample(video_ids, min(args.vis_num, len(video_ids)))

    # slurm array sharding
    output_path = None
    if os.environ.get("SLURM_ARRAY_TASK_ID") is not None:
        array_task_id = int(os.environ["SLURM_ARRAY_TASK_ID"])
        array_task_cnt = int(os.environ["SLURM_ARRAY_TASK_MAX"]) + 1
        n = math.ceil(len(video_ids) / array_task_cnt)
        chunks = [video_ids[i:i + n] for i in range(0, len(video_ids), n)]
        video_ids = chunks[array_task_id] if array_task_id < len(chunks) else []
        output_path = os.path.join(
            args.output, "predictions_{:0>4}.pth".format(array_task_id))
        print(f"slurm detected: idx {array_task_id} total {array_task_cnt} "
              f"lines {len(video_ids)}")

    model = build_model(cfg, device=device)
    pipeline = VideoPipeline(cfg, model, batch_size=args.batch_size,
                             conf_threshold=args.conf_threshold, device=device)

    video_root = args.video_root or "step2_filtered_clips"
    h, w = cfg.input.height, cfg.input.width
    predictions, corrs, corrs_opt = [], [], []
    for video_id in video_ids:
        video_path = os.path.join(video_root, f"{video_id}.mp4")
        if not os.path.exists(video_path):
            print(f"missing clip {video_path}, skipping")
            continue
        frames, fps = read_frames(video_path, h, w)
        preds = pipeline.run(frames)

        planes = track_planes(preds)
        opt_preds = optimize_planes(preds, planes, "3dc", frames=frames, h=h, w=w,
                                    device=device)
        corr, corr_opt = check_axis(preds, opt_preds, planes["rot"], "debug", h=h, w=w)
        corrs.extend(corr)
        corrs_opt.extend(corr_opt)
        if planes["rot"]:
            fit, fit_opt = check_monotonic(preds, opt_preds, planes["rot"], "debug")
            print(f"{video_id}: normal-plane fit "
                  f"{np.mean([f[0] for f in fit]):.4f} -> "
                  f"{np.mean([f[0] for f in fit_opt]):.4f}")

        for frame_offset, p in pred_by_video[video_id].items():
            if frame_offset >= len(opt_preds):
                continue
            pred = opt_preds[frame_offset]
            opt_p = {
                "image_id": p["image_id"],
                "file_name": p["file_name"],
                "pred_depth": p.get("pred_depth"),
                "instances": [],
                "pred_rot_axis": pred.rot_axis,
                "pred_tran_axis": pred.tran_axis,
                "pred_plane": pred.planes,
            }
            for i in range(len(pred)):
                b = pred.boxes[i]
                opt_p["instances"].append({
                    "image_id": p["image_id"],
                    "category_id": int(pred.classes[i]),
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "score": float(pred.scores[i]),
                })
            predictions.append(opt_p)

    if output_path is not None:
        torch.save({"predictions": predictions, "corrs": corrs,
                    "corrs_opt": corrs_opt}, output_path)
        return None
    return _evaluate(args, cfg, predictions)


if __name__ == "__main__":
    main()
