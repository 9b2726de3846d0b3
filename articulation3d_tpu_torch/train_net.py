"""Training CLI (the contract of `tools/train_net.py`, the reference's
`tools/train_net.py:72-117`), on the card:

    python -m articulation3d_tpu_torch.train_net --config-file configs/step1_bbox.yaml \\
        [--resume] [--eval-only] [--max-iter N] [--device cpu] [key.path value ...]

Config files use the snake_case YAML schema of `config.py`; the trailing
`opts` are dotted-path overrides (e.g. `solver.base_lr 0.002`).  Training
reads `datasets_train` through the registered catalog, checkpoints every
`solver.checkpoint_period` steps into `output_dir`, and `--eval-only` runs
the evaluators of `datasets_test` (after `--resume`, on the newest
checkpoint there).  One process on one card: the multi-machine flags
(`--dist-url`, `--num-machines`, `--machine-rank`) are not accepted yet.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os


def parse_opts(opts):
    """['a.b.c', 'v', ...] -> nested override dict."""
    out = {}
    for key, val in zip(opts[::2], opts[1::2]):
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def main(argv=None):
    """Runs the CLI; returns (trainer, per-step records), or with
    `--eval-only` (trainer, evaluator results)."""
    parser = argparse.ArgumentParser(description="Train or evaluate PlaneRCNN.")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--max-iter", type=int, default=None,
                        help="override solver.max_iter")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    if len(args.opts) % 2:
        parser.error(f"opts must be key value pairs, got {args.opts}")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    from .config import load_config
    from .train.trainer import Trainer

    cfg = load_config(args.config_file, parse_opts(args.opts))
    os.makedirs(cfg.output_dir, exist_ok=True)
    trainer = Trainer(cfg, device=args.device)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        results = trainer.test()
        print(results)
        return trainer, results
    return trainer, trainer.train(max_iter=args.max_iter)


if __name__ == "__main__":
    main()
