"""Training CLI (the contract of `tools/train_net.py`, the reference's
`tools/train_net.py:72-117`), on the card:

    python -m articulation3d_tpu_torch.train_net --config-file configs/step1_bbox.yaml \\
        [--resume] [--eval-only] [--max-iter N] [--device cpu] \\
        [--dist-url URL --num-machines N --machine-rank R] [key.path value ...]

Config files use the snake_case YAML schema of `config.py`; the trailing
`opts` are dotted-path overrides (e.g. `solver.base_lr 0.002`).  Training
reads `datasets_train` through the registered catalog, checkpoints every
`solver.checkpoint_period` steps into `output_dir`, and `--eval-only` runs
the evaluators of `datasets_test` (after `--resume`, on the newest
checkpoint there).

Data parallelism runs one process per card.  On one machine with N cards,
torchrun starts them and sets the environment `init_distributed` reads:

    torchrun --nproc_per_node N -m articulation3d_tpu_torch.train_net \\
        --config-file configs/step1_bbox.yaml

or start each process yourself with the reference's flags (the global
rank as `--machine-rank`, the number of processes as `--num-machines`):

    python -m articulation3d_tpu_torch.train_net --config-file ... \\
        --dist-url tcp://HOST:PORT --num-machines N --machine-rank R

`solver.ims_per_batch` is the global batch, split evenly over the
processes; `solver.reference_world_size` > 0 rescales the schedule to the
number of processes (`config.auto_scale_workers`).
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
    # the reference's launch contract (d2 `launch`, tools/train_net.py:107-117
    # there): one process per card, also read from torchrun's environment
    parser.add_argument("--dist-url", default=None,
                        help="init_method of the process group, e.g. tcp://host:port")
    parser.add_argument("--num-machines", type=int, default=None,
                        help="number of processes of the group")
    parser.add_argument("--machine-rank", type=int, default=None,
                        help="rank of this process")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    if len(args.opts) % 2:
        parser.error(f"opts must be key value pairs, got {args.opts}")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    from .parallel import init_distributed
    try:
        init_distributed(args.dist_url, args.num_machines, args.machine_rank,
                         backend="gloo" if args.device == "cpu" else None)
    except ValueError as e:          # --dist-url without the group's size or rank
        parser.error(str(e))

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
