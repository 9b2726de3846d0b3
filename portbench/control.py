#!/usr/bin/env python3
"""Readings that set the limits of `correct`, on the card:

    python3 portbench/control.py --workload infer_stream_b1 --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault rpn_nms_skipped --fault-seeds 1 2 3] \
        [--seconds 4] [--out FILE]

For each of `--seeds`, one run of the cell's timed path (the driver, with a
short window at the cell's own load) and the judged numbers of its answers:
the lower readings.  For each of `--control-seeds`, the control: the plain
reference in float8 (e4m3, the precision below the configuration's
bfloat16) put in the program's place on the same frames the run judges,
judged the same way: the upper readings.  For each `--fault` and each of
`--fault-seeds`, one run of the timed path with that fault planted
(FAULTS: an NMS threshold of the program's configuration changed, the
judge's left as stated, or an answer altered where the step produces it):
the upper readings of the numbers the control does not separate.  One JSON line per reading on standard output (and in `--out`);
the benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# planted faults.  ("config", section, key, value): the program runs with
# that value in its model configuration, the judge with the one stated (an
# NMS threshold of 1.0 suppresses nothing).  ("step", what): the program's
# inference step alters that answer where it produces it.
FAULTS = {
    "rpn_nms_skipped": ("config", "rpn", "nms_thresh", 1.0),
    "rpn_nms_0.5": ("config", "rpn", "nms_thresh", 0.5),
    "det_nms_skipped": ("config", "roi_heads", "nms_thresh_test", 1.0),
    "det_nms_0.3": ("config", "roi_heads", "nms_thresh_test", 0.3),
    "det_score_altered": ("step", "score"),
    "depth_altered": ("step", "depth"),
}


def _alter(out: dict, what: str) -> None:
    """Alter one answer of an inference step's output in place: the first
    detection's score set to 0.99, or the depth doubled plus 50 mm."""
    import torch
    if what == "score":
        out["scores"][:, 0] = torch.where(out["valid"][:, 0], torch.full_like(
            out["scores"][:, 0], 0.99), out["scores"][:, 0])
    elif what == "depth":
        out["depth_mm"] = out["depth_mm"] * 2 + 50
    else:
        raise ValueError(what)


def planted(fault: str):
    """A context manager under which the video driver builds the program
    with `fault` (a key of FAULTS) planted."""
    import contextlib
    import copy
    from portbench.drivers import video_infer
    from articulation3d_tpu_torch.video import pipeline as pl
    kind, *what = FAULTS[fault]

    @contextlib.contextmanager
    def cm():
        if kind == "config":
            section, key, value = what
            real = video_infer._program_config

            def broken(config):
                config = copy.deepcopy(config)
                config["config"]["model"][section][key] = value
                return real(config)

            video_infer._program_config = broken
        else:
            real = pl.make_inference_step

            def broken(*args, **kw):
                step = real(*args, **kw)

                def altered(frames):
                    out = step(frames)
                    _alter(out, what[0])
                    return out
                return altered

            pl.make_inference_step = broken
        try:
            yield
        finally:
            if kind == "config":
                video_infer._program_config = real
            else:
                pl.make_inference_step = real
    return cm()


def control_readings(ctx, frames_idx, pool, stats) -> dict:
    """The float8 reference's answers on the pool's frames `frames_idx`,
    judged against the float32 reference."""
    import torch
    from portbench import weights as pbweights
    from portbench.reference import judge, planercnn as ref
    dev = ctx.device
    sd = pbweights.draw_for(ctx.config, ctx.seed, dev)
    sd.update({k: v.to(dev) for k, v in stats.items()})
    low, exact = ref.Net(sd, ref.Prec("float8")), ref.Net(sd)
    cfg = ctx.config["config"]
    out = []
    with torch.no_grad(), ref.exact_float32():
        for i in frames_idx:
            frame = torch.from_numpy(pool[i]).to(dev)
            out.append(judge.judge_frame(exact, frame, ref.infer_frame(low, frame, cfg), cfg))
    return judge.worst(out)


def judged_frames(ctx) -> list:
    from portbench.drivers.video_infer import sampled_calls
    b, n = ctx.traffic["batch"], ctx.traffic["pool"]
    calls = sampled_calls(ctx.seed, ctx.workload["sample_calls"], ctx.workload["judge_calls"])
    return [(c * b + j) % n for c in calls for j in range(b)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", nargs="*", default=[], choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import spec
    from portbench import weights as pbweights
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.benchmark()
    driver = None
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in args.seeds:
        ctx = spec.context(bench, args.workload, seed, args.seconds, False, dev,
                           time.perf_counter())
        driver = driver or spec.load_module("drivers", ctx.workload["driver"])
        out = driver.run(ctx)
        emit({"who": "program", "seed": seed, "readings": out["readings"],
              "counts": out.get("counts"), "setup_s": out["record"]["setup_s"]})
    for seed in args.control_seeds:
        ctx = spec.context(bench, args.workload, seed, args.seconds, False, dev,
                           time.perf_counter())
        frames_mod = spec.load_module("traffic", ctx.traffic["generator"])
        pool_dev = frames_mod.make_pool(ctx.traffic, seed, dev)
        sd = pbweights.draw_for(ctx.config, seed, dev)
        stats = pbweights.calibrate(sd, pool_dev[:ctx.traffic["calibration"]],
                                             ctx.config)
        del sd
        t = time.perf_counter()
        readings = control_readings(ctx, judged_frames(ctx), pool_dev.cpu().numpy(), stats)
        emit({"who": "control", "precision": "float8", "seed": seed, "readings": readings,
              "seconds": time.perf_counter() - t})
        del pool_dev
        torch.cuda.empty_cache()
    for fault in args.fault:
        for seed in args.fault_seeds:
            ctx = spec.context(bench, args.workload, seed, args.seconds, False, dev,
                               time.perf_counter())
            driver = driver or spec.load_module("drivers", ctx.workload["driver"])
            with planted(fault):
                out = driver.run(ctx)
            emit({"who": "fault", "fault": fault, "seed": seed, "readings": out["readings"],
                  "counts": out.get("counts")})
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
