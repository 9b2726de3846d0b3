#!/usr/bin/env python3
"""Run one cell of the benchmark of articulation3d_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell from its files (`portbench/spec.py`), warms it up,
measures for `--seconds`, judges the timed path's answers against the
plain reference, and prints the compared numbers beside their limits as
the last lines of standard error and one JSON object as the last line of
standard output.  It needs a CUDA device (exit 2 without one) and exits 3,
with no result, if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def steady_allocator() -> bool:
    """Have glibc keep freed host memory for reuse: blocks up to 32 MiB come
    from the heap (not a fresh mmap each time) and the heap is not trimmed.
    The program allocates its answers' host arrays (a frame's 100 masks are
    30 MB) anew every call; under glibc's defaults the kernel maps and
    zeroes them every time, at a cost that differs from process to process
    by more than a bound can hold.  Returns whether glibc took the
    settings."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    m_trim_threshold, m_top_pad, m_mmap_threshold = -1, -2, -3
    return all(mallopt(k, v) == 1 for k, v in ((m_mmap_threshold, 32 << 20),
                                                (m_trim_threshold, (1 << 31) - 1),
                                                (m_top_pad, 256 << 20)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, chips: int, out: dict) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(out["record"]["memory_peak_bytes"])}


def card_label() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def main(argv=None) -> int:
    args = parse(argv)
    allocator = steady_allocator()
    sys.path.insert(0, ROOT)
    from portbench import isolation, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    bad_ref = isolation.reference_violations()
    if bad_ref:
        print(f"portbench: the reference imports the program: {bad_ref}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    ctx = spec.context(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T0)
    driver = spec.load_module("drivers", ctx.workload["driver"])
    out = driver.run(ctx)
    res = spec.result(bench, ctx, out, device_info(torch, cell["chips"], out))
    bad = isolation.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    rec = out["record"]
    print(f"# card: {card_label()}", file=sys.stderr)
    print(f"# glibc keeps freed host memory (mallopt): {allocator}", file=sys.stderr)
    print(f"# calls {len(rec['calls'])}, frames {rec['frames_done']} of {rec['frames_sent']}, "
          f"window {rec['window_s']:.3f} s, set-up {rec['setup_s']:.3f} s", file=sys.stderr)
    for k, v in sorted(out.get("counts", {}).items()):
        print(f"# {k}: {v}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
