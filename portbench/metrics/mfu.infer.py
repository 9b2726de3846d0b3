"""mfu.infer: model FLOPs the window's frames need (`counts/flops.py`:
trunk, FPN, RPN and depth per frame, the box head per valid proposal and
the cascade per valid detection, as `pool_valid` counts them) over the
untraced window's host time, against 989 TFLOP/s (bf16 dense).  The
traced window is not used: the profiler stretches every call."""

from portbench.counts import flops
from portbench.peaks import BF16_FLOPS


def read(record):
    if record["window_s"] <= 0 or not record["frames_done"]:
        return None
    inp = record["config"]["input"]
    pv = record["pool_valid"]
    total = flops.inference_flops(inp["height"], inp["width"], record["frames_done"],
                                  pv.get("box", 0), pv.get("mask", pv.get("shared", 0)))
    return 100.0 * total / record["window_s"] / BF16_FLOPS
