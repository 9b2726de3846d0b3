"""mfu.train: the FLOPs of the window's training steps (`counts/train_flops.py`:
forward of every module, backward of the trained ones, the box head on the
sampled ROIs, counted at the judged steps' mean) over the untraced window's
host time, against 989 TFLOP/s (bf16 dense).  The traced windows are not
used: the profiler stretches every step."""

from portbench.counts import train_flops
from portbench.peaks import BF16_FLOPS


def read(record):
    calls = record["calls"]
    if record["window_s"] <= 0 or not calls or not record.get("rois_per_step"):
        return None
    inp = record["config"]["input"]
    per_step = train_flops.total(inp["height"], inp["width"], calls[0]["frames"],
                                 round(record["rois_per_step"]))
    return 100.0 * per_step * len(calls) / record["window_s"] / BF16_FLOPS
