"""mfu.train_s3: the FLOPs of the window's stage-3 steps
(`counts/train_s3_flops.py`: the frozen forward, the box head on the
sampled ROIs, the mask and plane heads forward and backward on the
foreground ROIs, the depth decoder forward and backward, counted at the
judged steps' means) over the untraced window's host time, against 989
TFLOP/s (bf16 dense).  The traced windows are not used: the profiler
stretches every step."""

from portbench.counts import train_s3_flops
from portbench.peaks import BF16_FLOPS


def read(record):
    calls = record["calls"]
    if (record["window_s"] <= 0 or not calls or not record.get("rois_per_step")
            or record.get("fg_rois_per_step") is None):
        return None
    inp = record["config"]["input"]
    per_step = train_s3_flops.total(inp["height"], inp["width"], calls[0]["frames"],
                                    round(record["rois_per_step"]),
                                    round(record["fg_rois_per_step"]))
    return 100.0 * per_step * len(calls) / record["window_s"] / BF16_FLOPS
