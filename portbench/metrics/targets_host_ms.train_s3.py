"""targets_host_ms.train_s3: host wall of the program's spans
"train.sample_rois" (ROI labelling and sampling) and "train.mask_targets"
(the GT mask crops, with their waits) per stage-3 step, from the
recorder's window (no profiler).  Stage 3 computes no RPN targets."""

SPANS = ("train.sample_rois", "train.mask_targets")


def read(record):
    prog = record.get("program")
    if not prog or not prog.get("calls"):
        return None
    spans = prog["spans"]
    if not any(k in spans for k in SPANS):
        return None
    return sum(spans.get(k, {}).get("wall_s", 0.0) for k in SPANS) / prog["calls"] * 1e3
