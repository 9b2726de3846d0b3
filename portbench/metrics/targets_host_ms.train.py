"""targets_host_ms.train: host wall of the program's spans "train.rpn_targets"
(anchor matching and sampling) and "train.sample_rois" (ROI labelling and
sampling) per step, from the recorder's window (no profiler)."""


def read(record):
    prog = record.get("program")
    if not prog or not prog.get("calls"):
        return None
    spans = prog["spans"]
    if "train.rpn_targets" not in spans and "train.sample_rois" not in spans:
        return None
    wall = sum(spans.get(k, {}).get("wall_s", 0.0)
               for k in ("train.rpn_targets", "train.sample_rois"))
    return wall / prog["calls"] * 1e3
