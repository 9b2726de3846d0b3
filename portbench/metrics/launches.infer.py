"""launches.infer: device operations (kernels and copies) per call in the
traced window (`torch.profiler`); `portbench/program_trace.py` splits
them by the program's innermost "a3d.*" span."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("calls") or tr["device_op_count"] <= 0:
        return None
    return tr["device_op_count"] / len(tr["calls"])
