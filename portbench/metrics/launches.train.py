"""launches.train: device operations (kernels and copies) per training step
in the traced window (`torch.profiler`)."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("calls") or tr["device_op_count"] <= 0:
        return None
    return tr["device_op_count"] / len(tr["calls"])
