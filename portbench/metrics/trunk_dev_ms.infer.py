"""trunk_dev_ms.infer: device time of the kernels launched inside the
backbone's span (`models/resnet.py`, `models/fpn.py`) per step."""


def read(record):
    span = record.get("trace", {}).get("spans", {}).get("backbone")
    if not span or not span["n"] or span["kernel_us"] <= 0:
        return None
    return span["kernel_us"] / span["n"] * 1e-3
