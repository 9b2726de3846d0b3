"""mask_targets_dev_ms.train_s3: device time of the kernels launched inside
the program's "a3d.train.mask_targets" range (the GT masks' 28x28 crops
over the batch), per traced step."""


def read(record):
    tr = record.get("trace")
    us = (tr or {}).get("spans", {}).get("train.mask_targets", {}).get("kernel_us", 0.0)
    return us / len(tr["calls"]) * 1e-3 if us > 0 and tr.get("calls") else None
