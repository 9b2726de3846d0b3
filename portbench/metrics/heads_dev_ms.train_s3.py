"""heads_dev_ms.train_s3: device time of the kernels launched inside the
program's "a3d.train.mask_head" and "a3d.train.plane_head" ranges (the two
trained ROI heads' forward), per traced step."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("calls") or "spans" not in tr:
        return None
    us = sum(tr["spans"].get(n, {}).get("kernel_us", 0.0)
             for n in ("train.mask_head", "train.plane_head"))
    return us / len(tr["calls"]) * 1e-3 if us > 0 else None
