"""backward_dev_ms.train_s3: device time of the kernels launched, from any
thread, while the program's "a3d.train.backward" range was open (autograd
runs a CUDA backward in its own threads), per traced stage-3 step."""


def read(record):
    tr = record.get("trace")
    us = (tr or {}).get("spans", {}).get("train.backward", {}).get("kernel_us", 0.0)
    return us / len(tr["calls"]) * 1e-3 if us > 0 and tr.get("calls") else None
