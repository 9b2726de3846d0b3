"""backward_dev_ms.train: device time of the kernels launched, from any
thread, while the program's "a3d.train.backward" range was open (autograd
runs a CUDA backward in its own threads), per traced step."""


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("calls") or tr.get("backward_kernel_us", 0) <= 0:
        return None
    return tr["backward_kernel_us"] / len(tr["calls"]) * 1e-3
