"""rpn_host_ms.train: host wall of the program's span "train.rpn" (the RPN
head and the train-mode proposal selection with its NMS, `models/rpn.py`
and `ops/nms.py`, waits included) per step, from the recorder's window (no
profiler)."""


def read(record):
    prog = record.get("program")
    if not prog or not prog.get("calls"):
        return None
    span = prog["spans"].get("train.rpn")
    if not span:
        return None
    return span["wall_s"] / prog["calls"] * 1e3
