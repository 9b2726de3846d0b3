"""host_syncs.train: the program's host waits on the device per step, the
sum of its "sync.*" counters in the recorder's window."""


def read(record):
    prog = record.get("program")
    if not prog or not prog.get("calls"):
        return None
    return sum(v for k, v in prog["counters"].items() if k.startswith("sync.")) / prog["calls"]
