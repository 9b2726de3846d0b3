"""frames_per_s: frames whose FramePredictions were returned, over the
whole window (host clock)."""


def read(record):
    return record["frames_done"] / record["window_s"]
