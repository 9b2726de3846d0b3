"""head_fg_share.train_s3: the share of the rows the trained ROI heads are
given that take a loss: the foreground rows of the recorder window's kept
ROI samples (summed on the device after the window) over the program's
counter "train.head_rows" (B x S a step) over the same steps, in %."""


def read(record):
    prog = record.get("program")
    if not prog:
        return None
    rows = prog["counters"].get("train.head_rows", 0)
    if rows <= 0 or "head_fg_rows" not in prog:
        return None
    return 100.0 * prog["head_fg_rows"] / rows
