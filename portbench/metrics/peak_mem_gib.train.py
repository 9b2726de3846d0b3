"""peak_mem_gib.train: `torch.cuda.max_memory_allocated` over the set-up and
the warm-up steps, before the harness copies any judged step's state, in
GiB."""


def read(record):
    b = record.get("memory_peak_bytes", 0)
    return b / 2 ** 30 if b > 0 else None
