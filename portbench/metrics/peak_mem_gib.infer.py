"""peak_mem_gib.infer: `torch.cuda.max_memory_allocated` over the warm-up
and the window, in GiB."""


def read(record):
    b = record.get("memory_peak_bytes", 0)
    return b / 2 ** 30 if b > 0 else None
