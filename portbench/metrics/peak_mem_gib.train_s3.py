"""peak_mem_gib.train_s3: `torch.cuda.max_memory_allocated` over the set-up
and the warm-up steps of the stage-3 cell, before the harness copies any
judged step's state, in GiB, read as `peak_mem_gib.train` reads it."""

from portbench import spec

read = spec.load_module("metrics", "peak_mem_gib.train").read
