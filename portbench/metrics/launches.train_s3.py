"""launches.train_s3: device operations (kernels and copies) per stage-3
training step in the traced window (`torch.profiler`), read as
`launches.train` reads them."""

from portbench import spec

read = spec.load_module("metrics", "launches.train").read
