"""device_idle_pct.train_s3: share of the traced stage-3 window in which no
operation ran on the device, read as `device_idle_pct.train` reads it."""

from portbench import spec

read = spec.load_module("metrics", "device_idle_pct.train").read
