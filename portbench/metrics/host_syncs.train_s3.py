"""host_syncs.train_s3: the program's host waits on the device per stage-3
step, the sum of its "sync.*" counters in the recorder's window, read as
`host_syncs.train` reads them (the RPN's anchors, the pixel statistics,
the per-image keys, the readback, and one wait an image in the GT crops,
"sync.train_mask_targets")."""

from portbench import spec

read = spec.load_module("metrics", "host_syncs.train").read
