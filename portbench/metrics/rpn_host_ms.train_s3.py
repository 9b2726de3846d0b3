"""rpn_host_ms.train_s3: host wall of the program's span "train.rpn" (the
frozen RPN head and the train-mode proposal selection with its NMS) per
stage-3 step, from the recorder's window, read as `rpn_host_ms.train`
reads it."""

from portbench import spec

read = spec.load_module("metrics", "rpn_host_ms.train").read
