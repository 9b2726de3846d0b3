"""Training: targets and losses, the optimizer, the step, checkpoints and
the host loop (`Trainer`)."""
