"""setup_s: seconds from the start of the process to the start of the
measured window (loading, weights, warm-up; in a fresh checkout also the
kernels' nvcc build)."""


def read(record):
    return record["setup_s"]
