"""k1_roofline.train_s3: the summed least time of the traced stage-3 steps'
three K1 calls (the box pool, 7x7 aligned; the mask pool, 14x14 sampling
ratio 2; the plane pool, 14x14 uncapped; float32 maps;
`counts/roi_align.py`, from the pooled boxes and sampled flags) over the
summed device time of the kernels named `roi_align_fwd_kernel`."""

from portbench.counts import flops, roi_align

KERNEL = "roi_align_fwd_kernel"


def read(record):
    tr = record.get("trace")
    if not tr or not tr.get("pools"):
        return None
    kernel_us = sum(v for k, v in tr["device_ops_us"].items() if KERNEL in k)
    if kernel_us <= 0:
        return None
    inp = record["config"]["input"]
    pyr = flops.pyramid(inp["height"], inp["width"])
    shapes = [pyr[f"p{l}"] for l in (2, 3, 4, 5)]
    bound = sum(roi_align.bound_seconds(shapes, c["boxes"], c["valid"], c["p"], c["ratio"],
                                        c["aligned"], in_bytes=4)[0] for c in tr["pools"])
    return 100.0 * bound / (kernel_us * 1e-6)
