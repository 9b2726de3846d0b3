"""k1_roofline.infer: the summed least time of the traced window's K1 calls
(`ops/roi_align_cuda.py`, `csrc/roi_align_fwd.cu`; box, mask and plane
pools, from their boxes and valid flags: `counts/roi_align.py`) over the
summed device time of the kernels named `roi_align_fwd_kernel`."""

from portbench.counts import flops, roi_align

KERNEL = "roi_align_fwd_kernel"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    kernel_us = sum(v for k, v in tr["device_ops_us"].items() if KERNEL in k)
    if kernel_us <= 0 or not tr["k1_calls"]:
        return None
    inp = record["config"]["input"]
    pyr = flops.pyramid(inp["height"], inp["width"])
    shapes = [pyr[f"p{l}"] for l in (2, 3, 4, 5)]
    in_bytes = 2 if record["config"]["model"]["dtype"] == "bfloat16" else 4
    bound = sum(roi_align.bound_seconds(shapes, c["boxes"], c["valid"], c["p"], c["ratio"],
                                        c["aligned"], in_bytes=in_bytes)[0]
                for c in tr["k1_calls"])
    return 100.0 * bound / (kernel_us * 1e-6)
