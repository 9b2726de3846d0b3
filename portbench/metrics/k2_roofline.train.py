"""k2_roofline.train: the summed least time of the traced steps' K2 calls
(the training box pool's adjoint, `csrc/roi_align_adj.cu`, one a step;
`counts/roi_align_adj.py`, from the pooled boxes and sampled flags) over
the summed device time of the kernels named `roi_align_adj_kernel`."""

from portbench.counts import flops, roi_align_adj

KERNEL = "roi_align_adj_kernel"


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
    bound = sum(roi_align_adj.bound_seconds(shapes, c["boxes"], c["valid"], c["p"], c["ratio"],
                                            c["aligned"])[0] for c in tr["pools"])
    return 100.0 * bound / (kernel_us * 1e-6)
