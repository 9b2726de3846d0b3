"""rpn_wall_ms.infer: host wall of the proposal generator's span
(`models/rpn.py` with `ops/nms.py`) per step, from the traced run."""


def read(record):
    span = record.get("trace", {}).get("spans", {}).get("proposal_generator")
    if not span or not span["n"]:
        return None
    return span["cpu_us"] / span["n"] * 1e-3
