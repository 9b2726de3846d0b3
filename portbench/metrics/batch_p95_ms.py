"""batch_p95_ms: the 95th percentile, over every call in the window, of the
host wall from the call's start to its returned FramePredictions."""

import numpy as np


def read(record):
    walls = [c["wall"] for c in record["calls"]]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
