"""The 95th percentile of every search request's latency in the window:
host clock from the call to the answer in host memory, over all requests
sent in the window (numpy's linear interpolation)."""

import numpy as np


def read(rec: dict) -> float | None:
    if not rec["requests"]:
        return None
    return float(np.percentile([(r["t1"] - r["t0"]) * 1e3 for r in rec["requests"]], 95))
