"""The whole search request against the card's peak: the least time of
the search requests answered by the window's close (as
``search_kernels_roofline``) over the traced window's seconds, in
percent."""

from bench.lib import yardstick


def read(rec: dict) -> float | None:
    dev = rec["device"]
    end = rec["t0"] + rec["seconds"]
    done = [r for r in rec["requests"] if r["t1"] <= end]
    if not done or dev is None:
        return None
    return 100.0 * yardstick.requests_least_s(done, rec["config"]["dim"]) / dev["window_s"]
