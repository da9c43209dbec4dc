"""Kernels (``kernels/l2_topk.py``, ``kernels/merge_topk.py``, ``csrc/``):
the least time of the search requests answered by the window's close
(``yardstick.search_least_s`` from the shapes handed in: the larger of the
products at the TF32 rate and the bytes at the HBM rate) over the seconds
in which the card ran anything in the traced window, in percent.  The
busy time holds every device activity of the window (in a cell with a
writer, the write path's too, and the work of a request still in flight
at the close), so this reads low rather than high and cannot pass 100."""

from bench.lib import yardstick


def read(rec: dict) -> float | None:
    dev = rec["device"]
    end = rec["t0"] + rec["seconds"]
    done = [r for r in rec["requests"] if r["t1"] <= end]
    if not done or dev is None or dev["busy_s"] <= 0:
        return None
    return 100.0 * yardstick.requests_least_s(done, rec["config"]["dim"]) / dev["busy_s"]
