"""Rows acknowledged in the window, over the seconds from the window's
start to the last acknowledgement inside it (host clock).  Dividing by
that acknowledgement's time rather than the whole window keeps the rate
from stepping by a whole batch's rows with where the window's close falls
inside the next call."""


def read(rec: dict) -> float | None:
    end = rec["t0"] + rec["seconds"]
    acked = [i for i in rec["inserts"] if i["t1"] <= end]
    if not acked:
        return None
    last = max(i["t1"] for i in acked)
    return sum(i["rows"] for i in acked) / (last - rec["t0"])
