"""Queries answered in the window over the window's seconds: every query
of every search request whose answer was in host memory by the window's
close (host clock)."""


def read(rec: dict) -> float | None:
    if not rec["requests"]:
        return None
    end = rec["t0"] + rec["seconds"]
    return sum(r["nq"] for r in rec["requests"] if r["t1"] <= end) / rec["seconds"]
