"""Facade and proxy (``core/manu.py``, ``core/proxy.py``,
``core/request.py``): the mean per request of the port's own request
trace's root span less its ``dispatch`` children (``SearchRequest(
trace=True)`` in the traced run): the proxy's planning, routing and
consistency waits.  The root span ends before the proxy's global merge."""

DISPATCH = ("dispatch", "hedge_dispatch")


def read(rec: dict) -> float | None:
    own = [(t.root.duration_us - sum(c.duration_us for c in t.root.children if c.name in DISPATCH)) / 1e3
           for t in (r["trace"] for r in rec["requests"]) if t is not None]
    return sum(own) / len(own) if own else None
