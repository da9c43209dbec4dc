"""Query node (``core/query_node.py``): the mean per request of the port's
``serve_wait`` spans, the time each dispatch waited for its node's serve
lock (held by the pump thread's step of that node: the log applied, the
interim slice indexes built), summed over the nodes a request dispatched
to.  Read beside ``device_idle.search`` from the same traced window: None
without a device trace, and where the program has no such span."""


def read(rec: dict) -> float | None:
    traces = [r["trace"] for r in rec["requests"] if r["trace"] is not None]
    if rec["device"] is None or not traces:
        return None
    waits = [[s.duration_us for s in t.walk() if s.name == "serve_wait"] for t in traces]
    if not any(waits):
        return None
    return sum(sum(w) for w in waits) / len(waits) / 1e3
