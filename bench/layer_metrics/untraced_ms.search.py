"""Whole search request: the mean per request of the time the port's
request trace leaves unexplained, the root span's duration less the union
of its leaf spans' ``[start_ns, start_ns + duration]`` (the leaves tile
what the program measured: consistency waits, serve-lock waits, tombstone
sets, plans, scans, merges, hydration).  Read beside
``device_idle.search`` from the same traced window: None without a device
trace, and where the program's spans carry no start."""


def _union_ns(intervals: list[tuple[float, float]]) -> float:
    covered, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            covered += b - max(a, end)
            end = b
    return covered


def _untraced_ms(trace) -> float | None:
    root = trace.root
    r0 = getattr(root, "start_ns", None)
    if r0 is None:
        return None
    # Offsets from the root's start: epoch nanoseconds overflow a double's
    # 53 bits.
    end = root.duration_us * 1e3
    leaves = [(max(s.start_ns - r0, 0), min(s.start_ns - r0 + s.duration_us * 1e3, end))
              for s in trace.walk() if s is not root and not s.children]
    return (end - _union_ns([(a, b) for a, b in leaves if b > a])) / 1e6


def read(rec: dict) -> float | None:
    traces = [r["trace"] for r in rec["requests"] if r["trace"] is not None]
    if rec["device"] is None or not traces:
        return None
    gaps = [_untraced_ms(t) for t in traces]
    if any(g is None for g in gaps):
        return None
    return sum(gaps) / len(gaps)
