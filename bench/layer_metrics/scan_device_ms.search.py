"""Kernels (``kernels/l2_topk.py``, ``csrc/``): the mean per request of the
device time of the port's ``scan_<class>`` spans, each the time the CUDA
stream took between two events recorded around one execution class's
launches, summed over classes and nodes.  Read beside
``device_idle.search`` from the same traced window: None without a device
trace, and where the program's scan spans carry no device time."""


def read(rec: dict) -> float | None:
    traces = [r["trace"] for r in rec["requests"] if r["trace"] is not None]
    if rec["device"] is None or not traces:
        return None
    per_request = []
    for t in traces:
        scans = [getattr(s, "device_us", None) for s in t.walk() if s.name.startswith("scan_")]
        if any(d is None for d in scans):
            return None
        per_request.append(sum(scans))
    if not any(per_request):
        return None
    return sum(per_request) / len(per_request) / 1e3
