"""The readers of the port's request spans (``serve_wait_ms.search``,
``untraced_ms.search``, ``scan_device_ms.search``) on hand-built traces:
their values, and nothing where the run has no device trace or the
program's spans lack what they read."""

from types import SimpleNamespace

import pytest

from bench.lib import spec
from repro_torch.core.telemetry import RequestTrace

DEVICE = {"busy_s": 0.5, "window_s": 1.0, "device_ops": [], "idle_gaps": []}


def _span(name, start_us, dur_us, device_us=None, children=()):
    """A span as the port's reads once its CUDA events are resolved."""
    return SimpleNamespace(name=name, start_ns=1_700_000_000 * 10**9 + round(start_us * 1e3),
                           duration_us=dur_us, device_us=device_us, children=list(children))


def _trace(wait_us: float, scan_device_us: float) -> RequestTrace:
    """A root of 1,000 us: a consistency wait [0, 50], a dispatch [100,
    800] holding a serve wait, a plan and a scan that overlaps the plan
    by 20 us, and the proxy's merge [850, 900]: 200 us of it no leaf
    covers ([50, 100], [100 + wait, ...] up to the plan, [800, 850],
    [900, 1000])."""
    dispatch = _span("dispatch", 100, 700, children=[
        _span("serve_wait", 100, wait_us),
        _span("plan_search", 100 + wait_us, 300 - wait_us),
        _span("scan_brute_sealed", 380, 420, device_us=scan_device_us),
    ])
    root = _span("search", 0, 1000, children=[
        _span("consistency_wait", 0, 50), dispatch, _span("merge_topk", 850, 50, device_us=5.0)])
    return RequestTrace(request_id=1, kind="search", root=root)


def _rec(traces, device=DEVICE):
    return {"device": device, "requests": [{"trace": t} for t in traces]}


def _read(name, rec):
    return spec.metric_reader(name)(rec)


def test_readers_average_over_requests():
    rec = _rec([_trace(10.0, 300.0), _trace(30.0, 500.0), None])
    assert _read("serve_wait_ms.search", rec) == pytest.approx(0.020)
    assert _read("scan_device_ms.search", rec) == pytest.approx(0.400)
    assert _read("untraced_ms.search", rec) == pytest.approx(0.200)


def test_untraced_time_counts_overlapping_leaves_once_and_clips_to_the_root():
    t = _trace(0.0, 1.0)
    t.root.children.append(_span("fetch_fields", 950, 200))  # past the root's end
    assert _read("untraced_ms.search", _rec([t])) == pytest.approx(0.150)


@pytest.mark.parametrize("name", ["serve_wait_ms.search", "untraced_ms.search", "scan_device_ms.search"])
def test_nothing_without_a_device_trace(name):
    assert _read(name, _rec([_trace(10.0, 300.0)], device=None)) is None
    assert _read(name, _rec([None])) is None


def test_nothing_where_the_program_lacks_the_spans_fields():
    # A program whose spans carry no start, no device time and no
    # serve_wait span (the port before these spans existed).
    def old(name, dur, children=()):
        return SimpleNamespace(name=name, duration_us=dur, children=list(children))

    root = old("search", 1000, [old("dispatch", 700, [old("plan_search", 300), old("scan_brute_sealed", 400)])])

    def walk():
        stack = [root]
        while stack:
            s = stack.pop()
            yield s
            stack.extend(reversed(s.children))

    rec = _rec([SimpleNamespace(root=root, walk=walk)])
    for name in ("serve_wait_ms.search", "untraced_ms.search", "scan_device_ms.search"):
        assert _read(name, rec) is None
    # On the CPU the scan spans carry no device time.
    assert _read("scan_device_ms.search", _rec([_trace(10.0, None)])) is None
