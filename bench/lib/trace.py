"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler records the whole measured window, which the harness marks
with a ``record_function("window")`` range, and the benchmark's own ranges
around its calls into the program (``search``, ``insert``, ``embed``,
``writer``).  From its raw records (no per-op aggregation):

- ``busy_s``: the union of the intervals in which a device activity
  (kernel, copy, set) ran, within the window;
- ``device_ops``: the device activities that took the most time, by name;
- ``idle_gaps``: the seconds of the window in which the device ran
  nothing, summed by the benchmark range the host was in (the innermost
  one open at the gap's middle; ``other`` where none was: the system's own
  threads, the harness's loop).

The idle-share reading follows ``chip_smoke.profile_request`` (device
busy over a host-timed span); the per-op sums there count kernel records
only for the same reason: an op's record carries its kernels' time too.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

RANGES = ("search", "insert", "embed", "writer")
WINDOW = "window"
NEST = 8


def _ns(event, what: str) -> float:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(event, f"{what}_us")()) * 1e3


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_events(events, top: int = 10) -> dict | None:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` from the
    profiler's raw events; None where the trace holds no window or no
    device activity (the profiler recorded nothing on the card)."""
    from torch.autograd import DeviceType

    window = None
    ranges: list[tuple[float, float, str]] = []
    device: list[tuple[float, float, str]] = []
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            # A range opened on the host is mirrored on the device's timeline
            # as an annotation: it ran nothing there.
            if name not in RANGES and name != WINDOW:
                device.append((start, start + dur, name))
        elif name == WINDOW:
            window = (start, start + dur)
        elif name in RANGES:
            ranges.append((start, start + dur, name))
    if window is None or not device:
        return None
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    busy = _merge([(a, b) for a, b, _n in inside])
    by_op: dict[str, float] = {}
    for a, b, n in inside:
        by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e9
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_range: dict[str, float] = {}
    ranges.sort()
    starts = [r[0] for r in ranges]
    for a, b in gaps:
        mid = (a + b) / 2
        label = "other"
        # The latest-opened range that holds the middle: ranges nest at most
        # two deep (writer > insert) on each of the two client threads.
        i = bisect.bisect_right(starts, mid)
        for r0, r1, n in reversed(ranges[max(0, i - NEST):i]):
            if r1 >= mid:
                label = n
                break
        by_range[label] = by_range.get(label, 0.0) + (b - a) / 1e9
    rank = lambda d: sorted(([n[:120], s] for n, s in d.items()), key=lambda p: -p[1])[:top]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": rank(by_op),
        "idle_gaps": rank(by_range),
    }


class DeviceTrace:
    """``torch.profiler`` over a window when ``enabled``; ``read()`` after
    it closes."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = self._stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.synchronize()
        return self._stack.__exit__(*exc)

    def read(self) -> dict | None:
        if self.prof is None:
            return None
        return read_events(self.prof.profiler.kineto_results.events())
