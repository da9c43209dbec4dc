"""Observability plane: metrics, traces, events (after
``repro.core.telemetry``, which needs numpy alone; the port adds device
counters and device-timed spans, read back from the card only when they
are read).

Three cooperating primitives, all process-local and allocation-light:

``MetricsRegistry``
    Counters, gauges, and fixed log-bucket histograms.  Histograms are
    backed by a single numpy count array per series; recording a value
    is two array ops (bucket index + in-place add), and percentile
    read-out interpolates within the winning bucket.  A counter may also
    be fed a device tensor (``inc_device``): it stays on the device until
    the registry is read.  ``snapshot()`` produces plain-Python rows (see
    ``core.request.MetricsSnapshot``) and ``export()`` renders Prometheus
    text format.

``TraceContext`` / ``Span`` / ``RequestTrace``
    Per-request span trees.  A context is allocated at the proxy only
    when ``SearchRequest(trace=True)`` — every hot-path call site guards
    with ``if trace is not None`` so the disabled cost is one branch.
    Durations use an injectable ``perf_counter``; each span's start is on
    the Unix-epoch clock that ``torch.profiler`` stamps its host events
    with, so spans line up with a device trace.  A span timed with a CUDA
    device also carries the device time between its two ends.  Tracing
    carries node ids, segment ids, and rows scanned so chaos tests can
    assert the tree bit-for-bit matches what was executed.

``EventLog``
    Bounded ring of typed control-plane events (node death, CAS
    retries, drain steps, hot-swaps, GC reaps, pump progress).  Event
    timestamps come from an injectable clock — the system's manual
    clock in cooperative tests — so event history is deterministic.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "MetricsRegistry",
    "Histogram",
    "TraceContext",
    "Span",
    "RequestTrace",
    "Event",
    "EventLog",
]


# --------------------------------------------------------------------------
# histograms
# --------------------------------------------------------------------------

# Fixed log-spaced bucket edges shared by every histogram: 60 buckets per
# decade-ish span covering 1us .. ~100s when values are in microseconds
# (and equally serviceable for row counts).  A shared layout keeps each
# series to one small int64 array and makes merging snapshots trivial.
_N_BUCKETS = 64
_LOG_LO = 0.0   # log10(1.0)
_LOG_HI = 8.0   # log10(1e8)
_LOG_STEP = (_LOG_HI - _LOG_LO) / _N_BUCKETS
# Upper edge of each bucket (bucket i covers (edge[i-1], edge[i]]).
BUCKET_EDGES = np.logspace(
    _LOG_LO + _LOG_STEP, _LOG_HI, _N_BUCKETS, dtype=np.float64
)


class Histogram:
    """Fixed log-bucket histogram: record is ~two numpy ops."""

    __slots__ = ("name", "counts", "total", "sum")

    def __init__(self, name: str) -> None:
        self.name = name
        self.counts = np.zeros(_N_BUCKETS, dtype=np.int64)
        self.total = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        if value < 1.0:
            idx = 0
        else:
            idx = min(int(math.log10(value) / _LOG_STEP), _N_BUCKETS - 1)
        self.counts[idx] += 1
        self.total += 1
        self.sum += value

    def record_many(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return
        idx = np.clip(
            (np.log10(np.maximum(v, 1.0)) / _LOG_STEP).astype(np.int64),
            0,
            _N_BUCKETS - 1,
        )
        np.add.at(self.counts, idx, 1)
        self.total += int(v.size)
        self.sum += float(v.sum())

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) by bucket interpolation."""
        if self.total == 0:
            return 0.0
        rank = q / 100.0 * self.total
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank, side="left"))
        idx = min(idx, _N_BUCKETS - 1)
        hi = BUCKET_EDGES[idx]
        lo = BUCKET_EDGES[idx - 1] if idx > 0 else 0.0
        in_bucket = int(self.counts[idx])
        if in_bucket == 0:
            return float(hi)
        below = int(cum[idx]) - in_bucket
        frac = (rank - below) / in_bucket
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0


# --------------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------------


class MetricsRegistry:
    """Process-local named counters, gauges, and histograms.

    Series names follow Prometheus convention (``snake_case``); an
    optional ``labels`` dict is folded into the series key so e.g.
    per-node counters stay one dict lookup on the hot path.
    """

    def __init__(self) -> None:
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}
        # Device counts not read back yet (``inc_device``), by series key.
        self._pending: dict[str, torch.Tensor] = {}
        self._pending_lock = threading.Lock()

    # -- series key ----------------------------------------------------
    @staticmethod
    def _key(name: str, labels: dict | None) -> str:
        if not labels:
            return name
        inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
        return f"{name}{{{inner}}}"

    # -- recording -----------------------------------------------------
    def inc(self, name: str, value: float = 1.0, labels: dict | None = None) -> None:
        key = self._key(name, labels)
        self._counters[key] = self._counters.get(key, 0.0) + value

    def inc_device(self, name: str, value: torch.Tensor, labels: dict | None = None) -> None:
        """Add a count that is still on the device (a 0-d tensor) without
        reading it back: it joins the counter when the registry is read."""
        key = self._key(name, labels)
        with self._pending_lock:
            prev = self._pending.get(key)
            self._pending[key] = value if prev is None else prev + value

    def _fold(self) -> None:
        """Read the pending device counts back into their counters."""
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for key, value in pending.items():
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, labels: dict | None = None) -> None:
        self._gauges[self._key(name, labels)] = float(value)

    def observe(self, name: str, value: float, labels: dict | None = None) -> None:
        key = self._key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(key)
        h.record(value)

    def histogram(self, name: str, labels: dict | None = None) -> Histogram:
        key = self._key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(key)
        return h

    # -- read-out ------------------------------------------------------
    def counter_value(self, name: str, labels: dict | None = None) -> float:
        self._fold()
        return self._counters.get(self._key(name, labels), 0.0)

    def gauge_value(self, name: str, labels: dict | None = None) -> float:
        return self._gauges.get(self._key(name, labels), 0.0)

    def snapshot_rows(self):
        """Return (counters, gauges, histogram rows) in plain Python.

        Histogram rows are tuples ``(name, count, mean, p50, p95, p99)``.
        The typed wrapper lives in ``core.request.MetricsSnapshot``.
        """
        self._fold()
        counters = dict(sorted(self._counters.items()))
        gauges = dict(sorted(self._gauges.items()))
        hists = []
        for key in sorted(self._histograms):
            h = self._histograms[key]
            hists.append(
                (
                    key,
                    int(h.total),
                    float(h.mean),
                    float(h.percentile(50)),
                    float(h.percentile(95)),
                    float(h.percentile(99)),
                )
            )
        return counters, gauges, hists

    def export(self) -> str:
        """Render all series in Prometheus text exposition format."""
        self._fold()
        lines: list[str] = []
        seen_meta: set[str] = set()

        def base_name(key: str) -> str:
            return key.split("{", 1)[0]

        for key, v in sorted(self._counters.items()):
            base = base_name(key)
            if base not in seen_meta:
                lines.append(f"# TYPE {base} counter")
                seen_meta.add(base)
            lines.append(f"{key} {v:g}")
        for key, v in sorted(self._gauges.items()):
            base = base_name(key)
            if base not in seen_meta:
                lines.append(f"# TYPE {base} gauge")
                seen_meta.add(base)
            lines.append(f"{key} {v:g}")
        for key in sorted(self._histograms):
            h = self._histograms[key]
            base = base_name(key)
            if base not in seen_meta:
                lines.append(f"# TYPE {base} summary")
                seen_meta.add(base)
            for q in (50, 95, 99):
                qkey = (
                    f'{base}{{quantile="0.{q}"}}'
                    if "{" not in key
                    else key[:-1] + f',quantile="0.{q}"}}'
                )
                lines.append(f"{qkey} {h.percentile(q):g}")
            lines.append(f"{key}_sum {h.sum:g}")
            lines.append(f"{key}_count {h.total}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------


class Span:
    """One timed step of a request: a node-side scan, a hedge, a reduce.

    ``start_ns`` is on the Unix-epoch clock of ``torch.profiler``'s host
    events; ``duration_us`` is host time.  ``device_us`` is the time the
    CUDA stream took from the span's start to its end (None where the span
    was not timed on a card), and ``rows_scanned`` may be set to a count
    still on the device: both are read back the first time they are read,
    never on the request's path."""

    __slots__ = ("name", "node_id", "segment_ids", "duration_us", "detail",
                 "children", "start_ns", "_rows", "_device")

    def __init__(
        self,
        name: str,
        node_id: str | None = None,
        segment_ids: tuple[int, ...] = (),
        duration_us: float = 0.0,
        rows_scanned: int = 0,
        detail: str = "",
        children: "list[Span] | None" = None,
        start_ns: int = 0,
    ) -> None:
        self.name = name
        self.node_id = node_id
        self.segment_ids = segment_ids
        self.duration_us = duration_us
        self._rows = rows_scanned
        self.detail = detail
        self.children = [] if children is None else children
        self.start_ns = start_ns
        # (start, end) CUDA events until first read, then microseconds.
        self._device: "tuple[torch.cuda.Event, torch.cuda.Event] | float | None" = None

    @property
    def rows_scanned(self) -> int:
        if not isinstance(self._rows, int):
            self._rows = int(self._rows)
        return self._rows

    @rows_scanned.setter
    def rows_scanned(self, value) -> None:
        self._rows = value

    @property
    def device_us(self) -> float | None:
        if isinstance(self._device, tuple):
            start, end = self._device
            end.synchronize()
            self._device = start.elapsed_time(end) * 1e3
        return self._device

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "node_id": self.node_id,
            "segment_ids": [int(s) for s in self.segment_ids],
            "start_ns": int(self.start_ns),
            "duration_us": float(self.duration_us),
            "device_us": self.device_us,
            "rows_scanned": self.rows_scanned,
            "detail": self.detail,
            "children": [c.to_dict() for c in self.children],
        }


@dataclass
class RequestTrace:
    """The finished span tree attached to SearchResult/MutationResult."""

    request_id: int
    kind: str  # "search" | "mutation"
    root: Span

    def walk(self):
        stack = [self.root]
        while stack:
            s = stack.pop()
            yield s
            stack.extend(reversed(s.children))

    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> dict:
        return {
            "request_id": int(self.request_id),
            "kind": self.kind,
            "root": self.root.to_dict(),
        }

    def format(self) -> str:
        lines: list[str] = []

        def fmt(span: Span, depth: int) -> None:
            pad = "  " * depth
            bits = [f"{pad}{span.name}", f"+{(span.start_ns - t0) / 1e3:.0f}us"]
            if span.node_id:
                bits.append(f"node={span.node_id}")
            if span.segment_ids:
                bits.append(f"segments={list(span.segment_ids)}")
            if span.rows_scanned:
                bits.append(f"rows={span.rows_scanned}")
            bits.append(f"{span.duration_us:.0f}us")
            if span.device_us is not None:
                bits.append(f"device={span.device_us:.0f}us")
            if span.detail:
                bits.append(span.detail)
            lines.append(" ".join(bits))
            for c in span.children:
                fmt(c, depth + 1)

        t0 = self.root.start_ns
        fmt(self.root, 0)
        return "\n".join(lines)


class TraceContext:
    """Mutable trace builder threaded through one request.

    Hot paths hold ``trace: TraceContext | None`` and guard every use
    with ``if trace is not None`` — no object is allocated when tracing
    is off.  ``perf_counter`` is injectable for deterministic tests.  The
    root span starts when the context is made; spans' starts are the
    ``perf_counter`` mapped onto ``time.time_ns()``'s clock at that moment,
    so one request's spans nest exactly.
    """

    _next_id = 0

    __slots__ = ("request_id", "kind", "root", "perf_counter", "_epoch_ns", "_t0")

    def __init__(self, kind: str, perf_counter=time.perf_counter) -> None:
        TraceContext._next_id += 1
        self.request_id = TraceContext._next_id
        self.kind = kind
        self.perf_counter = perf_counter
        self._t0 = perf_counter()
        self._epoch_ns = time.time_ns() - round(self._t0 * 1e9)
        self.root = Span(name=kind, start_ns=self._ns(self._t0))

    def _ns(self, t: float) -> int:
        return self._epoch_ns + round(t * 1e9)

    def span(
        self,
        name: str,
        parent: Span | None = None,
        node_id: str | None = None,
        segment_ids=(),
        detail: str = "",
    ) -> Span:
        s = Span(
            name=name,
            node_id=node_id,
            segment_ids=tuple(int(x) for x in segment_ids),
            detail=detail,
            start_ns=self._ns(self.perf_counter()),
        )
        (parent if parent is not None else self.root).children.append(s)
        return s

    def timed(self, span: Span, device: torch.device | None = None):
        """Context manager stamping ``start_ns`` on entry and
        ``duration_us`` on exit; with a CUDA ``device``, also CUDA events
        on its current stream at both ends, for ``device_us``."""
        cuda = device is not None and device.type == "cuda"
        return _SpanTimer(self, span, device if cuda else None)

    def finish(self, duration_us: float | None = None) -> RequestTrace:
        """The finished tree; the root lasts ``duration_us``, by default
        from the context's making until now.  Reads nothing back from a
        device."""
        if duration_us is None:
            duration_us = (self.perf_counter() - self._t0) * 1e6
        self.root.duration_us = duration_us
        return RequestTrace(request_id=self.request_id, kind=self.kind, root=self.root)


class _SpanTimer:
    __slots__ = ("ctx", "span", "device", "t0", "events")

    def __init__(self, ctx: TraceContext, span: Span, device) -> None:
        self.ctx = ctx
        self.span = span
        self.device = device

    def __enter__(self) -> Span:
        self.t0 = self.ctx.perf_counter()
        self.span.start_ns = self.ctx._ns(self.t0)
        if self.device is not None:
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return self.span

    def __exit__(self, *exc) -> None:
        if self.device is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
            self.span._device = self.events
        self.span.duration_us = (self.ctx.perf_counter() - self.t0) * 1e6


# --------------------------------------------------------------------------
# control-plane event log
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Event:
    """One typed control-plane event."""

    ts_ms: float
    kind: str
    source: str
    detail: dict

    def to_dict(self) -> dict:
        return {
            "ts_ms": float(self.ts_ms),
            "kind": self.kind,
            "source": self.source,
            "detail": {k: _jsonable(v) for k, v in self.detail.items()},
        }


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (set, frozenset)):
        return sorted(_jsonable(x) for x in v)
    return v


class EventLog:
    """Bounded ring buffer of control-plane events.

    ``clock`` supplies timestamps (``now_ms()``) — the system's manual
    clock in cooperative tests, wall clock in threaded mode — so event
    history is deterministic where the system is.
    """

    def __init__(self, clock, capacity: int = 4096) -> None:
        self.clock = clock
        self.capacity = capacity
        self._events: list[Event] = []
        self.dropped = 0

    def emit(self, kind: str, source: str, **detail) -> Event:
        ev = Event(
            ts_ms=float(self.clock.now_ms()),
            kind=kind,
            source=source,
            detail=detail,
        )
        self._events.append(ev)
        if len(self._events) > self.capacity:
            overflow = len(self._events) - self.capacity
            del self._events[:overflow]
            self.dropped += overflow
        return ev

    def query(self, since_ts: float | None = None, kind: str | None = None) -> list[Event]:
        out = self._events
        if since_ts is not None:
            out = [e for e in out if e.ts_ms >= since_ts]
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        return list(out)

    def __len__(self) -> int:
        return len(self._events)
