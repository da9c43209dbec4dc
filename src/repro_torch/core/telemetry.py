"""Zero-dependency observability plane: metrics, traces, events (a copy of
``repro.core.telemetry``; pure Python and numpy, no device state).

Three cooperating primitives, all process-local and allocation-light:

``MetricsRegistry``
    Counters, gauges, and fixed log-bucket histograms.  Histograms are
    backed by a single numpy count array per series; recording a value
    is two array ops (bucket index + in-place add), and percentile
    read-out interpolates within the winning bucket.  ``snapshot()``
    produces plain-Python rows (see ``core.request.MetricsSnapshot``)
    and ``export()`` renders Prometheus text format.

``TraceContext`` / ``Span`` / ``RequestTrace``
    Per-request span trees.  A context is allocated at the proxy only
    when ``SearchRequest(trace=True)`` — every hot-path call site guards
    with ``if trace is not None`` so the disabled cost is one branch.
    Durations use an injectable ``perf_counter``; tracing carries node
    ids, segment ids, and rows scanned so chaos tests can assert the
    tree bit-for-bit matches what was executed.

``EventLog``
    Bounded ring of typed control-plane events (node death, CAS
    retries, drain steps, hot-swaps, GC reaps, pump progress).  Event
    timestamps come from an injectable clock — the system's manual
    clock in cooperative tests — so event history is deterministic.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

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
        return self._counters.get(self._key(name, labels), 0.0)

    def gauge_value(self, name: str, labels: dict | None = None) -> float:
        return self._gauges.get(self._key(name, labels), 0.0)

    def snapshot_rows(self):
        """Return (counters, gauges, histogram rows) in plain Python.

        Histogram rows are tuples ``(name, count, mean, p50, p95, p99)``.
        The typed wrapper lives in ``core.request.MetricsSnapshot``.
        """
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


@dataclass
class Span:
    """One timed step of a request: a node-side scan, a hedge, a reduce."""

    name: str
    node_id: str | None = None
    segment_ids: tuple[int, ...] = ()
    duration_us: float = 0.0
    rows_scanned: int = 0
    detail: str = ""
    children: list["Span"] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "node_id": self.node_id,
            "segment_ids": [int(s) for s in self.segment_ids],
            "duration_us": float(self.duration_us),
            "rows_scanned": int(self.rows_scanned),
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
            bits = [f"{pad}{span.name}"]
            if span.node_id:
                bits.append(f"node={span.node_id}")
            if span.segment_ids:
                bits.append(f"segments={list(span.segment_ids)}")
            if span.rows_scanned:
                bits.append(f"rows={span.rows_scanned}")
            bits.append(f"{span.duration_us:.0f}us")
            if span.detail:
                bits.append(span.detail)
            lines.append(" ".join(bits))
            for c in span.children:
                fmt(c, depth + 1)

        fmt(self.root, 0)
        return "\n".join(lines)


class TraceContext:
    """Mutable trace builder threaded through one request.

    Hot paths hold ``trace: TraceContext | None`` and guard every use
    with ``if trace is not None`` — no object is allocated when tracing
    is off.  ``perf_counter`` is injectable for deterministic tests.
    """

    _next_id = 0

    __slots__ = ("request_id", "kind", "root", "perf_counter")

    def __init__(self, kind: str, perf_counter=time.perf_counter) -> None:
        TraceContext._next_id += 1
        self.request_id = TraceContext._next_id
        self.kind = kind
        self.root = Span(name=kind)
        self.perf_counter = perf_counter

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
        )
        (parent if parent is not None else self.root).children.append(s)
        return s

    def timed(self, span: Span):
        """Context manager stamping ``duration_us`` on exit."""
        return _SpanTimer(span, self.perf_counter)

    def finish(self, duration_us: float) -> RequestTrace:
        self.root.duration_us = duration_us
        return RequestTrace(request_id=self.request_id, kind=self.kind, root=self.root)


class _SpanTimer:
    __slots__ = ("span", "perf_counter", "t0")

    def __init__(self, span: Span, perf_counter) -> None:
        self.span = span
        self.perf_counter = perf_counter

    def __enter__(self) -> Span:
        self.t0 = self.perf_counter()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.duration_us = (self.perf_counter() - self.t0) * 1e6


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
