"""Declarative search and mutation requests (paper §3.1 Table 2, §6.4);
mirrors ``repro.core.request``.  Query vectors may be numpy arrays or
tensors: :class:`AnnsQuery` holds them as a float32 tensor, and query nodes
move them to their device.  Mutation rows are host numpy (WAL payloads): an
insert or upsert given tensors (an ``Embedder``'s rows on the card) copies
each column to the host once, when the request is made.

The read path is driven by one typed object instead of a kwarg chain:
a :class:`SearchRequest` carries the top-k budget, the consistency
requirement (a named level OR an explicit staleness / session
timestamp), an attribute filter, an optional radius cut (range search),
the output fields to hydrate, and one-or-more :class:`AnnsQuery`
sub-requests — one per vector field.  Multi-vector (hybrid) requests
fuse the per-field results with a :class:`Ranker` (weighted-sum over
normalized similarities, or reciprocal-rank fusion).

The proxy translates schema field names into segment *column* names
(the first vector field is stored as the primary ``"vector"`` column,
additional vector fields ride the extras columns under their own
names) and ships a :class:`NodeSearchRequest` to every query node —
the single object that replaces the old seven-positional-kwarg chain.

The *write* path mirrors the same design (paper §4.2): one typed
:class:`InsertRequest` / :class:`DeleteRequest` / :class:`UpsertRequest`
flows client → proxy → logger → WAL, and every mutation answers with a
:class:`MutationResult` whose ``watermark_ts`` plugs directly into a
SESSION-consistency read (``SearchRequest(session_ts=...)``) — the
delta-consistency handshake between writes and reads.  Upserts travel as
a single WAL record carrying both the delete-by-pk and the insert half,
so old/new row visibility flips atomically at one LSN.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .collection import FieldType, Metric, Schema
from .consistency import ConsistencyLevel, GuaranteeTs, staleness_ms_of
from .segment import DEFAULT_PARTITION

#: Segment column name of the first (primary) vector field.
PRIMARY_VECTOR_COLUMN = "vector"


def vector_column_of(schema: Schema, field: str | None) -> str:
    """Map a schema vector-field name to its segment column name.
    ``None`` means "the primary vector field" (resolved per collection —
    see :class:`AnnsQuery`)."""
    if field is None or field == schema.vector_fields()[0].name:
        return PRIMARY_VECTOR_COLUMN
    return field


# ---------------------------------------------------------------------------
# Typed mutations (the write-path twin of SearchRequest)
# ---------------------------------------------------------------------------


def host_rows(rows: dict) -> dict:
    """``rows`` with every tensor column copied to a host numpy array: the
    log backbone that carries them is host memory."""
    return {
        name: col.detach().cpu().numpy() if torch.is_tensor(col) else col
        for name, col in rows.items()
    }


@dataclass
class MutationResult:
    """What every mutation hands back instead of a bare LSN.

    ``watermark_ts`` is the request's LSN — feed it to a SESSION
    :class:`SearchRequest` (``session_ts=watermark_ts``) for
    read-your-writes.  ``shard_lsns`` lists the WAL channels the request
    actually touched (the paper assigns ONE LSN per request — row-level
    ACID — so every touched shard shares it).  ``pks`` are the primary
    keys assigned (insert/upsert) or accepted for deletion; ``ack_rows``
    counts rows acknowledged into the WAL (0 for a no-op delete).
    """

    op: str  # "insert" | "delete" | "upsert"
    pks: np.ndarray
    shard_lsns: dict[int, int]
    watermark_ts: int
    row_count: int
    ack_rows: int
    # Span tree for this mutation when requested via ``trace=True`` on
    # the mutate call (see core.telemetry.RequestTrace); None otherwise.
    trace: object | None = None

    def session_request(
        self, queries, field: str | None = None, **kw
    ) -> "SearchRequest":
        """A read-your-writes follow-up read pinned at this watermark.
        ``field=None`` targets the collection's primary vector field,
        resolved against the schema when the request executes."""
        kw.setdefault("consistency", ConsistencyLevel.SESSION)
        return SearchRequest.single(
            queries, field=field, session_ts=self.watermark_ts, **kw
        )


@dataclass
class MutationRequest:
    """Base of the typed write surface; subclasses set ``op``."""

    op = "mutation"

    def validate(self, schema: Schema) -> None:  # pragma: no cover - interface
        """Early rejection against cached metadata (paper §3.2)."""


@dataclass
class InsertRequest(MutationRequest):
    """One insert batch, optionally placed into a named partition."""

    rows: dict[str, np.ndarray]
    partition: str = DEFAULT_PARTITION
    trace: bool = False  # attach a RequestTrace to the MutationResult
    op = "insert"

    def __post_init__(self):
        self.rows = host_rows(self.rows)

    def validate(self, schema: Schema) -> None:
        from .collection import validate_rows

        validate_rows(schema, self.rows)


@dataclass
class DeleteRequest(MutationRequest):
    """Delete by primary key (global: pks are partition-independent)."""

    pks: np.ndarray
    trace: bool = False  # attach a RequestTrace to the MutationResult
    op = "delete"

    def __post_init__(self):
        self.pks = np.atleast_1d(np.asarray(self.pks))

    def validate(self, schema: Schema) -> None:
        if self.pks.ndim != 1:
            raise ValueError(f"delete pks must be 1-D, got shape {self.pks.shape}")


@dataclass
class UpsertRequest(MutationRequest):
    """Insert-or-replace by primary key.

    Travels the WAL as ONE record per shard carrying the delete-by-pk
    half and the insert half, so MVCC visibility of the old and new row
    versions flips atomically at the record's single LSN.  Batches
    without an explicit pk column degrade to plain inserts (fresh
    auto-IDs cannot collide, so there is nothing to replace).
    """

    rows: dict[str, np.ndarray]
    partition: str = DEFAULT_PARTITION
    trace: bool = False  # attach a RequestTrace to the MutationResult
    op = "upsert"

    def __post_init__(self):
        self.rows = host_rows(self.rows)

    def validate(self, schema: Schema) -> None:
        from .collection import validate_rows

        validate_rows(schema, self.rows)


@dataclass
class AnnsQuery:
    """One per-vector-field sub-request of a (possibly hybrid) search.

    ``field=None`` means "the collection's primary vector field" and is
    resolved against the schema at validation/dispatch time (requests
    built without a schema in hand — e.g. ``MutationResult.
    session_request`` — stay collection-agnostic).  ``weight`` scales
    this field's contribution during fusion.  ``params`` may override
    request-level knobs per field (``radius`` / ``range_filter``).
    """

    field: str | None
    queries: "np.ndarray | torch.Tensor"  # [nq, dim] float32
    weight: float = 1.0
    params: dict = dc_field(default_factory=dict)

    def __post_init__(self):
        q = torch.as_tensor(self.queries, dtype=torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2:
            raise ValueError(f"queries must be [nq, dim], got shape {tuple(q.shape)}")
        self.queries = q

    def radius(self, default: float | None) -> float | None:
        return self.params.get("radius", default)

    def range_filter(self, default: float | None) -> float | None:
        return self.params.get("range_filter", default)


@dataclass(frozen=True)
class Ranker:
    """Hybrid fusion strategy for multi-vector requests.

    * ``weighted`` — fused score is the weight-scaled sum of per-field
      similarities normalized into (0, 1]: L2 ``1/(1+d)``, cosine
      ``(1+s)/2``, IP ``1/(1+exp(-s))``.  Candidates absent from a
      field's list contribute nothing for that field.
    * ``rrf`` — reciprocal-rank fusion: ``sum_f w_f / (rrf_k + rank_f)``
      with 1-based ranks within each field's result list.
    """

    kind: str = "weighted"  # "weighted" | "rrf"
    rrf_k: float = 60.0

    def __post_init__(self):
        if self.kind not in ("weighted", "rrf"):
            raise ValueError(f"unknown ranker kind '{self.kind}'")

    @staticmethod
    def weighted() -> "Ranker":
        return Ranker("weighted")

    @staticmethod
    def rrf(k: float = 60.0) -> "Ranker":
        return Ranker("rrf", rrf_k=k)


@dataclass
class SearchRequest:
    """The full declarative read request (client -> proxy)."""

    anns: list[AnnsQuery]
    k: int = 10
    consistency: ConsistencyLevel | None = None
    staleness_ms: float | None = None  # explicit tau overrides ``consistency``
    session_ts: int = 0  # read-your-writes watermark (session consistency)
    filter: object | None = None  # str | FilterExpr over attribute fields
    # Filtered-search strategy override: None = selectivity-adaptive
    # planning (the default); "pre" | "post" | "brute" force one strategy
    # for every (segment, filter) unit — the benchmark / equivalence-test
    # surface, not something clients normally set.
    filter_strategy: str | None = None
    radius: float | None = None  # range search outer bound
    range_filter: float | None = None  # range search inner bound
    output_fields: tuple[str, ...] = ()
    # Partition pruning: restrict the scan to these partitions (empty =
    # every partition).  The query-node planner skips non-matching
    # segments before any distance work happens.
    partition_names: tuple[str, ...] = ()
    time_travel_ts: int | None = None
    ranker: Ranker = dc_field(default_factory=Ranker)
    # Per-request tracing: when True the proxy allocates a TraceContext
    # and attaches the finished span tree as ``SearchResult.trace``.
    # Off by default — the disabled cost is one branch per call site.
    trace: bool = False

    def __post_init__(self):
        if isinstance(self.anns, AnnsQuery):
            self.anns = [self.anns]
        self.anns = list(self.anns)
        if not self.anns:
            raise ValueError("SearchRequest needs at least one AnnsQuery")
        self.output_fields = tuple(self.output_fields)
        if isinstance(self.partition_names, str):
            self.partition_names = (self.partition_names,)
        self.partition_names = tuple(self.partition_names)
        nqs = {len(a.queries) for a in self.anns}
        if len(nqs) != 1:
            raise ValueError(f"sub-requests disagree on query count: {sorted(nqs)}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.filter_strategy not in (None, "pre", "post", "brute"):
            raise ValueError(
                f"unknown filter_strategy '{self.filter_strategy}' "
                "(expected None, 'pre', 'post' or 'brute')"
            )

    # ------------------------------------------------------------- helpers
    @classmethod
    def single(
        cls, queries, field: str | None = "vector", **kw
    ) -> "SearchRequest":
        """The common one-vector-field case (None = primary vector field)."""
        return cls(anns=[AnnsQuery(field, queries)], **kw)

    @property
    def nq(self) -> int:
        return len(self.anns[0].queries)

    @property
    def is_hybrid(self) -> bool:
        return len(self.anns) > 1

    def resolve_staleness_ms(
        self, default_ms: float, bounded_ms: float = 2_000.0
    ) -> float:
        """Explicit tau > named level > system default.  ``bounded_ms`` is
        the deployment's BOUNDED staleness window (``ManuConfig.
        bounded_staleness_ms``), threaded through so the named level is a
        tunable, not a constant."""
        if self.staleness_ms is not None:
            return self.staleness_ms
        if self.consistency is not None:
            return staleness_ms_of(self.consistency, bounded_ms)
        return default_ms

    def validate(self, schema: Schema) -> None:
        """Early rejection against cached metadata (paper §3.2)."""
        primary_vec = schema.vector_fields()[0].name
        for a in self.anns:
            if a.field is None:
                fs = schema.vector_fields()[0]
            else:
                fs = schema.field(a.field)  # KeyError for unknown fields
            if fs.dtype is not FieldType.VECTOR:
                raise ValueError(
                    f"anns field '{a.field}' is {fs.dtype.value}, not a vector field"
                )
            if a.queries.shape[1] != fs.dim:
                raise ValueError(
                    f"anns field '{a.field}' expects dim {fs.dim}, "
                    f"got {a.queries.shape[1]}"
                )
        seen = set()
        for a in self.anns:
            name = a.field if a.field is not None else primary_vec
            if name in seen:
                raise ValueError(f"duplicate anns field '{name}'")
            seen.add(name)
        for f in self.output_fields:
            if f != "pk":
                schema.field(f)
        # radius/range_filter ordering depends on the collection metric;
        # the proxy rejects empty windows in ``_check_range_bounds``.


@dataclass
class NodeSearchRequest:
    """What travels proxy -> query node: field names already resolved to
    segment column names, consistency resolved to a pinned guarantee.

    Deliberately WITHOUT the radius bounds: the range cut runs once at the
    proxy on the globally merged per-field list (a node-local cut would
    make results depend on segment placement under an inner bound)."""

    collection: str
    k: int
    metric: Metric
    guarantee: GuaranteeTs
    anns: list[AnnsQuery]  # .field holds the segment COLUMN name here
    # The compiled filter expression (FilterExpr), shipped once per request;
    # query nodes resolve it locally — sealed segments through their
    # attribute-index satellites, growing rows by row-wise evaluation.
    filter: object | None = None
    # Strategy override from SearchRequest.filter_strategy (None = adaptive).
    filter_strategy: str | None = None
    # Legacy proxy-materialized bitmaps (segment_id -> row mask), still
    # honored when present: ANDed into visibility before planning.
    filter_masks: "dict[int, torch.Tensor] | None" = None
    # None = no pruning; otherwise only segments tagged with one of these
    # partitions enter the plan.
    partitions: tuple[str, ...] | None = None
    # Replica-aware dispatch scope: None = every segment the node holds
    # (legacy full fan-out); a tuple = scan only these live sealed segments
    # (() = growing/channel data only).  Retired MVCC versions are exempt
    # from the scope — they are node-local epoch baggage that pinned
    # queries must still reach regardless of where replicas moved.
    segments: tuple[int, ...] | None = None
    # Growing-scan scope, the channel twin of ``segments``: None = every
    # growing copy the node holds (legacy full fan-out); a tuple of DML
    # channel names = scan only the growing segments fed by those channels
    # (() = sealed data only).  Watermark-aware routing relies on this: a
    # node dispatched for sealed units must NOT serve a lagging growing
    # copy of a channel the plan routed to a fresher replica — per-node
    # tombstones would resurrect rows deleted before the wait target.
    channels: tuple[str, ...] | None = None
    # Trace propagation: (TraceContext, parent Span) when the request is
    # traced; the node hangs plan/scan/reduce child spans off the parent.
    trace: tuple | None = None
    # True for hedge re-dispatches — the node books the search under
    # ``searches_hedged`` so least-loaded picks see primary load only.
    hedged: bool = False

    @classmethod
    def from_request(
        cls,
        schema: Schema,
        collection: str,
        request: SearchRequest,
        metric: Metric,
        guarantee: GuaranteeTs,
        filter=None,
        filter_masks: dict[int, np.ndarray] | None = None,
        segments: tuple[int, ...] | None = None,
        channels: tuple[str, ...] | None = None,
        trace: tuple | None = None,
        hedged: bool = False,
    ) -> "NodeSearchRequest":
        anns = [
            AnnsQuery(
                vector_column_of(schema, a.field), a.queries, a.weight, dict(a.params)
            )
            for a in request.anns
        ]
        return cls(
            collection=collection,
            k=request.k,
            metric=metric,
            guarantee=guarantee,
            anns=anns,
            filter=filter,
            filter_strategy=request.filter_strategy,
            filter_masks=filter_masks,
            partitions=request.partition_names or None,
            segments=segments,
            channels=channels,
            trace=trace,
            hedged=hedged,
        )


# ---------------------------------------------------------------------------
# Typed cluster-admin surface (read-only snapshots)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeStatus:
    """One query node as the control loop sees it.

    ``status`` is the HealthMonitor's observation: ``healthy`` /
    ``suspect`` (missed more than half a heartbeat TTL) / ``dead`` (lease
    expired) / ``draining`` (graceful scale-down in progress).  ``load``
    is the replica count used by least-loaded placement decisions.
    """

    node_id: str
    status: str
    load: int
    segments: tuple[tuple[str, int], ...]
    channels: tuple[str, ...]
    searches: int = 0
    # Hedge accounting split: primaries drive the load picker; hedges are
    # duplicated work and must not inflate a node's apparent traffic.
    searches_primary: int = 0
    searches_hedged: int = 0


@dataclass(frozen=True)
class SegmentPlacement:
    """One sealed segment's committed replica group.  ``replicas[0]`` is
    the primary; ``visible_from_ts`` is the MVCC epoch pin that rides
    along on every reassignment; ``under_replicated`` records graceful
    degradation when the cluster is smaller than the replication factor."""

    collection: str
    segment_id: int
    replicas: tuple[str, ...]
    under_replicated: bool
    visible_from_ts: int


@dataclass(frozen=True)
class ClusterState:
    """Frozen point-in-time snapshot of the serving tier, returned by
    ``ManuSystem.cluster_state()`` — node health, per-node load, the
    segment -> replica-set placement map, and the under-replication count
    the reconciler is working to drive to zero."""

    nodes: tuple[NodeStatus, ...]
    placement: tuple[SegmentPlacement, ...]
    under_replicated: int
    replication_factor: int

    def node(self, node_id: str) -> NodeStatus:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        raise KeyError(f"unknown query node '{node_id}'")

    def replicas_of(self, collection: str, segment_id: int) -> tuple[str, ...]:
        for p in self.placement:
            if p.collection == collection and p.segment_id == segment_id:
                return p.replicas
        return ()

    @property
    def live_node_ids(self) -> tuple[str, ...]:
        return tuple(n.node_id for n in self.nodes if n.status != "dead")


@dataclass(frozen=True)
class HistogramRow:
    """One histogram series in a :class:`MetricsSnapshot` — count, mean,
    and the interpolated p50/p95/p99 estimates from the log buckets."""

    name: str
    count: int
    mean: float
    p50: float
    p95: float
    p99: float

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "count": int(self.count),
            "mean": float(self.mean),
            "p50": float(self.p50),
            "p95": float(self.p95),
            "p99": float(self.p99),
        }


@dataclass(frozen=True)
class MetricsSnapshot:
    """Frozen point-in-time read-out of the telemetry registry, returned
    by ``ManuSystem.metrics()`` — the metrics twin of ``ClusterState``.

    ``counters``/``gauges`` map fully-labelled series keys (Prometheus
    ``name{label="v"}`` form) to values; ``histograms`` carry typed
    percentile rows.  Everything is plain Python, so the snapshot JSON
    round-trips via ``to_dict()``.
    """

    ts_ms: float
    counters: dict
    gauges: dict
    histograms: tuple[HistogramRow, ...]

    def counter(self, key: str, default: float = 0.0) -> float:
        return self.counters.get(key, default)

    def gauge(self, key: str, default: float = 0.0) -> float:
        return self.gauges.get(key, default)

    def histogram(self, key: str) -> HistogramRow | None:
        for h in self.histograms:
            if h.name == key:
                return h
        return None

    def to_dict(self) -> dict:
        return {
            "ts_ms": float(self.ts_ms),
            "counters": {k: float(v) for k, v in self.counters.items()},
            "gauges": {k: float(v) for k, v in self.gauges.items()},
            "histograms": [h.to_dict() for h in self.histograms],
        }


@dataclass(frozen=True)
class IndexDescription:
    """Declared index of one vector field."""

    field: str
    kind: str
    params: dict
    metric: Metric


@dataclass(frozen=True)
class DescribeCollection:
    """Frozen schema + placement description of one collection, returned
    by ``ManuCollection.describe()``."""

    name: str
    fields: tuple
    partitions: tuple[str, ...]
    indexes: tuple[IndexDescription, ...]
    num_entities: int
    num_shards: int
    metric: Metric
    replication_factor: int

    def index_on(self, field: str) -> IndexDescription | None:
        for ix in self.indexes:
            if ix.field == field:
                return ix
        return None
