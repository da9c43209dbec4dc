"""ManuSystem: wires the full architecture and exposes the PyManu-style API
(paper Table 2); mirrors ``repro.core.manu``.

    manu = ManuSystem(ManuConfig(num_query_nodes=2))          # device="cuda"
    coll = manu.create_collection("products", dim=128)
    coll.insert({"vector": vecs})
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 64})
    res = coll.search(queries, limit=10, staleness_ms=100.0)

Two driving modes, as in the reference:

* **cooperative** (default) -- every API call pumps the component state
  machines until quiescent, and consistency waits advance the clock and
  emit time-ticks explicitly.  This is what the tests use.
* **threaded** (``ManuConfig(threaded=True, manual_clock=False)``) -- a
  pump thread steps every component but the index nodes and the loggers
  tick on the wall clock; a build thread steps the index nodes, so a build
  never holds up the query nodes (the reference's one pump thread does);
  a watchdog thread heartbeats and reconciles; searches block on
  watermarks.  ``start_threads`` / ``stop_threads`` start and join them
  (the constructor starts them).  An exception in one thread stops them
  all and is raised again by the next wait or by ``stop_threads``.

Query and index nodes keep their columns and indexes on ``device`` (the
card unless the caller passes ``device="cpu"``); loggers, data nodes,
coordinators and the stores are host work.  Search results hold scores and
pks as tensors on that device and hydrated fields as host arrays.

The object store, meta store and log broker are composed as the
reference composes them, ``Retrying(Faulty(real))``: the fault plane
(``core/faults.py``) injects at the boundary when an injector is given, and
the retry plane (``core/retry.py``) absorbs the transients; with no
injector every call passes through.  Maintenance (compaction, GC,
time-travel checkpoints) and recovery (``kill_*`` / ``restart_*``,
``recover_failures``, ``restart``) are the reference's.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass

import numpy as np

from .._device import resolve_device
from .binlog import (
    attr_key,
    read_binlog_column,
    read_binlog_meta,
    rebuild_attr_satellites,
)
from .collection import CollectionInfo, FieldSchema, FieldType, Metric, Schema
from .compaction import CompactionCoordinator, CompactionNode, GCReaper, prune_folded
from .consistency import ConsistencyLevel, GuaranteeTs
from .coordinator import (
    DataCoordinator,
    IndexCoordinator,
    QueryCoordinator,
    RootCoordinator,
)
from .data_node import DataNode
from .faults import (
    Crash,
    FaultInjector,
    FaultyLogBroker,
    FaultyMetaStore,
    FaultyObjectStore,
)
from .index_node import IndexNode
from .log import COORD_CHANNEL, EntryType, LogBroker, LogEntry, dml_channel
from .logger_node import Logger
from .meta_store import MetaStore
from .object_store import MemoryObjectStore, ObjectStore
from .proxy import Proxy, SearchResult
from .query_node import QueryNode
from .retry import (
    RetryingLogBroker,
    RetryingMetaStore,
    RetryingObjectStore,
    RetryPolicy,
)
from .scheduler import (
    AdmissionRejected,  # noqa: F401 — re-exported API surface
    BatchingProxy,
    MutationTicket,
    RequestScheduler,
)
from .request import (
    AnnsQuery,
    ClusterState,
    DeleteRequest,
    DescribeCollection,
    HistogramRow,
    IndexDescription,
    InsertRequest,
    MetricsSnapshot,
    MutationRequest,
    MutationResult,
    NodeStatus,
    Ranker,
    SearchRequest,
    SegmentPlacement,
    UpsertRequest,
    vector_column_of,
)
from .segment import DEFAULT_PARTITION
from .telemetry import Event, EventLog, MetricsRegistry
from .time_travel import RestoredCollection, TimeTravel
from .timestamp import INFINITE_STALENESS, TSO, Clock, ManualClock, pack


@dataclass
class ManuConfig:
    num_shards: int = 2
    num_loggers: int = 2
    num_data_nodes: int = 1
    num_index_nodes: int = 1
    num_query_nodes: int = 2
    num_compaction_nodes: int = 1
    seal_rows: int = 8_192
    slice_rows: int = 2_048
    compaction_delete_ratio: float = 0.2
    compaction_small_fraction: float = 0.5
    gc_retention_ms: float = 0.0  # 0 = horizon may advance to "now"
    tick_interval_ms: float = 50.0
    default_staleness_ms: float = INFINITE_STALENESS
    # BOUNDED consistency's staleness window (ms).
    bounded_staleness_ms: float = 2_000.0
    # Serving-tier ingest scheduler: per-(collection, shard) queue credit,
    # depth trigger and age trigger (see ``repro.core.manu.ManuConfig``).
    ingest_queue_rows: int = 8_192
    ingest_flush_rows: int = 1_024
    ingest_flush_ms: float = 20.0
    manual_clock: bool = True
    threaded: bool = False
    pump_sleep_s: float = 0.002
    replication_factor: int = 1
    heartbeat_ttl_ms: float = 5_000.0
    reconcile_interval_s: float = 0.25  # threaded-mode watchdog cadence
    # Typed retry/backoff for object-store, meta-store and log-broker I/O
    # (None = the default policy); its seed drives the backoff jitter.
    retry_policy: "RetryPolicy | None" = None


#: How long ``stop_threads`` waits for a pump round to finish.
THREAD_JOIN_S = 60.0


def _serialized(method):
    """Run a control-plane call under the system's step lock, which the
    pump thread holds for each round: in threaded mode the coordinator
    messages the call publishes must not interleave with the pump thread's
    (the log takes a channel's entries in timestamp order).  Never wrap a
    call that waits for the pump thread."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._step_lock:
            return method(self, *args, **kwargs)

    return run


class ManuCollection:
    """ORM-style handle (PyManu's ``Collection``)."""

    def __init__(self, system: "ManuSystem", info: CollectionInfo):
        self.system = system
        self.info = info
        self.last_write_ts = 0

    @property
    def name(self) -> str:
        return self.info.name

    def mutate(self, request: MutationRequest) -> MutationResult:
        """Execute one typed mutation through the full pipeline
        (client -> proxy -> logger -> WAL) and return its
        :class:`MutationResult` watermark."""
        return self.system.mutate(self, request)

    def insert(
        self, rows, partition: str | None = None
    ) -> "int | MutationResult":
        """Insert a batch.

        Accepts either a typed :class:`InsertRequest` (returned value is
        its :class:`MutationResult`) or the legacy ``rows`` dict — a thin
        facade packing the dict into an ``InsertRequest`` and returning
        the bare LSN exactly as before; both run the same pipeline.
        """
        if isinstance(rows, InsertRequest):
            if partition is not None:
                raise ValueError(
                    "pass partition inside the InsertRequest, not as a kwarg"
                )
            return self.mutate(rows)
        return self.mutate(
            InsertRequest(rows, partition=partition or DEFAULT_PARTITION)
        ).watermark_ts

    def upsert(
        self, rows, partition: str | None = None
    ) -> MutationResult:
        """Insert-or-replace by primary key: ONE WAL record per shard
        carries the delete-by-pk and insert halves, so visibility flips
        atomically at ``MutationResult.watermark_ts``."""
        if isinstance(rows, UpsertRequest):
            if partition is not None:
                raise ValueError(
                    "pass partition inside the UpsertRequest, not as a kwarg"
                )
            return self.mutate(rows)
        return self.mutate(
            UpsertRequest(rows, partition=partition or DEFAULT_PARTITION)
        )

    def delete(self, pks) -> "int | MutationResult":
        """Delete by primary key.  A typed :class:`DeleteRequest` returns
        its :class:`MutationResult`; the legacy array form returns the
        bare LSN.  Empty or provably no-match deletes publish nothing and
        hand back an already-covered watermark."""
        if isinstance(pks, DeleteRequest):
            return self.mutate(pks)
        return self.mutate(DeleteRequest(np.asarray(pks))).watermark_ts

    # ----------------------------------------------------- async mutations
    def mutate_async(self, request: MutationRequest) -> MutationTicket:
        """Admit one typed mutation into the ingest scheduler's bounded
        write queue; returns a :class:`MutationTicket` immediately.  The
        WAL crossing happens at the next micro-batch flush (queue depth,
        age, or an explicit ``ticket.result()`` / ``system.flush_ingest()``).
        Raises :class:`AdmissionRejected` under backpressure."""
        return self.system.mutate_async(self, request)

    def insert_async(
        self, rows, partition: str | None = None
    ) -> MutationTicket:
        if isinstance(rows, InsertRequest):
            if partition is not None:
                raise ValueError(
                    "pass partition inside the InsertRequest, not as a kwarg"
                )
            return self.mutate_async(rows)
        return self.mutate_async(
            InsertRequest(rows, partition=partition or DEFAULT_PARTITION)
        )

    def upsert_async(
        self, rows, partition: str | None = None
    ) -> MutationTicket:
        if isinstance(rows, UpsertRequest):
            if partition is not None:
                raise ValueError(
                    "pass partition inside the UpsertRequest, not as a kwarg"
                )
            return self.mutate_async(rows)
        return self.mutate_async(
            UpsertRequest(rows, partition=partition or DEFAULT_PARTITION)
        )

    def delete_async(self, pks) -> MutationTicket:
        if isinstance(pks, DeleteRequest):
            return self.mutate_async(pks)
        return self.mutate_async(DeleteRequest(np.asarray(pks)))

    # ------------------------------------------------------------ partitions
    def create_partition(self, partition: str) -> None:
        """Register a named partition as a placement target for writes and
        a pruning target for ``SearchRequest.partition_names``."""
        self.system.create_partition(self.name, partition)

    def drop_partition(self, partition: str) -> dict:
        """Drop a partition and release its segments everywhere; their
        binlogs are reclaimed by the next GC cycle."""
        return self.system.drop_partition(self.name, partition)

    def partitions(self) -> list[str]:
        return self.system.root_coord.partitions(self.name)

    def create_index(self, field: str, kind: str, params: dict | None = None) -> None:
        fs = self.info.schema.field(field)  # KeyError for unknown fields
        if fs.dtype is not FieldType.VECTOR:
            raise ValueError(
                f"create_index targets vector fields; '{field}' is {fs.dtype.value}"
            )
        self.system._set_index_spec(self, field, kind, params)
        self.system._settle()

    def flush(self) -> None:
        """Seal all growing segments and wait for archive + index builds.
        Queued async writes drain into the WAL first, so a flush covers
        everything admitted before it."""
        self.system.scheduler.flush_writes(collection=self.name)
        self.system.data_coord.flush(self.name)
        self.system._drain()

    def compact(self) -> dict:
        """Run one compaction cycle (purge deletes, merge small segments)."""
        return self.system.compact(self.name)

    def gc(self, horizon_ts: int | None = None) -> dict:
        """Advance the retention horizon and reclaim old binlog/index objects."""
        return self.system.gc(self.name, horizon_ts)

    def search(
        self,
        queries=None,
        limit: int = 10,
        staleness_ms: float | None = None,
        read_your_writes: bool = False,
        filter_expr: str | None = None,
        time_travel_ts: int | None = None,
        hedge_timeout_s: float | None = None,
        consistency: ConsistencyLevel | None = None,
        radius: float | None = None,
        range_filter: float | None = None,
        output_fields=(),
        partition_names=(),
        request: SearchRequest | None = None,
    ) -> SearchResult:
        """Search the collection.

        Accepts either a declarative :class:`SearchRequest` (as ``queries``
        or the ``request`` kwarg) or the legacy kwarg surface, which is a
        thin facade: the kwargs are packed into a single-field
        ``SearchRequest`` and executed by the exact same pipeline.
        """
        if isinstance(queries, SearchRequest):
            request = queries
        if request is not None:
            # A declarative request carries every option itself; reject
            # stray legacy kwargs instead of silently dropping them.
            stray = {
                "limit": limit != 10,
                "staleness_ms": staleness_ms is not None,
                "read_your_writes": read_your_writes,
                "filter_expr": filter_expr is not None,
                "time_travel_ts": time_travel_ts is not None,
                "consistency": consistency is not None,
                "radius": radius is not None,
                "range_filter": range_filter is not None,
                "output_fields": bool(tuple(output_fields)),
                "partition_names": bool(tuple(partition_names)),
            }
            bad = [name for name, is_set in stray.items() if is_set]
            if bad:
                raise ValueError(
                    f"pass {bad} inside the SearchRequest, not as kwargs"
                )
        session_override = None
        if request is None:
            wants_session = (
                read_your_writes or consistency is ConsistencyLevel.SESSION
            )
            request = SearchRequest.single(
                queries,
                field=self.info.schema.vector_fields()[0].name,
                k=limit,
                consistency=consistency,
                staleness_ms=staleness_ms,
                session_ts=self.last_write_ts if wants_session else 0,
                filter=filter_expr,
                radius=radius,
                range_filter=range_filter,
                output_fields=tuple(output_fields),
                partition_names=tuple(partition_names),
                time_travel_ts=time_travel_ts,
            )
        elif (
            request.consistency is ConsistencyLevel.SESSION
            and request.session_ts == 0
        ):
            # SESSION with no explicit watermark reads this handle's last
            # write; passed as an override so the caller's request object is
            # never mutated (it may be reused across later writes).
            session_override = self.last_write_ts
        return self.system.search(
            self, request,
            hedge_timeout_s=hedge_timeout_s, session_ts=session_override,
        )

    def hybrid_search(
        self,
        anns: "list[AnnsQuery]",
        limit: int = 10,
        ranker: Ranker | None = None,
        **kw,
    ) -> SearchResult:
        """Multi-vector search: one AnnsQuery per vector field, fused by
        ``ranker`` (weighted-sum by default)."""
        request = SearchRequest(
            anns=anns, k=limit, ranker=ranker or Ranker.weighted(), **kw
        )
        return self.search(request)

    def query(self, queries: np.ndarray, limit: int, expr: str, **kw) -> SearchResult:
        """PyManu ``query``: vector search with boolean filter expression."""
        return self.search(queries, limit, filter_expr=expr, **kw)

    def describe(self) -> DescribeCollection:
        """Typed description of the collection: schema fields, partitions,
        declared indexes, entity count, sharding and replication — the
        structured replacement for picking through handle attributes."""
        specs = self.system.index_coord.index_specs(self.name)
        return DescribeCollection(
            name=self.name,
            fields=tuple(self.info.schema.fields),
            partitions=tuple(self.partitions()),
            indexes=tuple(
                IndexDescription(
                    field=f,
                    kind=s["kind"],
                    params=dict(s.get("params") or {}),
                    metric=Metric(s["metric"]),
                )
                for f, s in sorted(specs.items())
            ),
            num_entities=self.num_entities(),
            num_shards=self.info.num_shards,
            metric=self.info.metric,
            replication_factor=self.system.query_coord.replication_for(self.name),
        )

    def num_entities(self) -> int:
        """Rows of THIS collection across the cluster, counting each
        segment once even when replicated on several nodes (and preferring
        the sealed copy over a node's lingering growing twin)."""
        sealed_rows: dict[int, int] = {}
        growing_rows: dict[int, int] = {}
        for qn in self.system.query_nodes.values():
            if not qn.alive:
                continue
            for (_c, sid, is_sealed), n in qn.segment_rows(self.name).items():
                (sealed_rows if is_sealed else growing_rows)[sid] = n
        total = sum(sealed_rows.values())
        total += sum(n for sid, n in growing_rows.items() if sid not in sealed_rows)
        return total


class ManuSystem:
    def __init__(
        self,
        config: ManuConfig | None = None,
        store: ObjectStore | None = None,
        injector: FaultInjector | None = None,
        device="cuda",
    ):
        self.config = config or ManuConfig()
        if self.config.threaded and self.config.manual_clock:
            # A manual clock moves only when a cooperative wait advances it,
            # so the loggers would tick once and every wait would time out.
            raise ValueError("threaded mode ticks on the wall clock: pass manual_clock=False")
        self.device = resolve_device(device)
        self.clock: Clock = ManualClock(1_000_000) if self.config.manual_clock else Clock()
        self.tso = TSO(self.clock)

        # One metrics registry and one bounded control-plane event log per
        # system; every component records into the shared registry, the
        # control loops emit typed events.
        self.telemetry = MetricsRegistry()
        self.event_log = EventLog(self.clock)

        # Durable substrates, composed as Retrying(Faulty(real)).  These
        # three and the clock are all that survives ``restart()``; every
        # process is rebuilt from them.
        self.injector = injector
        raw_store: ObjectStore = store or MemoryObjectStore()
        raw_meta = MetaStore(self.clock)
        raw_broker = LogBroker()
        if injector is not None:
            injector.bind(metrics=self.telemetry, event_log=self.event_log, clock=self.clock)
            raw_store = FaultyObjectStore(raw_store, injector)
            raw_meta = FaultyMetaStore(raw_meta, injector)
            raw_broker = FaultyLogBroker(raw_broker, injector)
        # Backoff sleeps in threaded mode; cooperatively it is accounting only.
        policy = self.config.retry_policy or RetryPolicy()
        sleep = time.sleep if self.config.threaded else None
        self.store: ObjectStore = RetryingObjectStore(
            raw_store, policy, metrics=self.telemetry, event_log=self.event_log, sleep=sleep,
        )
        self.meta = RetryingMetaStore(
            raw_meta, policy, metrics=self.telemetry, event_log=self.event_log, sleep=sleep,
        )
        self.broker = RetryingLogBroker(
            raw_broker, policy, metrics=self.telemetry, event_log=self.event_log, sleep=sleep,
        )

        # Held by the pump thread for each round and by control-plane calls
        # (``_serialized``); reentrant, so cooperative calls pump under it.
        self._step_lock = threading.RLock()
        # One WAL append lock for every logger: LSN and publish stay one step.
        self._wal_lock = threading.Lock()
        self._build_processes()
        self.collections: dict[str, ManuCollection] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._thread_error: BaseException | None = None
        # Pump rounds done by the pump thread, and how many of the last ones
        # in a row made no progress (threaded ``wait_idle`` reads both).
        self._pump_rounds = 0
        self._quiet_rounds = 0
        if self.config.threaded:
            self.start_threads()

    def _build_processes(self) -> None:
        """Construct every Manu *process* — coordinators, worker nodes, the
        proxy — on top of the durable substrates.  Called at boot and again
        by ``restart()``: processes hold only soft state."""
        self.root_coord = RootCoordinator(self.broker, self.meta, self.tso)
        self.data_coord = DataCoordinator(self.broker, self.meta, self.tso, self.clock)
        self.index_coord = IndexCoordinator(
            self.broker, self.meta, self.tso, events=self.event_log
        )
        self.query_coord = QueryCoordinator(
            self.broker, self.meta, self.tso, self.data_coord,
            replication_factor=self.config.replication_factor,
            heartbeat_ttl_ms=self.config.heartbeat_ttl_ms,
            events=self.event_log,
        )

        self.loggers = [
            Logger(f"logger-{i}", self.broker, self.tso, self.data_coord, self.clock,
                   self.config.tick_interval_ms, metrics=self.telemetry, wal_lock=self._wal_lock)
            for i in range(self.config.num_loggers)
        ]
        self.data_nodes = [
            DataNode(f"dn-{i}", self.broker, self.store, self.tso, self.data_coord,
                     metrics=self.telemetry, wal_lock=self._wal_lock)
            for i in range(self.config.num_data_nodes)
        ]
        self.index_nodes = [self._new_index_node(f"in-{i}") for i in range(self.config.num_index_nodes)]
        self.compaction_coord = CompactionCoordinator(
            self.broker, self.meta, self.tso, self.data_coord, self.store,
            delete_ratio=self.config.compaction_delete_ratio,
            small_fraction=self.config.compaction_small_fraction,
            retention_ms=self.config.gc_retention_ms,
            events=self.event_log,
        )
        self.compaction_nodes = [
            CompactionNode(f"cn-{i}", self.broker, self.store, self.meta, self.tso,
                           metrics=self.telemetry)
            for i in range(self.config.num_compaction_nodes)
        ]
        self.gc_reaper = GCReaper(self.broker, self.store, self.meta, self.tso,
                                  metrics=self.telemetry, events=self.event_log)
        self.query_nodes: dict[str, QueryNode] = {}
        for i in range(self.config.num_query_nodes):
            self._new_query_node()

        self.proxy = Proxy(
            "proxy-0", self.meta, self.tso, self.loggers, self.query_coord,
            self.query_nodes, metrics=self.telemetry,
        )
        self.proxy.bounded_staleness_ms = self.config.bounded_staleness_ms
        self.proxy.control_lock = self._step_lock
        # The serving-tier request scheduler: async micro-batched ingest
        # with backpressure plus the read micro-batching stage the batcher
        # fronts.
        self.scheduler = RequestScheduler(
            self.proxy,
            clock=self.clock,
            queue_rows=self.config.ingest_queue_rows,
            flush_rows=self.config.ingest_flush_rows,
            flush_interval_ms=self.config.ingest_flush_ms,
            metrics=self.telemetry,
            guarantee_fn=lambda _info, req: self._resolve_guarantee(req),
            on_flush=self._after_ingest_flush,
        )
        self.batcher = BatchingProxy(self.proxy, scheduler=self.scheduler)
        self.time_travel = TimeTravel(self.broker, self.store)

    # ------------------------------------------------------------- topology
    def _new_index_node(self, node_id: str) -> IndexNode:
        ix = IndexNode(node_id, self.broker, self.store, self.meta, self.tso,
                       metrics=self.telemetry, device=self.device)
        ix.publish_lock = self._step_lock  # the build thread announces under it
        return ix

    def _new_query_node(self) -> QueryNode:
        # unique ids even after removals
        i = len(self.query_nodes)
        while f"qn-{i}" in self.query_nodes:
            i += 1
        node_id = f"qn-{i}"
        qn = QueryNode(node_id, self.broker, self.store, self.tso,
                       slice_rows=self.config.slice_rows,
                       metrics=self.telemetry, device=self.device)
        self.query_nodes[node_id] = qn
        self.query_coord.register_node(node_id)
        return qn

    @_serialized
    def add_query_node(self) -> str:
        """Scale up: register the node, then let the reconciler heal any
        under-replicated segments onto it and rebalance toward even load."""
        qn = self._new_query_node()
        self.query_coord.reconciler.reconcile()
        self._settle()
        return qn.node_id

    @_serialized
    def remove_query_node(self, node_id: str | None = None) -> str | None:
        """Graceful scale-down: mark the node draining, reconcile so its
        replicas are shed to survivors (load-before-release — a segment's
        last copy stays on the draining node until a replacement holds it,
        so pinned MVCC reads never hit a serving gap), then retire it."""
        live = [n for n, q in self.query_nodes.items() if q.alive]
        if len(live) <= 1:
            return None
        node_id = node_id or live[-1]
        self.query_coord.start_drain(node_id)
        self.query_coord.reconciler.reconcile()
        self._settle()  # survivors load their new replicas
        self.query_coord.deregister_node(node_id)
        self.query_coord.handle_failures()
        node = self.query_nodes.get(node_id)
        if node:
            node.alive = False
        for coll in self.collections.values():
            self.query_coord.assign_channels(coll.name, coll.info.num_shards)
        self._settle()
        return node_id

    def kill_query_node(self, node_id: str) -> None:
        """Simulated crash: no dereg -- the lease must expire (failover)."""
        self.query_nodes[node_id].alive = False

    # ----------------------------------------------- crash/restart (chaos)
    @staticmethod
    def _locate(nodes: list, node_id: str) -> int:
        for i, n in enumerate(nodes):
            if getattr(n, "node_id", getattr(n, "logger_id", None)) == node_id:
                return i
        raise KeyError(f"no such node: {node_id}")

    def _emit_lifecycle(self, what: str, kind: str, node_id: str) -> None:
        self.telemetry.inc(f"node_{what}_total", labels={"kind": kind})
        self.event_log.emit(f"node_{what}", "system", node_kind=kind, node=node_id)

    def kill_logger(self, logger_id: str) -> None:
        self.loggers[self._locate(self.loggers, logger_id)].alive = False
        self._emit_lifecycle("killed", "logger", logger_id)

    def restart_logger(self, logger_id: str) -> None:
        """Replace a dead logger with a fresh process.  PK allocation
        watermarks live in the meta store (``id_alloc/``), so the
        replacement allocates fresh pks from its first request."""
        i = self._locate(self.loggers, logger_id)
        # replaced in place: the proxy routes over this exact list object
        self.loggers[i] = Logger(
            logger_id, self.broker, self.tso, self.data_coord, self.clock,
            self.config.tick_interval_ms, metrics=self.telemetry, wal_lock=self._wal_lock,
        )
        self._emit_lifecycle("restarted", "logger", logger_id)

    def kill_data_node(self, node_id: str) -> None:
        self.data_nodes[self._locate(self.data_nodes, node_id)].alive = False
        self._emit_lifecycle("killed", "data", node_id)

    @_serialized
    def restart_data_node(self, node_id: str) -> None:
        """Rebuild a data node from the log backbone: re-subscribe its DML
        channels from position 0 (replay skips the insert halves of segments
        already in the binlog), then re-announce any binlog whose
        ``segment_sealed`` died with the old process."""
        i = self._locate(self.data_nodes, node_id)
        old = self.data_nodes[i]
        dn = DataNode(node_id, self.broker, self.store, self.tso,
                      self.data_coord, metrics=self.telemetry, wal_lock=self._wal_lock)
        for ch in old.subscriptions:
            dn.subscribe(ch, 0)
        self.data_nodes[i] = dn
        self._emit_lifecycle("restarted", "data", node_id)
        self.reconcile_sealed()
        self._settle()

    def kill_index_node(self, node_id: str) -> None:
        self.index_nodes[self._locate(self.index_nodes, node_id)].alive = False
        self._emit_lifecycle("killed", "index", node_id)

    @_serialized
    def restart_index_node(self, node_id: str) -> None:
        """A fresh index node re-reading the coord channel from 0: finished
        builds are skipped by their CAS claims; claims the dead process
        leaked mid-build (no ``index/`` meta behind them) are released."""
        i = self._locate(self.index_nodes, node_id)
        for key, claim in list(self.meta.scan("index_claim/").items()):
            if (claim or {}).get("owner") != node_id:
                continue
            _, coll, sid, field_name, _kind = key.split("/")
            if self.meta.get(f"index/{coll}/{sid}/{field_name}") is None:
                self.meta.delete(key)
        self.index_nodes[i] = self._new_index_node(node_id)
        self._emit_lifecycle("restarted", "index", node_id)
        self._settle()

    def kill_compaction_node(self, node_id: str) -> None:
        self.compaction_nodes[self._locate(self.compaction_nodes, node_id)].alive = False
        self._emit_lifecycle("killed", "compaction", node_id)

    @_serialized
    def restart_compaction_node(self, node_id: str) -> None:
        """A fresh compaction node replaying the coord channel (the durable
        task queue) from 0: done-markers keep finished tasks finished, and
        releasing the dead owner's claims lets it re-run what the crash
        interrupted (the rewrite is deterministic; re-running overwrites)."""
        i = self._locate(self.compaction_nodes, node_id)
        self.compaction_coord.clear_stale_claims(owner=node_id)
        self.compaction_nodes[i] = CompactionNode(
            node_id, self.broker, self.store, self.meta, self.tso,
            metrics=self.telemetry,
        )
        self._emit_lifecycle("restarted", "compaction", node_id)
        self._settle()

    @_serialized
    def restart_query_node(self, node_id: str) -> str:
        """Crash-restart one query node: expire the dead incarnation's
        lease and reassign its replicas to survivors, then register a fresh
        process under the same id and let the reconciler move work back.
        The old incarnation's device columns and indexes go with it."""
        self.query_nodes.pop(node_id, None)
        st = self.query_coord.nodes.get(node_id)
        if st is not None:
            self.meta.revoke_lease(st.lease_id)
            self.query_coord.handle_failures()
        qn = QueryNode(node_id, self.broker, self.store, self.tso,
                       slice_rows=self.config.slice_rows,
                       metrics=self.telemetry, device=self.device)
        self.query_nodes[node_id] = qn
        self.query_coord.register_node(node_id)
        self.query_coord.reconciler.reconcile()
        self._emit_lifecycle("restarted", "query", node_id)
        self._settle()
        return node_id

    @_serialized
    def recover_failures(self) -> list[str]:
        """Expire dead leases and reconcile (the query coordinator's
        watchdog): failed nodes' segments are CAS-reassigned to surviving
        replicas, channels re-homed, under-replication healed."""
        st = self.query_coord.nodes
        for node_id, qn in self.query_nodes.items():
            if qn.alive and node_id in st:
                self.query_coord.heartbeat(node_id)
        for node_id, qn in self.query_nodes.items():
            if not qn.alive and node_id in st:
                self.meta.revoke_lease(st[node_id].lease_id)
        report = self.query_coord.reconciler.reconcile()
        self._settle()
        return report["dead"]

    # ------------------------------------------------------ crash recovery
    @_serialized
    def reconcile_sealed(self) -> int:
        """Re-announce sealed binlogs the metadata plane never learned
        about: a data node dying between the binlog flush and its
        ``segment_sealed`` publish leaves a durable segment invisible.  The
        binlog meta object is written last, so its presence proves the
        flush completed.  Targets of still-pending compaction tasks are
        skipped (re-execution overwrites them).  The attr satellites are
        rebuilt from the binlog columns before the announcement."""
        pending_targets = {
            (t["collection"], sid)
            for t in self.compaction_coord.pending.values()
            for sid in t.get("targets", ())
        }
        healed = 0
        for m in self.store.list("binlog/"):
            parts = m.key.split("/")
            if len(parts) != 4 or parts[3] != "meta":
                continue
            coll, sid = parts[1], int(parts[2])
            if (coll, sid) in pending_targets:
                continue
            if self.meta.get(f"collection/{coll}") is None:
                continue  # dropped collections stay dropped
            if self.meta.get(f"segment/{coll}/{sid}") is not None:
                continue  # already known (sealed or retired)
            bm = read_binlog_meta(self.store, coll, sid)
            part = bm.get("partition", DEFAULT_PARTITION)
            if self.meta.get(f"partition/{coll}/{part}") is None:
                continue  # dropped partitions stay dropped
            attr_fields = sorted(rebuild_attr_satellites(self.store, coll, sid))
            self.broker.publish(
                COORD_CHANNEL,
                LogEntry(
                    ts=self.tso.next(),
                    type=EntryType.COORD,
                    payload={
                        "msg": "segment_sealed",
                        "collection": coll,
                        "segment_id": sid,
                        "shard": bm.get("shard", 0),
                        "partition": part,
                        "num_rows": bm["num_rows"],
                        "binlog_keys": {},
                        "checkpoint_pos": bm["checkpoint_pos"],
                        "min_ts": bm.get("min_ts", 0),
                        "max_ts": bm.get("max_ts", 0),
                    },
                ),
            )
            self.data_coord.on_sealed(
                coll, sid, bm["num_rows"], part, shard=bm.get("shard", 0),
                attr_fields=attr_fields,
            )
            self.telemetry.inc("recovery_seals_reconciled_total")
            self.event_log.emit("seal_reconciled", "system", collection=coll, segment_id=sid)
            healed += 1
        return healed

    @_serialized
    def heal_attr_satellites(self) -> int:
        """Rebuild missing or partial attribute-index satellites of the
        segments the metadata plane already knows.  Returns segments healed."""
        healed = 0
        for key, rec in sorted(self.meta.scan("segment/").items()):
            if rec.get("state") != "sealed":
                continue
            _, coll, sid_s = key.split("/")
            sid = int(sid_s)
            if not self.store.exists(f"binlog/{coll}/{sid}/meta"):
                continue
            recorded = [k.rsplit("/", 1)[1] for k in self.meta.scan(f"attr_index/{coll}/{sid}/")]
            if recorded and all(self.store.exists(attr_key(coll, sid, f)) for f in recorded):
                continue
            fields = sorted(rebuild_attr_satellites(self.store, coll, sid))
            self.data_coord._record_attr_fields(coll, sid, int(rec.get("rows", 0)), fields)
            self.telemetry.inc("recovery_attr_satellites_rebuilt_total")
            self.event_log.emit("attr_satellites_healed", "system", collection=coll, segment_id=sid)
            healed += 1
        return healed

    def restart(self) -> dict:
        """Cold-restart the whole system: every process -- coordinators,
        worker nodes, the proxy -- is discarded and rebuilt from the durable
        substrates (meta store, object store, log backbone), as in the
        reference.  The clock, the substrates, the metrics registry and the
        event log carry over; collections, segment state, index state,
        placement, pending compactions, growing rows and pinned time-travel
        windows are reconstructed.  The old query and index nodes' device
        memory is released with them.  Session watermarks do not survive.
        In threaded mode the threads are stopped for the rebuild and started
        again after it."""
        was_threaded = bool(self._threads)
        if was_threaded:
            self.stop_threads()
        # The dead proxy's meta watches must stop firing into it.
        self.proxy._cancel_watch()
        self.proxy._cancel_partition_watch()
        # A fresh TSO floored at the durable log frontier: timestamps stay
        # strictly increasing across the restart.
        self.tso = TSO(self.clock)
        frontier = 0
        for ch in self.broker.channels():
            end = self.broker.end_position(ch)
            if end:
                frontier = max(frontier, self.broker.read(ch, end - 1)[0].ts)
        self.tso.advance_to(frontier)
        # Serving placement is soft state: drop the assignment records and
        # let the reconciler re-place everything through the CAS path.
        for key in list(self.meta.scan("assignment/")):
            self.meta.delete(key)

        self._build_processes()

        # Collections come back from the meta store alone.
        self.collections = {}
        for key, rec in sorted(self.meta.scan("collection/").items()):
            name = key.split("/", 1)[1]
            info = CollectionInfo(
                name=name,
                schema=Schema.from_dict(rec["schema"]),
                num_shards=int(rec["num_shards"]),
                metric=Metric(rec["metric"]),
                created_ts=int(rec.get("created_ts", 0)),
                replication_factor=int(rec.get("replication_factor", 1)),
            )
            for f, spec in self.index_coord.index_specs(name).items():
                info.index_specs[f] = {
                    "kind": spec["kind"], "params": dict(spec.get("params") or {}),
                }
            self.collections[name] = ManuCollection(self, info)
            # Data nodes re-archive from position 0, skipping inserts whose
            # segments are already durable in binlog.
            for shard in range(info.num_shards):
                dn = self.data_nodes[shard % len(self.data_nodes)]
                dn.subscribe(dml_channel(name, shard), 0)

        report: dict = {"tso_frontier": frontier}
        report["data"] = self.data_coord.recover_state(store=self.store)
        report["index"] = self.index_coord.recover_state()
        report["query"] = self.query_coord.recover_state()
        # The compaction coordinator's durable queue is the coord channel:
        # one replaying step rebuilds pending tasks; clearing stale claims
        # un-wedges whatever a dead node held mid-rewrite.
        self.compaction_coord.step()
        report["claims_cleared"] = self.compaction_coord.clear_stale_claims()
        report["seals_reconciled"] = self.reconcile_sealed()
        report["attr_healed"] = self.heal_attr_satellites()
        self.query_coord.reconciler.reconcile()
        self.run_until_idle()
        # Pinned time-travel windows: retired-but-unreclaimed segments are
        # re-loaded and re-retired.
        report["retired_reloaded"] = self.query_coord.recover_retired(self.store)
        self.run_until_idle()
        if was_threaded or self.config.threaded:
            self.start_threads()
        self.telemetry.inc("system_restarts_total")
        self.event_log.emit(
            "system_restarted", "system",
            **{k: v for k, v in report.items() if isinstance(v, (int, float))},
        )
        return report

    # ----------------------------------------------------------------- DDL
    @_serialized
    def create_collection(
        self,
        name: str,
        dim: int,
        metric: Metric = Metric.L2,
        num_shards: int | None = None,
        extra_fields: list[FieldSchema] | None = None,
        seal_rows: int | None = None,
        schema: Schema | None = None,
        replication_factor: int | None = None,
    ) -> ManuCollection:
        """Create a collection.  The common int-pk + one-vector case is
        built from ``dim``/``extra_fields``; pass an explicit ``schema``
        for anything else (string primary keys, custom layouts).
        ``replication_factor`` overrides ``ManuConfig.replication_factor``
        for this collection's sealed segments."""
        schema = schema or Schema.simple(dim, metric, extra=extra_fields)
        info = self.root_coord.create_collection(
            name,
            schema,
            num_shards=num_shards or self.config.num_shards,
            metric=metric,
            seal_rows=seal_rows or self.config.seal_rows,
            replication_factor=(
                self.config.replication_factor
                if replication_factor is None
                else replication_factor
            ),
        )
        coll = ManuCollection(self, info)
        self.collections[name] = coll
        # Data nodes archive the WAL: shard channels round-robin over them.
        for shard in range(info.num_shards):
            dn = self.data_nodes[shard % len(self.data_nodes)]
            dn.subscribe(dml_channel(name, shard))
        self.query_coord.assign_channels(name, info.num_shards)
        if not self.config.threaded:
            self.pump()
        return coll

    @_serialized
    def drop_collection(self, name: str) -> None:
        self.root_coord.drop_collection(name)
        self.collections.pop(name, None)

    # ---------------------------------------------------------- partitions
    @_serialized
    def create_partition(self, name: str, partition: str) -> None:
        self.root_coord.create_partition(name, partition)
        if not self.config.threaded:
            self.pump()


    @_serialized
    def _set_index_spec(self, coll: ManuCollection, field: str, kind: str, params: dict | None) -> None:
        self.index_coord.set_index_spec(
            coll.name, field, kind, params, metric=coll.info.metric,
            column=vector_column_of(coll.info.schema, field),
        )
        # Handle-local mirror for introspection; the meta store
        # (index_coord.index_specs) stays the authoritative copy.
        coll.info.index_specs[field] = {"kind": kind, "params": params or {}}
        # Batch indexing (paper §3.5): issue builds for already-sealed segments.
        for sid in self.data_coord.sealed_segments(coll.name):
            self.index_coord.rebuild_segment(coll.name, sid, fields=[field])

    def drop_partition(self, name: str, partition: str) -> dict:
        """Drop a partition: unregister it, retire its sealed segments
        (reclaimed by the next GC cycle), discard its growing rows, and
        broadcast ``partition_dropped`` so serving nodes release their
        copies.  Like ``drop_collection``, the drop is not MVCC-gated.  The
        pks that lived only in the partition are broadcast as
        ``tombstones_folded`` (``compact_ts`` = the drop ts): the query
        nodes prune them at the next retention-horizon advance, and the
        compaction coordinator prunes its own view now."""
        self._drain()  # let in-flight seals land first
        sids = self._drop_partition_state(name, partition)
        self._settle()
        return {"partition": partition, "segments_dropped": len(sids)}

    @_serialized
    def _drop_partition_state(self, name: str, partition: str) -> list[int]:
        ts = self.root_coord.drop_partition(name, partition)
        sids = self.data_coord.drop_partition_state(name, partition, ts)

        # pk accounting BEFORE nodes release anything: which pks vanish
        # with the partition, and which survive elsewhere?
        dropped_pks: list[np.ndarray] = [
            read_binlog_column(self.store, name, sid, "pk") for sid in sids
        ]
        surviving_pks: list[np.ndarray] = [
            read_binlog_column(self.store, name, sid, "pk")
            for sid in self.data_coord.sealed_segments(name)
        ]
        for node in list(self.query_nodes.values()) + self.data_nodes:
            for (coll, _sid), seg in list(node.growing.items()):
                if coll != name:
                    continue
                pks = seg.pks().cpu().numpy()
                (dropped_pks if seg.partition == partition else surviving_pks).append(pks)

        self.broker.publish(
            COORD_CHANNEL,
            LogEntry(
                ts=self.tso.next(),
                type=EntryType.COORD,
                payload={
                    "msg": "partition_dropped",
                    "collection": name,
                    "partition": partition,
                    "segment_ids": sids,
                    "drop_ts": ts,
                },
            ),
        )
        for dn in self.data_nodes:
            dn.drop_partition(name, partition)

        exclusive = np.empty(0, np.int64)
        if dropped_pks:
            exclusive = np.unique(np.concatenate(dropped_pks))
            if surviving_pks:
                exclusive = np.setdiff1d(
                    exclusive, np.concatenate(surviving_pks), assume_unique=False
                )
        if exclusive.size:
            self.broker.publish(
                COORD_CHANNEL,
                LogEntry(
                    ts=self.tso.next(),
                    type=EntryType.COORD,
                    payload={
                        "msg": "tombstones_folded",
                        "collection": name,
                        "folded_pks": exclusive,
                        "compact_ts": ts,
                    },
                ),
            )
            pruned = prune_folded(self.compaction_coord.tombstones.get(name) or {}, exclusive, ts)
            if pruned is not None:
                self.compaction_coord.tombstones[name] = pruned
        return sids


    # ------------------------------------------------------------ mutations
    def mutate(self, coll: ManuCollection, request: MutationRequest) -> MutationResult:
        """Run one typed mutation through the proxy pipeline, remember its
        watermark for SESSION reads on this handle, and (cooperative mode)
        pump the components so subscribers observe the WAL entries.

        Pending async mutations to the same collection are flushed first:
        a sync mutation must not overtake requests admitted earlier —
        ``insert_async(pk)`` followed by a sync ``delete(pk)`` has to
        reach the WAL in admission order or the delete would apply before
        the insert and resurrect the row."""
        if self.scheduler.pending_write_rows(coll.info.name):
            self.scheduler.flush_writes(coll.info.name)
        result = self.proxy.mutate(coll.info, request)
        coll.last_write_ts = result.watermark_ts
        if not self.config.threaded:
            self.pump()
        return result

    def mutate_async(
        self, coll: ManuCollection, request: MutationRequest
    ) -> MutationTicket:
        """Admit one typed mutation into the ingest scheduler and return
        its :class:`MutationTicket` immediately.  The WAL crossing happens
        at the next flush (depth / age / explicit); the ticket resolves
        with the request's own :class:`MutationResult` then, advancing the
        handle's SESSION watermark.  Raises :class:`AdmissionRejected`
        when the target write queue is out of credits (backpressure)."""
        ticket = self.scheduler.submit_mutation(coll.info, request)

        def _note(result: MutationResult, c=coll) -> None:
            c.last_write_ts = max(c.last_write_ts, result.watermark_ts)

        ticket.on_resolve(_note)
        return ticket

    def flush_ingest(self) -> int:
        """Flush every pending ingest queue now; returns requests flushed."""
        return self.scheduler.flush_writes()

    def _after_ingest_flush(self) -> None:
        """Post-flush hook: pump so subscribers observe the just-published
        WAL entries."""
        if not self.config.threaded:
            self.pump()

    # ---------------------------------------------------------------- pump

    def pump(self, rounds: int = 1, *, index_nodes: bool = True) -> bool:
        """One cooperative scheduling round over every component; the pump
        thread leaves the index nodes (``index_nodes=False``) to the build
        thread."""
        progress = False
        for _ in range(rounds):
            # Alive nodes heartbeat every round: consistency waits advance
            # the manual clock, which must never expire a *live* lease.
            # Snapshots: in threaded mode the main thread may add or drop
            # nodes while the pump thread walks them.
            for node_id, qn in list(self.query_nodes.items()):
                if qn.alive and node_id in self.query_coord.nodes:
                    self.query_coord.heartbeat(node_id)
            for lg in list(self.loggers):
                if not lg.alive:
                    continue
                try:
                    lg.tick(self.broker.channels("dml/"))
                except Crash as c:
                    self._mark_crashed("logger", lg, c)
            for dn in list(self.data_nodes):
                progress |= self._crashable_step("data", dn)
            progress |= self.index_coord.step()
            if index_nodes:
                for ix in list(self.index_nodes):
                    progress |= self._crashable_step("index", ix)
            progress |= self.compaction_coord.step()
            for cn in list(self.compaction_nodes):
                progress |= self._crashable_step("compaction", cn)
            progress |= self.query_coord.step()
            for qn in list(self.query_nodes.values()):
                progress |= self._crashable_step("query", qn)
            # Ingest scheduler age trigger: admitted-but-unflushed writes
            # never outlive ``ingest_flush_ms`` of pump activity.
            progress |= self.scheduler.step()
        return progress

    def _crashable_step(self, kind: str, node) -> bool:
        """Step one worker node, turning an injected ``Crash`` into that
        node's death.  Like a kill -9 the exception runs no cleanup in the
        node (``Crash`` is a BaseException); what it leaked is the recovery
        path's problem.  Coordinator steps are not guarded: a coordinator
        crash takes the control plane down, and the remedy is ``restart()``."""
        try:
            return bool(node.step())
        except Crash as c:
            self._mark_crashed(kind, node, c)
            return True

    def _mark_crashed(self, kind: str, node, crash: Crash) -> None:
        node.alive = False
        node_id = getattr(node, "node_id", getattr(node, "logger_id", "?"))
        self.telemetry.inc("node_crashes_total", labels={"kind": kind})
        self.event_log.emit(
            "node_crashed", "system", node_kind=kind, node=node_id,
            site=crash.site, key=crash.key,
        )

    def run_until_idle(self, max_rounds: int = 10_000) -> int:
        rounds = 0
        while self.pump() and rounds < max_rounds:
            rounds += 1
        if rounds:
            self.event_log.emit(
                "run_until_idle", "system",
                rounds=rounds, truncated=rounds >= max_rounds,
            )
        return rounds

    def _settle(self) -> None:
        """Cooperatively, run every component until quiescent; in threaded
        mode the pump thread does that work and the caller goes on."""
        if not self.config.threaded:
            self.run_until_idle()

    def _drain(self) -> None:
        """Return once every component is quiescent: cooperatively by
        running them, in threaded mode by waiting for the pump thread."""
        if self.config.threaded:
            self.wait_idle()
        else:
            self.run_until_idle()

    def wait_idle(self, timeout_s: float = 30.0) -> None:
        """Poll until no live query node lags its channels, the compaction
        coordinator has consumed the log, and no index build or compaction
        is pending; raise ``TimeoutError`` with ``_diagnostic_dump`` after
        ``timeout_s``.  Cooperatively, each poll that finds work pending
        pumps one round itself.  In threaded mode the pump thread does the
        work, and the wait also needs one whole pump round that began after
        the wait and made no progress: the reference's checks alone pass in
        the moment between a flush and the data node's seal."""
        deadline = time.time() + timeout_s
        polls = 0
        first_round = self._pump_rounds + 2  # the first round begun after now
        while time.time() < deadline:
            polls += 1
            self._raise_thread_error()
            lag = sum(
                sub.lag()
                for qn in list(self.query_nodes.values())
                if qn.alive
                for sub in list(qn.subscriptions.values())
            )
            if (
                lag == 0
                and self.compaction_coord.lag() == 0
                and not self.index_coord.pending_tasks
                and not self.compaction_coord.pending
                and (not self._threads
                     or (self._quiet_rounds >= 1 and self._pump_rounds >= first_round))
            ):
                self.event_log.emit("wait_idle", "system", polls=polls, drained=True)
                return
            if self._threads or not self.pump():
                time.sleep(0.005)
        self.event_log.emit("wait_idle", "system", polls=polls, drained=False)
        raise TimeoutError(self._diagnostic_dump(f"wait_idle timed out after {timeout_s}s"))

    def _diagnostic_dump(self, reason: str) -> str:
        """One-stop timeout diagnosis: which channels still hold entries,
        which subscribers lag, what work is pending, and the last few
        control-plane events — so a hung wait points at its culprit instead
        of just saying 'timed out'."""
        lines = [reason]
        stats = self.broker.stats()
        lines.append(
            "channel entries: "
            + str({ch: s["entries"] for ch, s in sorted(stats.items())})
        )
        for node_id, qn in sorted(self.query_nodes.items()):
            lags = {
                ch: sub.lag()
                for ch, sub in qn.subscriptions.items()
                if sub.lag()
            }
            if lags or not qn.alive:
                state = "alive" if qn.alive else "dead"
                lines.append(f"query node {node_id} [{state}] lag: {lags}")
        lines.append(
            f"pending: index_tasks={len(self.index_coord.pending_tasks)}"
            f" compactions={len(self.compaction_coord.pending)}"
            f" compaction_lag={self.compaction_coord.lag()}"
        )
        for ev in self.event_log.query()[-10:]:
            lines.append(f"event {ev.kind} src={ev.source} {ev.detail}")
        return "\n  ".join(lines)

    # --------------------------------------------------- compaction & GC
    def compact(self, name: str) -> dict:
        """One maintenance cycle: plan rewrites, execute, hot-swap.
        Returns {"tasks", "epoch", "rows_purged"} for THIS cycle; a no-op
        when the policy finds nothing to do."""
        # The coordinator must see all seals and deletes before planning.
        self._drain()
        purged_before = sum(cn.rows_purged for cn in self.compaction_nodes)
        tasks = self._plan_compaction(name)
        self._drain()
        return {
            "tasks": len(tasks),
            "epoch": self.compaction_coord.segment_map.epoch(name),
            "rows_purged": sum(cn.rows_purged for cn in self.compaction_nodes) - purged_before,
        }

    @_serialized
    def _plan_compaction(self, name: str) -> list:
        return self.compaction_coord.plan(name)

    def gc(self, name: str | None = None, horizon_ts: int | None = None) -> dict:
        """Advance the retention horizon and reclaim unreferenced objects
        of collection ``name`` (None = every collection).  The horizon
        defaults to "now minus ``gc_retention_ms``"; segments referenced by
        time-travel checkpoints survive regardless."""
        if horizon_ts is None:
            if self.config.gc_retention_ms > 0:
                horizon_ts = pack(
                    max(0, int(self.clock.now_ms() - self.config.gc_retention_ms)), 0
                )
            else:
                horizon_ts = self.tso.next()
        report = self._reap(name, horizon_ts)
        self._settle()
        return report

    @_serialized
    def _reap(self, name: str | None, horizon_ts: int) -> dict:
        self.compaction_coord.advance_horizon(horizon_ts, collection=name)
        self._settle()
        return self.gc_reaper.reap(horizon_ts, collection=name)

    # -------------------------------------------------------------- search
    def search(
        self,
        coll: ManuCollection,
        queries,
        k: int | None = None,
        staleness_ms: float | None = None,
        session_ts: int | None = None,
        filter_expr: str | None = None,
        time_travel_ts: int | None = None,
        hedge_timeout_s: float | None = None,
    ) -> SearchResult:
        """Resolve a :class:`SearchRequest`'s consistency requirement into
        a pinned :class:`GuaranteeTs` and hand it to the proxy.  The legacy
        positional form is packed into a request first.  ``session_ts``
        overrides the request's watermark without mutating the request
        (SESSION reads resolved by the collection handle)."""
        if isinstance(queries, SearchRequest):
            request = queries
        else:
            request = SearchRequest.single(
                queries,
                field=coll.info.schema.vector_fields()[0].name,
                k=k if k is not None else 10,
                staleness_ms=staleness_ms,
                session_ts=session_ts or 0,
                filter=filter_expr,
                time_travel_ts=time_travel_ts,
            )
        guarantee = self._resolve_guarantee(request, session_ts=session_ts)
        return self.proxy.search(
            coll.info, request, guarantee=guarantee,
            wait_fn=self._threaded_wait if self.config.threaded else self._cooperative_wait,
            hedge_timeout_s=hedge_timeout_s,
        )

    def _resolve_guarantee(
        self, request: SearchRequest, session_ts: int | None = None
    ) -> GuaranteeTs:
        """Resolve a request's consistency fields against this system's
        configuration: explicit tau > named level (BOUNDED uses
        ``bounded_staleness_ms``) > ``default_staleness_ms``.  Also the
        ingest scheduler's guarantee resolver for queued reads."""
        effective_session = (
            request.session_ts if session_ts is None else session_ts
        )
        tau = request.resolve_staleness_ms(
            self.config.default_staleness_ms,
            bounded_ms=self.config.bounded_staleness_ms,
        )
        if request.time_travel_ts is not None:
            # Historical reads never wait: the data is by definition old.
            return GuaranteeTs(
                query_ts=request.time_travel_ts, staleness_ms=INFINITE_STALENESS
            )
        return GuaranteeTs(
            query_ts=self.tso.next(), staleness_ms=tau,
            session_ts=effective_session,
        )

    def _cooperative_wait(
        self, node: QueryNode, guarantee: GuaranteeTs, channels=None
    ) -> None:
        """Pump until the node's consumed watermark covers the guarantee.

        ``channels`` scopes the wait (watermark-aware routing passes
        exactly the channels whose picked server still lags); None keeps
        the legacy behavior of waiting on every DML channel the node
        serves."""
        if channels is None:
            channels = [ch for ch in node.subscriptions if ch.startswith("dml/")]
        else:
            channels = list(channels)
        if not channels:
            return
        target = guarantee.wait_target_ts()
        seen_sub = False
        for _ in range(100_000):
            # Re-read each round: a reconcile during the pump may re-home a
            # channel off this node (its new owner runs its own wait).
            subs = [
                node.subscriptions[ch]
                for ch in channels
                if ch in node.subscriptions
            ]
            if subs:
                seen_sub = True
                wm = min(s.last_tick_seen for s in subs)
                if wm >= target or guarantee.satisfied_by(wm):
                    return
            elif seen_sub:
                # The channel moved off this node mid-wait; its new owner
                # runs its own wait.
                return
            else:
                # Never saw a subscription: the subscribe may still be in
                # flight — but only while the coordinator still assigns a
                # scoped channel here.  If ownership moved (or the node was
                # dropped) between plan and wait, no subscribe will ever
                # land: return instead of pumping to the round limit; the
                # new owner runs its own wait.
                st = self.query_coord.nodes.get(node.node_id)
                followers = getattr(self.query_coord, "channel_followers", {})
                if not any(
                    (st is not None and ch in st.channels)
                    or node.node_id in followers.get(ch, ())
                    for ch in channels
                ):
                    return
            # No subscription yet: a scoped wait may start before the node
            # applied its subscribe message — pump until it lands.
            if isinstance(self.clock, ManualClock):
                self.clock.advance(max(self.config.tick_interval_ms, 1))
            for lg in self.loggers:
                if lg.alive:  # a killed logger emits no ticks
                    lg.tick(channels)
            self.pump()
        raise TimeoutError(
            self._diagnostic_dump("consistency wait did not converge")
        )

    def _threaded_wait(
        self, node: QueryNode, guarantee: GuaranteeTs, channels=None
    ) -> None:
        """Block until the node has consumed a time-tick covering the
        guarantee on each of its (scoped) channels; the pump thread does
        the stepping.  A channel the coordinator assigns to the node but
        the node has not subscribed yet is waited for (the reference's wait
        passes it, and the read misses every growing row); one re-homed
        off the node drops out, its new owner runs its own wait.  Raises
        ``TimeoutError`` after 10 s (the reference returns and answers from
        whatever the node holds)."""
        if channels is None:
            channels = [ch for ch in node.subscriptions if ch.startswith("dml/")]
        else:
            channels = list(channels)
        target = guarantee.wait_target_ts()
        deadline = time.time() + 10.0
        for ch in channels:
            self.broker.wait_for_tick(ch, target, timeout_s=max(0.0, deadline - time.time()))
        while True:
            self._raise_thread_error()
            st = self.query_coord.nodes.get(node.node_id)
            followers = getattr(self.query_coord, "channel_followers", {})
            waiting = False
            for ch in channels:
                sub = node.subscriptions.get(ch)
                if sub is None:
                    waiting |= ((st is not None and ch in st.channels)
                                or node.node_id in followers.get(ch, ()))
                else:
                    wm = sub.last_tick_seen
                    waiting |= not (wm >= target or guarantee.satisfied_by(wm))
            if not waiting:
                return
            if time.time() >= deadline:
                raise TimeoutError(self._diagnostic_dump("threaded consistency wait did not converge"))
            time.sleep(0.001)

    # -------------------------------------------------------- time travel
    @_serialized
    def checkpoint_collection(self, name: str) -> None:
        coll = self.collections[name]
        ts = self.tso.last_issued()
        replay = {}
        for shard in range(coll.info.num_shards):
            ch = dml_channel(name, shard)
            replay[ch] = self.data_coord.replay_position(name, shard)
        self.time_travel.checkpoint(
            name, ts, self.data_coord.sealed_segments(name), coll.info.num_shards, replay,
        )

    def restore_collection(self, name: str, target_ts: int) -> RestoredCollection:
        """The collection as of ``target_ts``, restored onto this system's
        device from the closest checkpoint and the WAL."""
        coll = self.collections[name]
        return self.time_travel.restore(
            name, target_ts, coll.info.num_shards, coll.info.dim(), device=self.device
        )

    # ------------------------------------------------------------ metrics
    # ------------------------------------------------------------- threads
    def start_threads(self) -> None:
        """Start the pump thread (steps every component but the index
        nodes, then sleeps ``pump_sleep_s``), the build thread (steps the
        index nodes outside the step lock, so the query nodes go on
        consuming ticks and answering reads while an index builds) and the
        watchdog thread (heartbeats the live query nodes; reconciles every
        ``reconcile_interval_s``)."""
        self._stop.clear()
        self._thread_error = None
        # The pump thread owns node stepping; the proxy's failover waits
        # sleep instead of stepping nodes themselves.
        self.proxy.pump_fn = lambda: time.sleep(self.config.pump_sleep_s)

        def pump_loop():
            while not self._stop.is_set():
                with self._step_lock:
                    t0 = time.perf_counter()
                    progressed = self.pump(index_nodes=False)
                    # The round under the lock: what a query node's
                    # ``serve_wait`` waits behind (``query_node_step_us``
                    # splits that node's part of it).
                    self.telemetry.observe("pump_round_us", (time.perf_counter() - t0) * 1e6)
                self._quiet_rounds = 0 if progressed else self._quiet_rounds + 1
                self._pump_rounds += 1
                time.sleep(self.config.pump_sleep_s)

        def build_loop():
            while not self._stop.is_set():
                built = False
                for ix in list(self.index_nodes):
                    built |= self._crashable_step("index", ix)
                if not built:
                    self._stop.wait(self.config.pump_sleep_s)

        def watchdog_loop():
            last_reconcile = 0.0
            while not self._stop.is_set():
                for node_id, qn in list(self.query_nodes.items()):
                    if qn.alive and node_id in self.query_coord.nodes:
                        self.query_coord.heartbeat(node_id)
                now = time.time()
                # Reconcile between pump rounds; never wait for a round
                # (a compaction can hold one for seconds), so the
                # heartbeats above keep every live lease fresh meanwhile.
                if (now - last_reconcile >= self.config.reconcile_interval_s
                        and self._step_lock.acquire(blocking=False)):
                    try:
                        last_reconcile = now
                        self.query_coord.reconciler.reconcile()
                    finally:
                        self._step_lock.release()
                self._stop.wait(0.05)

        def guarded(loop):
            def run():
                try:
                    loop()
                except BaseException as exc:  # raised again in the caller's thread
                    self._thread_error = exc
                    self._stop.set()
            return run

        for name, loop in (("manu-pump", pump_loop), ("manu-build", build_loop),
                           ("manu-watchdog", watchdog_loop)):
            t = threading.Thread(target=guarded(loop), name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop_threads(self) -> None:
        """Stop and join the threads (the build thread may be in an index
        build); raise if one outlives ``THREAD_JOIN_S`` or if one died of
        an exception."""
        self._stop.set()
        deadline = time.time() + THREAD_JOIN_S
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.time()))
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"threads still running after {THREAD_JOIN_S} s: {alive}")
        self._threads.clear()
        self.proxy.pump_fn = None
        self._raise_thread_error()

    def _raise_thread_error(self) -> None:
        err = self._thread_error
        if err is not None:
            self._thread_error = None
            raise RuntimeError("a ManuSystem thread failed") from err

    def metrics(self) -> MetricsSnapshot:
        """Typed, JSON-serializable snapshot of the shared metrics registry:
        every counter and gauge series, plus a :class:`HistogramRow` per
        latency histogram with p50/p95/p99 estimated from the log buckets."""
        counters, gauges, hists = self.telemetry.snapshot_rows()
        return MetricsSnapshot(
            ts_ms=self.clock.now_ms(),
            counters=counters,
            gauges=gauges,
            histograms=tuple(
                HistogramRow(name=k, count=total, mean=mean,
                             p50=p50, p95=p95, p99=p99)
                for (k, total, mean, p50, p95, p99) in hists
            ),
        )

    def events(self, since_ts: float | None = None,
               kind: str | None = None) -> list[Event]:
        """Control-plane event log: typed events from the coordinators,
        reconciler, compaction, and GC.  ``since_ts`` filters on the
        emission timestamp (ms, inclusive); ``kind`` on the event kind."""
        return self.event_log.query(since_ts=since_ts, kind=kind)

    def export_metrics(self) -> str:
        """Prometheus text-format exposition of the metrics registry."""
        return self.telemetry.export()

    def cluster_state(self) -> ClusterState:
        """Typed frozen snapshot of the serving tier: node health (as the
        ``HealthMonitor`` observes it), per-node load, the committed
        segment -> replica-group placement, and how many sealed segments
        are currently below their collection's replication factor."""
        coord = self.query_coord
        statuses = coord.health.observe()
        nodes = tuple(
            NodeStatus(
                node_id=n,
                status=statuses.get(n, "dead"),
                load=len(st.segments),
                segments=tuple(sorted(st.segments)),
                channels=tuple(sorted(st.channels)),
                searches=(
                    self.query_nodes[n].search_count
                    if n in self.query_nodes
                    else 0
                ),
                searches_primary=(
                    self.query_nodes[n].searches_primary
                    if n in self.query_nodes
                    else 0
                ),
                searches_hedged=(
                    self.query_nodes[n].searches_hedged
                    if n in self.query_nodes
                    else 0
                ),
            )
            for n, st in sorted(coord.nodes.items())
        )
        placements = []
        under = 0
        for (coll, sid), reps in sorted(coord.replica_sets.items()):
            rec = self.meta.get(f"assignment/{coll}/{sid}") or {}
            ur = bool(
                rec.get(
                    "under_replicated",
                    len(reps) < coord.replication_for(coll),
                )
            )
            under += int(ur)
            placements.append(
                SegmentPlacement(
                    collection=coll,
                    segment_id=sid,
                    replicas=tuple(reps),
                    under_replicated=ur,
                    visible_from_ts=int(rec.get("visible_from_ts", 0)),
                )
            )
        # Sealed segments with no committed placement at all (total outage)
        # count as under-replicated too: the reconciler owes them replicas.
        placed = set(coord.replica_sets)
        for key in self.meta.scan("collection/"):
            coll = key.split("/", 1)[1]
            for sid in self.data_coord.sealed_segments(coll):
                if (coll, sid) not in placed:
                    under += 1
                    placements.append(
                        SegmentPlacement(coll, sid, (), True, 0)
                    )
        return ClusterState(
            nodes=nodes,
            placement=tuple(placements),
            under_replicated=under,
            replication_factor=coord.replication_factor,
        )

    def stats(self) -> dict:
        """Legacy ad-hoc counters — a thin facade now; ``cluster_state()``
        is the typed view of the serving tier."""
        cs = self.cluster_state()
        status_of = {ns.node_id: ns.status for ns in cs.nodes}
        return {
            "log": self.broker.stats(),
            "object_store_puts": getattr(self.store, "put_count", -1),
            "query_nodes": {
                n: {
                    "rows": q.memory_rows(),
                    "alive": q.alive,
                    "searches": q.search_count,
                    "status": status_of.get(n, "dead"),
                }
                for n, q in self.query_nodes.items()
            },
            "cluster": {
                "under_replicated": cs.under_replicated,
                "replication_factor": cs.replication_factor,
            },
            "index_builds": sum(ix.builds_completed for ix in self.index_nodes),
            "compactions": sum(cn.compactions_completed for cn in self.compaction_nodes),
            "rows_purged": sum(cn.rows_purged for cn in self.compaction_nodes),
            "gc_bytes_reclaimed": self.gc_reaper.bytes_reclaimed,
            "metrics": self.metrics().to_dict(),
            "events": len(self.event_log),
        }
