"""ManuSystem: wires the full architecture and exposes the PyManu-style API
(paper Table 2); mirrors ``repro.core.manu`` in its cooperative mode.

    manu = ManuSystem(ManuConfig(num_query_nodes=2))          # device="cuda"
    coll = manu.create_collection("products", dim=128)
    coll.insert({"vector": vecs})
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 64})
    res = coll.search(queries, limit=10, staleness_ms=100.0)

Every API call pumps the component state machines until quiescent, and
consistency waits advance the clock and emit time-ticks explicitly
(``manual_clock=True``, ``threaded=False``).  Query and index nodes keep
their columns and indexes on ``device`` (the card unless the caller passes
``device="cpu"``); loggers, data nodes, coordinators and the stores are
host work.  Search results hold scores and pks as tensors on that device
and hydrated fields as host arrays.

The object store, meta store and log broker are composed directly: the
reference wraps them as ``Retrying(Faulty(real))``, which passes every call
through when no fault injector is set.  Threaded mode, fault injection,
compaction and GC, crash/restart and time-travel checkpoints raise
``NotImplementedError`` naming ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._device import resolve_device
from .binlog import read_binlog_column
from .collection import CollectionInfo, FieldSchema, FieldType, Metric, Schema
from .consistency import ConsistencyLevel, GuaranteeTs
from .coordinator import (
    DataCoordinator,
    IndexCoordinator,
    QueryCoordinator,
    RootCoordinator,
)
from .data_node import DataNode
from .index_node import IndexNode
from .log import COORD_CHANNEL, EntryType, LogBroker, LogEntry, dml_channel
from .logger_node import Logger
from .meta_store import MetaStore
from .object_store import MemoryObjectStore, ObjectStore
from .proxy import Proxy, SearchResult
from .query_node import QueryNode
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
from .timestamp import INFINITE_STALENESS, TSO, Clock, ManualClock

#: Where the parts of ``repro.core.manu`` this module leaves out wait.
NOT_PORTED = "not ported yet: ROADMAP Queue 1 item 8"


def _not_ported(name: str, needs: str):
    """A facade method whose machinery (``needs``) is not ported yet."""

    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{name} needs {needs}, {NOT_PORTED}")

    method.__name__ = name.rsplit(".", 1)[-1]
    method.__doc__ = f"Raises NotImplementedError: needs {needs} ({NOT_PORTED})."
    return method


@dataclass
class ManuConfig:
    """The reference's configuration less the options of what is not
    ported (compaction and GC policy, retry policy, threaded-mode pacing)."""

    num_shards: int = 2
    num_loggers: int = 2
    num_data_nodes: int = 1
    num_index_nodes: int = 1
    num_query_nodes: int = 2
    seal_rows: int = 8_192
    slice_rows: int = 2_048
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
    replication_factor: int = 1
    heartbeat_ttl_ms: float = 5_000.0


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
        self.system.index_coord.set_index_spec(
            self.name, field, kind, params, metric=self.info.metric,
            column=vector_column_of(self.info.schema, field),
        )
        # Handle-local mirror for introspection; the meta store
        # (index_coord.index_specs) stays the authoritative copy.
        self.info.index_specs[field] = {"kind": kind, "params": params or {}}
        # Batch indexing (paper §3.5): issue builds for already-sealed segments.
        for sid in self.system.data_coord.sealed_segments(self.name):
            self.system.index_coord.rebuild_segment(self.name, sid, fields=[field])
        self.system.run_until_idle()

    def flush(self) -> None:
        """Seal all growing segments and wait for archive + index builds.
        Queued async writes drain into the WAL first, so a flush covers
        everything admitted before it."""
        self.system.scheduler.flush_writes(collection=self.name)
        self.system.data_coord.flush(self.name)
        self.system.run_until_idle()

    compact = _not_ported("ManuCollection.compact", "core/compaction.py")
    gc = _not_ported("ManuCollection.gc", "core/compaction.py (GCReaper)")


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
        injector=None,
        device="cuda",
    ):
        self.config = config or ManuConfig()
        if self.config.threaded:
            raise NotImplementedError(f"threaded mode (ManuConfig.threaded=True) is {NOT_PORTED}")
        if injector is not None:
            raise NotImplementedError(f"fault injection needs core/faults.py, {NOT_PORTED}")
        self.device = resolve_device(device)
        self.clock: Clock = ManualClock(1_000_000) if self.config.manual_clock else Clock()
        self.tso = TSO(self.clock)

        # One metrics registry and one bounded control-plane event log per
        # system; every component records into the shared registry, the
        # control loops emit typed events.
        self.telemetry = MetricsRegistry()
        self.event_log = EventLog(self.clock)

        # Durable substrates: the only state a restart would keep.
        self.store: ObjectStore = store or MemoryObjectStore()
        self.meta = MetaStore(self.clock)
        self.broker = LogBroker()

        self._build_processes()
        self.collections: dict[str, ManuCollection] = {}

    def _build_processes(self) -> None:
        """Construct every Manu *process* — coordinators, worker nodes, the
        proxy — on top of the durable substrates."""
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
                   self.config.tick_interval_ms, metrics=self.telemetry)
            for i in range(self.config.num_loggers)
        ]
        self.data_nodes = [
            DataNode(f"dn-{i}", self.broker, self.store, self.tso, self.data_coord,
                     metrics=self.telemetry)
            for i in range(self.config.num_data_nodes)
        ]
        self.index_nodes = [
            IndexNode(f"in-{i}", self.broker, self.store, self.meta, self.tso,
                      metrics=self.telemetry, device=self.device)
            for i in range(self.config.num_index_nodes)
        ]
        self.query_nodes: dict[str, QueryNode] = {}
        for i in range(self.config.num_query_nodes):
            self._new_query_node()

        self.proxy = Proxy(
            "proxy-0", self.meta, self.tso, self.loggers, self.query_coord,
            self.query_nodes, metrics=self.telemetry,
        )
        self.proxy.bounded_staleness_ms = self.config.bounded_staleness_ms
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

    # ------------------------------------------------------------- topology
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

    def add_query_node(self) -> str:
        """Scale up: register the node, then let the reconciler heal any
        under-replicated segments onto it and rebalance toward even load."""
        qn = self._new_query_node()
        self.query_coord.reconciler.reconcile()
        self.run_until_idle()
        return qn.node_id

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
        self.run_until_idle()  # survivors load their new replicas
        self.query_coord.deregister_node(node_id)
        self.query_coord.handle_failures()
        node = self.query_nodes.get(node_id)
        if node:
            node.alive = False
        for coll in self.collections.values():
            self.query_coord.assign_channels(coll.name, coll.info.num_shards)
        self.run_until_idle()
        return node_id

    # ----------------------------------------------- crash/restart (chaos)
    kill_query_node = _not_ported("ManuSystem.kill_query_node", "core/faults.py")
    kill_logger = _not_ported("ManuSystem.kill_logger", "core/faults.py")
    kill_data_node = _not_ported("ManuSystem.kill_data_node", "core/faults.py")
    kill_index_node = _not_ported("ManuSystem.kill_index_node", "core/faults.py")
    kill_compaction_node = _not_ported("ManuSystem.kill_compaction_node", "core/compaction.py")
    restart_logger = _not_ported("ManuSystem.restart_logger", "core/retry.py")
    restart_data_node = _not_ported("ManuSystem.restart_data_node", "core/retry.py")
    restart_index_node = _not_ported("ManuSystem.restart_index_node", "core/retry.py")
    restart_compaction_node = _not_ported("ManuSystem.restart_compaction_node", "core/compaction.py")
    restart_query_node = _not_ported("ManuSystem.restart_query_node", "core/retry.py")
    recover_failures = _not_ported("ManuSystem.recover_failures", "core/retry.py")
    reconcile_sealed = _not_ported("ManuSystem.reconcile_sealed", "core/retry.py")
    heal_attr_satellites = _not_ported("ManuSystem.heal_attr_satellites", "core/retry.py")
    restart = _not_ported("ManuSystem.restart", "core/retry.py")

    # ----------------------------------------------------------------- DDL
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
        self.pump()
        return coll

    def drop_collection(self, name: str) -> None:
        self.root_coord.drop_collection(name)
        self.collections.pop(name, None)

    # ---------------------------------------------------------- partitions
    def create_partition(self, name: str, partition: str) -> None:
        self.root_coord.create_partition(name, partition)
        self.pump()


    def drop_partition(self, name: str, partition: str) -> dict:
        """Drop a partition: unregister it, retire its sealed segments,
        discard its growing rows, and broadcast ``partition_dropped`` so
        serving nodes release their copies.  Like ``drop_collection``, the
        drop is not MVCC-gated.  The pks that lived only in the partition
        are then broadcast as ``tombstones_folded`` (``compact_ts`` = the
        drop ts), which the query nodes record for pruning at the retention
        horizon; the pruning itself is compaction's, not ported yet."""
        self.run_until_idle()  # let in-flight seals land first
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
        self.run_until_idle()
        return {"partition": partition, "segments_dropped": len(sids)}


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
        self.pump()

    # ---------------------------------------------------------------- pump

    def pump(self, rounds: int = 1) -> bool:
        """One cooperative scheduling round over every component."""
        progress = False
        for _ in range(rounds):
            # Alive nodes heartbeat every round: consistency waits advance
            # the manual clock, which must never expire a *live* lease.
            for node_id, qn in self.query_nodes.items():
                if qn.alive and node_id in self.query_coord.nodes:
                    self.query_coord.heartbeat(node_id)
            for lg in self.loggers:
                if lg.alive:
                    lg.tick(self.broker.channels("dml/"))
            for dn in self.data_nodes:
                progress |= bool(dn.step())
            progress |= self.index_coord.step()
            for ix in self.index_nodes:
                progress |= bool(ix.step())
            progress |= self.query_coord.step()
            for qn in self.query_nodes.values():
                progress |= bool(qn.step())
            # Ingest scheduler age trigger: admitted-but-unflushed writes
            # never outlive ``ingest_flush_ms`` of pump activity.
            progress |= self.scheduler.step()
        return progress

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
        lines.append(f"pending: index_tasks={len(self.index_coord.pending_tasks)}")
        for ev in self.event_log.query()[-10:]:
            lines.append(f"event {ev.kind} src={ev.source} {ev.detail}")
        return "\n  ".join(lines)


    # --------------------------------------------------- compaction & GC
    compact = _not_ported("ManuSystem.compact", "core/compaction.py")
    gc = _not_ported("ManuSystem.gc", "core/compaction.py (GCReaper)")

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
            wait_fn=self._cooperative_wait, hedge_timeout_s=hedge_timeout_s,
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

    # -------------------------------------------------------- time travel
    # MVCC reads pinned in the past (``search(time_travel_ts=)``) are
    # ported; checkpoints and restores into a separate collection are not.
    checkpoint_collection = _not_ported("ManuSystem.checkpoint_collection", "core/time_travel.py")
    restore_collection = _not_ported("ManuSystem.restore_collection", "core/time_travel.py")


    # ------------------------------------------------------------ metrics
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
            "metrics": self.metrics().to_dict(),
            "events": len(self.event_log),
        }
