"""Loggers: WAL entry points (paper Fig. 4, §4.2); mirrors
``repro.core.logger_node``.  The logger is host work: it splits each batch
with ``ops.shard_split`` on the host and publishes numpy payloads, which
every subscriber copies to its own device once, on consume.

Loggers sit in a consistent-hash ring; each owns one or more shards
(logical buckets).  Every mutation arrives as one typed request
(:class:`InsertRequest` / :class:`DeleteRequest` / :class:`UpsertRequest`):
the owning logger verifies it, obtains ONE LSN from the TSO (row-level
ACID: all rows of a request share it), splits the batch over shards with
a single vectorized hash + ``bincount``/``argsort`` scatter, resolves the
*segment* each entity belongs to (consulting the data coordinator's
per-partition allocations), and appends one entry per touched shard to
the WAL channels.  The answer is a :class:`MutationResult` whose
``watermark_ts`` feeds SESSION-consistency reads.

Upserts publish a single ``UPSERT`` record per shard carrying both the
delete-by-pk half and the insert half, so MVCC visibility of the old and
new row versions flips atomically at the record's LSN.

Loggers also emit the periodic time-ticks that drive delta consistency.
"""

from __future__ import annotations

import threading

import numpy as np

from ..kernels import ops
from .collection import CollectionInfo, validate_rows
from .log import EntryType, LogBroker, LogEntry, dml_channel, shards_of_pks
from .request import (
    DeleteRequest,
    InsertRequest,
    MutationRequest,
    MutationResult,
    UpsertRequest,
)
from .telemetry import MetricsRegistry
from .timestamp import TSO, Clock


def _split(pks: np.ndarray, num_shards: int) -> "tuple[np.ndarray, list[int]]":
    """Row order grouped by shard and the shard offsets, as host values."""
    order, offsets = ops.shard_split(shards_of_pks(pks, num_shards), num_shards)
    return order.numpy(), offsets.tolist()


class Logger:
    """One logger instance; owns a set of shards for each collection."""

    def __init__(
        self,
        logger_id: str,
        broker: LogBroker,
        tso: TSO,
        data_coord,  # DataCoordinator (duck-typed to avoid import cycle)
        clock: Clock,
        tick_interval_ms: float = 50.0,
        metrics: MetricsRegistry | None = None,
        wal_lock: "threading.Lock | None" = None,
    ):
        self.logger_id = logger_id
        self.broker = broker
        self.tso = tso
        self.data_coord = data_coord
        self.clock = clock
        self.tick_interval_ms = tick_interval_ms
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._last_tick_ms: dict[str, float] = {}
        self.alive = True
        # Serializes LSN-assign + WAL publish: the broker enforces
        # monotonic per-channel timestamps, so a threaded scheduler flush
        # racing a user-thread mutation must not interleave the two steps.
        # A system shares one lock among its loggers (``wal_lock``): every
        # logger ticks every channel, so a tick on the pump thread must not
        # land between another logger's LSN and its publish.
        self._lock = wal_lock if wal_lock is not None else threading.Lock()

    # ----------------------------------------------------------- mutations
    def mutate(
        self,
        info: CollectionInfo,
        request: MutationRequest,
        trace: tuple | None = None,
    ) -> MutationResult:
        """Validate, assign one LSN, split by shard, publish to the WAL.

        ``trace`` is the optional ``(TraceContext, parent Span)`` pair from
        a traced ``Proxy.mutate``: the WAL append gets a child span with
        the touched shard count and rows written.
        """
        if not self.alive:
            raise RuntimeError(f"logger {self.logger_id} is down")
        with self._lock:
            return self._mutate_one(info, request, trace)

    def mutate_batch(
        self,
        info: CollectionInfo,
        requests: "list[MutationRequest]",
        traces: "list[tuple | None] | None" = None,
        prevalidated: bool = False,
    ) -> "list[MutationResult | Exception]":
        """One WAL-entry-point crossing for a scheduler-flushed batch.

        Each request keeps its OWN LSN and its own result slot — batching
        amortizes the call and the lock, never merges semantics.  Per-slot
        failures come back as the exception object (the scheduler fails
        just that ticket); ``Crash`` is a BaseException and still
        propagates, killing the whole flush like any other process death.
        ``prevalidated`` skips per-request schema validation: the
        scheduler already ran it at admission time.
        """
        if not self.alive:
            raise RuntimeError(f"logger {self.logger_id} is down")
        if traces is None:
            traces = [None] * len(requests)
        out: "list[MutationResult | Exception]" = []
        with self._lock:
            for request, trace in zip(requests, traces):
                try:
                    out.append(
                        self._mutate_one(info, request, trace,
                                         prevalidated=prevalidated)
                    )
                except Exception as exc:
                    out.append(exc)
        self.metrics.inc("logger_batches_total")
        self.metrics.observe("logger_batch_requests", len(requests))
        return out

    def _mutate_one(
        self,
        info: CollectionInfo,
        request: MutationRequest,
        trace: tuple | None = None,
        prevalidated: bool = False,
    ) -> MutationResult:
        import time as _t

        t0 = _t.perf_counter()
        if isinstance(request, UpsertRequest):
            res = self._write_rows(info, request.rows, request.partition,
                                   upsert=True, prevalidated=prevalidated)
        elif isinstance(request, InsertRequest):
            res = self._write_rows(info, request.rows, request.partition,
                                   upsert=False, prevalidated=prevalidated)
        elif isinstance(request, DeleteRequest):
            if not prevalidated:
                request.validate(info.schema)
            res = self._delete(info, request.pks)
        else:
            raise TypeError(f"unknown mutation request {type(request).__name__}")
        elapsed_us = (_t.perf_counter() - t0) * 1e6
        self.metrics.observe("wal_append_latency_us", elapsed_us)
        self.metrics.inc("logger_rows_written_total", res.ack_rows)
        self.metrics.inc(
            "logger_mutations_total", labels={"op": res.op}
        )
        if trace is not None:
            ctx, parent = trace
            span = ctx.span(
                "wal_append", parent=parent, node_id=self.logger_id,
                detail=(
                    f"op={res.op};shards={sorted(res.shard_lsns)};"
                    f"lsn={res.watermark_ts}"
                ),
            )
            span.duration_us = elapsed_us
            span.rows_scanned = res.ack_rows
        return res

    def _write_rows(
        self,
        info: CollectionInfo,
        rows: dict[str, np.ndarray],
        partition: str,
        upsert: bool,
        prevalidated: bool = False,
    ) -> MutationResult:
        if prevalidated:  # the scheduler verified at admission time
            n = len(next(iter(rows.values())))
        else:
            n = validate_rows(info.schema, rows)  # the logger verifies (Fig. 4)
        pk_field = info.schema.primary()
        explicit = pk_field is not None and pk_field.name in rows
        if explicit:
            pks = np.asarray(rows[pk_field.name])
            # keep the auto-ID watermark ahead of user-supplied keys so
            # allocation never collides and no-match deletes stay cheap
            self.data_coord.id_alloc.note_explicit(info.name, pks)
        else:
            pks = self.data_coord.allocate_pks(info.name, n)
        # String keys route by their own hash; rows carry their int64 ids.
        ids = self._string_ids(info, pks, assign=True)
        # Fresh auto-IDs cannot collide: nothing to replace, plain insert.
        upsert = upsert and explicit

        lsn = self.tso.next()
        # One vectorized hash over the whole batch, then a bincount/argsort
        # scatter into per-shard row groups — no per-row Python loops.
        order, offsets = _split(pks, info.num_shards)

        # The first vector field is the segment's primary "vector" column;
        # additional vector fields ride the extras columns under their own
        # names (same path as attributes), so multi-vector rows stay columnar
        # end to end (WAL -> growing segment -> binlog).
        vec_fields = info.schema.vector_fields()
        vectors = np.asarray(rows[vec_fields[0].name], np.float32)
        extras_all = {
            f.name: np.asarray(rows[f.name])
            for f in info.schema.attribute_fields()
            if f.name in rows
        }
        extras_all.update(
            {
                f.name: np.asarray(rows[f.name], np.float32)
                for f in vec_fields[1:]
                if f.name in rows
            }
        )
        shard_lsns: dict[int, int] = {}
        for shard in range(info.num_shards):
            sel = order[offsets[shard] : offsets[shard + 1]]
            if sel.size == 0:
                continue
            segment_id = self.data_coord.assign_segment(
                info.name, shard, len(sel), partition
            )
            payload = {
                "collection": info.name,
                "shard": shard,
                "segment_id": segment_id,
                "partition": partition,
                **self._pk_payload(pks, ids, sel),
                "vector": vectors[sel],
                "extras": {f: a[sel] for f, a in extras_all.items()},
            }
            self.broker.publish(
                dml_channel(info.name, shard),
                LogEntry(
                    ts=lsn,
                    type=EntryType.UPSERT if upsert else EntryType.INSERT,
                    payload=payload,
                ),
            )
            shard_lsns[shard] = lsn
        if upsert and shard_lsns:
            self._broadcast_tombstones(info.name, pks if ids is None else ids, lsn)
        return MutationResult(
            op="upsert" if upsert else "insert",
            pks=pks,
            shard_lsns=shard_lsns,
            watermark_ts=lsn,
            row_count=n,
            ack_rows=n,
        )

    def _delete(self, info: CollectionInfo, pks: np.ndarray) -> MutationResult:
        pks = np.atleast_1d(np.asarray(pks))
        requested = len(pks)
        if pks.size and pks.dtype.kind in "iu":
            # Cheap no-match rejection: integer keys beyond the allocator's
            # high watermark (or negative) were never inserted.
            high = self.data_coord.id_alloc.high(info.name)
            pks = pks[(pks >= 0) & (pks < high)]
        ids = self._string_ids(info, pks, assign=False)
        if ids is not None:  # string keys never written match nothing
            pks, ids = pks[ids >= 0], ids[ids >= 0]
        if pks.size == 0:
            # No-op: publish nothing, but hand back a valid watermark — the
            # last issued timestamp is already covered by any read that
            # waits on it, so a SESSION follow-up costs nothing.
            return MutationResult(
                op="delete",
                pks=pks,
                shard_lsns={},
                watermark_ts=self.tso.last_issued(),
                row_count=requested,
                ack_rows=0,
            )
        lsn = self.tso.next()
        order, offsets = _split(pks, info.num_shards)
        shard_lsns: dict[int, int] = {}
        for shard in range(info.num_shards):
            sel = order[offsets[shard] : offsets[shard + 1]]
            if sel.size == 0:
                continue
            self.broker.publish(
                dml_channel(info.name, shard),
                LogEntry(
                    ts=lsn,
                    type=EntryType.DELETE,
                    payload={
                        "collection": info.name,
                        "shard": shard,
                        **self._pk_payload(pks, ids, sel),
                    },
                ),
            )
            shard_lsns[shard] = lsn
        self._broadcast_tombstones(info.name, pks if ids is None else ids, lsn)
        return MutationResult(
            op="delete",
            pks=pks,
            shard_lsns=shard_lsns,
            watermark_ts=lsn,
            row_count=requested,
            ack_rows=len(pks),
        )

    def _string_ids(self, info: CollectionInfo, pks: np.ndarray, assign: bool):
        """The int64 ids of string keys (``IdAllocator.string_ids``); None
        for integer keys, which are their own ids."""
        if pks.dtype.kind not in "USO":
            return None
        return self.data_coord.id_alloc.string_ids(info.name, pks, assign=assign)

    @staticmethod
    def _pk_payload(pks: np.ndarray, ids, sel: np.ndarray) -> dict:
        """A WAL record's keys: ``pk`` is what segments and tombstones
        store (int64); string keys ride beside their ids as ``user_pk``."""
        if ids is None:
            return {"pk": pks[sel]}
        return {"pk": ids[sel], "user_pk": pks[sel]}

    def _broadcast_tombstones(
        self, collection: str, pks: np.ndarray, lsn: int
    ) -> None:
        """Mirror the full tombstone set onto the broadcast coord channel.

        Per-shard DELETE entries only reach the query node that owns that
        shard's DML channel, but sealed-segment placement is not shard-affine
        (handoffs and restarts move segments across nodes).  The coord mirror
        — carried at the SAME LSN as the DML halves, and replayed from
        position 0 by every (re)started query node — guarantees every server
        of a sealed copy learns about the kills.  Appliers dedup by (pk, ts),
        so double delivery via both channels is harmless."""
        self.broker.publish(
            "coord",
            LogEntry(
                ts=lsn,
                type=EntryType.COORD,
                payload={
                    "msg": "tombstones",
                    "collection": collection,
                    "pk": pks,
                },
            ),
        )

    # ------------------------------------------------------ legacy facades
    def insert(self, info: CollectionInfo, rows: dict[str, np.ndarray]) -> tuple[int, int]:
        """Legacy surface: (lsn, row_count) via the typed pipeline."""
        res = self.mutate(info, InsertRequest(rows))
        return res.watermark_ts, res.row_count

    def delete(self, info: CollectionInfo, pks: np.ndarray) -> int:
        """Legacy surface: bare LSN via the typed pipeline."""
        return self.mutate(info, DeleteRequest(pks)).watermark_ts

    # ---------------------------------------------------------- time ticks
    def tick(self, channels: list[str], force: bool = False) -> int:
        """Emit time-ticks on owned channels if the interval elapsed."""
        now = self.clock.now_ms()
        emitted = 0
        for ch in channels:
            last = self._last_tick_ms.get(ch, -1e18)
            if force or (now - last) >= self.tick_interval_ms:
                with self._lock:
                    ts = self.tso.next()
                    self.broker.publish(
                        ch, LogEntry(ts=ts, type=EntryType.TIME_TICK, payload={})
                    )
                self._last_tick_ms[ch] = now
                emitted += 1
        return emitted
