"""The coordinator layer (paper §3.2): root, data, query, index; mirrors
``repro.core.coordinator`` (host logic, no device state).

Coordinators keep all authoritative state in the meta store (etcd role) and
communicate with workers exclusively through the coordination log channel —
"the log system provides a simple and reliable mechanism for broadcasting
system events" (§3.3).  Each coordinator is a deterministic state machine
with ``step()``; multiple instances could run main+backup off the meta
store, which we model with a single instance plus full state recovery from
the meta store (see ``QueryCoordinator.recover_state``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from .collection import CollectionInfo, Metric, Schema
from .log import (
    COORD_CHANNEL,
    DDL_CHANNEL,
    EntryType,
    LogBroker,
    LogEntry,
    Subscription,
    dml_channel,
)
from .meta_store import MetaStore, SegmentMap
from .segment import DEFAULT_PARTITION
from .telemetry import EventLog
from .timestamp import TSO, Clock

DEFAULT_SEAL_ROWS = 8_192


class IdAllocator:
    """Typed auto-ID allocator (paper §3.2: the root coordinator assigns
    entity IDs).  Hands out dense per-collection int64 ranges and tracks a
    high watermark across *explicit* user keys too, so the write path can
    cheaply reject deletes of never-allocated pks (the no-match no-op).

    The watermark is checkpointed to the meta store (``id_alloc/{coll}``)
    so a restarted system never re-issues an id and no-match rejection
    stays sound across crashes.

    String primary keys get int64 surrogate ids (``string_ids``), dense per
    collection in the order the keys are first written: segments, tombstones
    and binlogs carry the ids; the WAL record carries both.  Each batch of
    new keys is checkpointed as one ``string_pks/{coll}/{first id}`` record,
    so a restarted system maps every key to the id its rows were written
    under.  (The reference keeps the strings in its segments.)"""

    def __init__(self, meta: "MetaStore | None" = None) -> None:
        self._next: dict[str, int] = {}
        self._string_ids: dict[str, dict[str, int]] = {}
        self.meta = meta
        self._lock = threading.Lock()

    def _persist(self, collection: str) -> None:
        if self.meta is not None:
            self.meta.put(
                f"id_alloc/{collection}", {"next": self._next[collection]}
            )

    def allocate(self, collection: str, n: int) -> "np.ndarray":
        import numpy as np

        start = self._next.get(collection, 0)
        self._next[collection] = start + n
        self._persist(collection)
        return np.arange(start, start + n, dtype=np.int64)

    def note_explicit(self, collection: str, pks) -> None:
        """Bump the watermark past user-supplied integer keys."""
        import numpy as np

        pks = np.asarray(pks)
        if pks.size and pks.dtype.kind in "iu":
            cur = self._next.get(collection, 0)
            new = max(cur, int(pks.max()) + 1)
            if new != cur:
                self._next[collection] = new
                self._persist(collection)

    def high(self, collection: str) -> int:
        """Exclusive upper bound of every pk ever seen for the collection."""
        return self._next.get(collection, 0)

    def string_ids(self, collection: str, keys, assign: bool = True) -> "np.ndarray":
        """int64 surrogate ids of string keys: a key seen before keeps its
        id; a new one takes the next id when ``assign``, else -1."""
        import numpy as np

        keys = np.asarray(keys).astype(np.str_).tolist()
        with self._lock:
            ids = self._string_ids.setdefault(collection, {})
            if assign:
                fresh = list(dict.fromkeys(k for k in keys if k not in ids))
                if fresh:
                    start = len(ids)
                    ids.update((k, start + i) for i, k in enumerate(fresh))
                    if self.meta is not None:
                        self.meta.put(f"string_pks/{collection}/{start:012d}", {"keys": fresh})
            return np.array([ids.get(k, -1) for k in keys], np.int64)

    def forget(self, collection: str) -> None:
        self._next.pop(collection, None)
        self._string_ids.pop(collection, None)
        if self.meta is not None:
            self.meta.delete(f"id_alloc/{collection}")
            for key in self.meta.scan(f"string_pks/{collection}/"):
                self.meta.delete(key)

    def recover(self) -> None:
        """Reload watermarks and string-key ids from the meta-store
        checkpoints."""
        if self.meta is None:
            return
        for key, rec in self.meta.scan("id_alloc/").items():
            coll = key.split("/", 1)[1]
            self._next[coll] = max(self._next.get(coll, 0), int(rec.get("next", 0)))
        for key, rec in sorted(self.meta.scan("string_pks/").items()):
            _, coll, start = key.rsplit("/", 2)
            ids = self._string_ids.setdefault(coll, {})
            ids.update((k, int(start) + i) for i, k in enumerate(rec["keys"]))


# ---------------------------------------------------------------------------
# Root coordinator: DDL
# ---------------------------------------------------------------------------


class RootCoordinator:
    def __init__(self, broker: LogBroker, meta: MetaStore, tso: TSO):
        self.broker = broker
        self.meta = meta
        self.tso = tso
        self.broker.create_channel(DDL_CHANNEL)
        self.broker.create_channel(COORD_CHANNEL)

    def create_collection(
        self,
        name: str,
        schema: Schema,
        num_shards: int = 2,
        metric: Metric = Metric.L2,
        seal_rows: int = DEFAULT_SEAL_ROWS,
        replication_factor: int = 1,
    ) -> CollectionInfo:
        if self.meta.get(f"collection/{name}") is not None:
            raise ValueError(f"collection '{name}' already exists")
        if not isinstance(replication_factor, int) or replication_factor < 1:
            raise ValueError(
                f"replication_factor must be an int >= 1, got {replication_factor!r}"
            )
        ts = self.tso.next()
        info = CollectionInfo(
            name=name, schema=schema, num_shards=num_shards, metric=metric,
            created_ts=ts, replication_factor=replication_factor,
        )
        for shard in range(num_shards):
            self.broker.create_channel(dml_channel(name, shard))
        self.meta.put(
            f"collection/{name}",
            {
                "name": name,
                "num_shards": num_shards,
                "metric": metric.value,
                "created_ts": ts,
                "seal_rows": seal_rows,
                "dim": info.schema.vector_fields()[0].dim,
                "replication_factor": replication_factor,
                # full schema so a restarted system can reconstruct the
                # CollectionInfo without any in-memory survivor
                "schema": schema.to_dict(),
            },
        )
        # Every collection starts with the implicit default partition.
        self.meta.put(
            f"partition/{name}/{DEFAULT_PARTITION}",
            {"name": DEFAULT_PARTITION, "created_ts": ts},
        )
        self.broker.publish(
            DDL_CHANNEL,
            LogEntry(ts=ts, type=EntryType.DDL,
                     payload={"msg": "create_collection", "name": name}),
        )
        return info

    def drop_collection(self, name: str) -> None:
        ts = self.tso.next()
        self.meta.delete(f"collection/{name}")
        for key in self.meta.scan(f"partition/{name}/"):
            self.meta.delete(key)
        self.broker.publish(
            DDL_CHANNEL,
            LogEntry(ts=ts, type=EntryType.DDL,
                     payload={"msg": "drop_collection", "name": name}),
        )

    # ------------------------------------------------------------ partitions
    def create_partition(self, collection: str, partition: str) -> None:
        """Register a named partition (paper §3.1: collection → shard →
        partition → segment).  The meta store is the authoritative list;
        proxies watch the prefix to verify placement early."""
        if self.meta.get(f"collection/{collection}") is None:
            raise KeyError(f"collection '{collection}' does not exist")
        if not partition or "/" in partition:
            raise ValueError(f"invalid partition name '{partition}'")
        key = f"partition/{collection}/{partition}"
        if self.meta.get(key) is not None:
            raise ValueError(
                f"partition '{partition}' already exists in '{collection}'"
            )
        ts = self.tso.next()
        self.meta.put(key, {"name": partition, "created_ts": ts})
        self.broker.publish(
            DDL_CHANNEL,
            LogEntry(ts=ts, type=EntryType.DDL,
                     payload={"msg": "create_partition", "name": collection,
                              "partition": partition}),
        )

    def drop_partition(self, collection: str, partition: str) -> int:
        """Unregister a partition; returns the drop timestamp.  The system
        facade broadcasts the matching ``partition_dropped`` coordination
        message so serving nodes release the partition's segments."""
        if partition == DEFAULT_PARTITION:
            raise ValueError("the default partition cannot be dropped")
        key = f"partition/{collection}/{partition}"
        if self.meta.get(key) is None:
            raise KeyError(f"no partition '{partition}' in '{collection}'")
        ts = self.tso.next()
        self.meta.delete(key)
        self.broker.publish(
            DDL_CHANNEL,
            LogEntry(ts=ts, type=EntryType.DDL,
                     payload={"msg": "drop_partition", "name": collection,
                              "partition": partition}),
        )
        return ts

    def partitions(self, collection: str) -> list[str]:
        return sorted(
            key.rsplit("/", 1)[1]
            for key in self.meta.scan(f"partition/{collection}/")
        )


# ---------------------------------------------------------------------------
# Data coordinator: segment allocation, sealing policy, compaction triggers
# ---------------------------------------------------------------------------


@dataclass
class SegmentAlloc:
    segment_id: int
    rows: int = 0
    last_alloc_ms: float = 0.0


class DataCoordinator:
    def __init__(self, broker: LogBroker, meta: MetaStore, tso: TSO, clock: Clock):
        self.broker = broker
        self.meta = meta
        self.tso = tso
        self.clock = clock
        self._next_segment = 1
        self.id_alloc = IdAllocator(meta)
        # (collection, shard, partition) -> current growing allocation;
        # partitions are a placement surface, so each gets its own growing
        # segment per shard and sealed segments never mix partitions.
        self._growing: dict[tuple[str, int, str], SegmentAlloc] = {}
        self._to_seal: set[tuple[str, int]] = set()  # (collection, segment_id)
        self._sealed_rows: dict[tuple[str, int], int] = {}
        # Every segment ever sealed (sealed, retired, dropped or reclaimed).
        self._recorded: set[tuple[str, int]] = set()
        self._sealed_upto_pos: dict[tuple[str, int], int] = {}  # per channel shard
        self.segment_map = SegmentMap(meta)
        # Allocation and sealing: in threaded mode loggers allocate on the
        # caller's thread while the data node seals on the pump thread.
        self._lock = threading.RLock()

    # ------------------------------------------------------------ allocation
    def allocate_pks(self, collection: str, n: int):
        return self.id_alloc.allocate(collection, n)

    def _alloc_sid(self) -> int:
        """Allocate a segment id; the sequence is checkpointed to the meta
        store so a restarted coordinator never reuses one."""
        sid = self._next_segment
        self._next_segment += 1
        self.meta.put("segment_seq", {"next": self._next_segment})
        return sid

    def seal_rows_for(self, collection: str) -> int:
        info = self.meta.get(f"collection/{collection}") or {}
        return int(info.get("seal_rows", DEFAULT_SEAL_ROWS))

    def assign_segment(
        self,
        collection: str,
        shard: int,
        n_rows: int,
        partition: str = DEFAULT_PARTITION,
    ) -> int:
        key = (collection, shard, partition)
        with self._lock:
            alloc = self._growing.get(key)
            if alloc is None:
                alloc = SegmentAlloc(self._alloc_sid())
                self._growing[key] = alloc
            alloc.rows += n_rows
            alloc.last_alloc_ms = self.clock.now_ms()
            if alloc.rows >= self.seal_rows_for(collection):
                self._to_seal.add((collection, alloc.segment_id))
                self._growing[key] = SegmentAlloc(self._alloc_sid())
            return alloc.segment_id

    # --------------------------------------------------------------- sealing
    def marked_to_seal(self) -> frozenset:
        """The (collection, segment_id) pairs marked to seal, as of now."""
        with self._lock:
            return frozenset(self._to_seal)

    def on_sealed(
        self,
        collection: str,
        segment_id: int,
        rows: int,
        partition: str = DEFAULT_PARTITION,
        shard: int = 0,
        attr_fields=None,
    ) -> None:
        with self._lock:
            self._to_seal.discard((collection, segment_id))
            self._sealed_rows[(collection, segment_id)] = rows
            self._recorded.add((collection, segment_id))
        self.meta.put(
            f"segment/{collection}/{segment_id}",
            {
                "rows": rows,
                "state": "sealed",
                "partition": partition,
                "shard": shard,
                "visible_from_ts": 0,
            },
        )
        self._record_attr_fields(collection, segment_id, rows, attr_fields)
        self.segment_map.apply(
            collection, add=[segment_id], ts=self.tso.last_issued()
        )

    def _record_attr_fields(
        self, collection: str, segment_id: int, rows: int, attr_fields
    ) -> None:
        """Meta-key the segment's attribute-index satellites (mirrors the
        per-field vector index records) so GC and recovery can enumerate
        them without listing the object store."""
        for f in attr_fields or ():
            self.meta.put(
                f"attr_index/{collection}/{segment_id}/{f}",
                {"field": f, "rows": rows, "state": "ready"},
            )

    def allocate_segment_id(self) -> int:
        """Reserve a fresh segment id (compaction rewrite targets)."""
        return self._alloc_sid()

    def on_compacted(
        self,
        collection: str,
        sources: list[int],
        targets: list[dict],
        partition: str = DEFAULT_PARTITION,
        shard: int = 0,
        compact_ts: int = 0,
        attr_fields=None,
    ) -> None:
        """Swap segment identity after a compaction rewrite completed.

        ``targets`` is the rewrite output: [{"segment_id", "num_rows"}, ...].
        """
        target_ids = [t["segment_id"] for t in targets]
        for sid in sources:
            self._sealed_rows.pop((collection, sid), None)
            old = self.meta.get(f"segment/{collection}/{sid}") or {}
            self.meta.put(
                f"segment/{collection}/{sid}",
                {
                    "rows": 0,
                    "state": "retired",
                    "compacted_into": target_ids,
                    "partition": old.get("partition", partition),
                    "shard": old.get("shard", shard),
                    # keep the source's MVCC window so a restart can still
                    # serve reads pinned before the swap
                    "visible_from_ts": int(old.get("visible_from_ts", 0)),
                    "retired_at_ts": compact_ts,
                },
            )
        for t in targets:
            self._sealed_rows[(collection, t["segment_id"])] = t["num_rows"]
            self._recorded.add((collection, t["segment_id"]))
            self.meta.put(
                f"segment/{collection}/{t['segment_id']}",
                {
                    "rows": t["num_rows"],
                    "state": "sealed",
                    "partition": partition,
                    "shard": shard,
                    "visible_from_ts": compact_ts,
                },
            )
            self._record_attr_fields(
                collection, t["segment_id"], t["num_rows"], attr_fields
            )

    def flush(self, collection: str) -> list[int]:
        """Force-seal every growing segment of a collection."""
        with self._lock:
            sealed = []
            for (coll, shard, part), alloc in list(self._growing.items()):
                if coll != collection or alloc.rows == 0:
                    continue
                self._to_seal.add((coll, alloc.segment_id))
                sealed.append(alloc.segment_id)
                self._growing[(coll, shard, part)] = SegmentAlloc(self._alloc_sid())
            return sealed

    def seal_idle(self, max_idle_ms: float) -> list[int]:
        """Time-based sealing (paper: seal after a period without inserts)."""
        with self._lock:
            now = self.clock.now_ms()
            sealed = []
            for (coll, shard, part), alloc in list(self._growing.items()):
                if alloc.rows > 0 and (now - alloc.last_alloc_ms) >= max_idle_ms:
                    self._to_seal.add((coll, alloc.segment_id))
                    sealed.append(alloc.segment_id)
                    self._growing[(coll, shard, part)] = SegmentAlloc(self._alloc_sid())
            return sealed

    def segment_recorded(self, collection: str, segment_id: int) -> bool:
        """Whether the segment was ever sealed (sealed, retired, dropped or
        reclaimed): its WAL inserts are no longer growing rows."""
        return (collection, segment_id) in self._recorded

    def sealed_segments(self, collection: str) -> list[int]:
        return sorted(sid for (c, sid) in self._sealed_rows if c == collection)

    def segment_partition(self, collection: str, segment_id: int) -> str:
        info = self.meta.get(f"segment/{collection}/{segment_id}") or {}
        return info.get("partition", DEFAULT_PARTITION)

    def partition_segments(self, collection: str, partition: str) -> list[int]:
        """Sealed segments currently placed under ``partition``."""
        return sorted(
            sid
            for (c, sid) in self._sealed_rows
            if c == collection
            and self.segment_partition(collection, sid) == partition
        )

    def drop_partition_state(self, collection: str, partition: str, ts: int) -> list[int]:
        """Forget a dropped partition's placement: clear its growing
        allocations and retire its sealed segments (marked for GC).
        Returns the retired sealed segment ids."""
        for key in [k for k in self._growing if k[0] == collection and k[2] == partition]:
            self._to_seal.discard((collection, self._growing[key].segment_id))
            del self._growing[key]
        sids = self.partition_segments(collection, partition)
        for sid in sids:
            self._sealed_rows.pop((collection, sid), None)
            self.meta.put(
                f"segment/{collection}/{sid}",
                {"rows": 0, "state": "retired", "partition": partition},
            )
            self.meta.put(
                f"retired_segment/{collection}/{sid}",
                {"retired_at_ts": ts, "compacted_into": []},
            )
        if sids:
            self.segment_map.apply(collection, remove=sids, ts=ts)
        return sids

    def record_sealed_position(self, collection: str, shard: int, pos: int) -> None:
        key = (collection, shard)
        cur = self.replay_position(collection, shard)
        new = max(cur, pos)
        self._sealed_upto_pos[key] = new
        if new != cur:
            # durable checkpoint: a restarted system replays from here
            self.meta.put(f"replay/{collection}/{shard}", {"pos": new})

    def replay_position(self, collection: str, shard: int) -> int:
        """WAL position from which a recovering node must replay."""
        key = (collection, shard)
        pos = self._sealed_upto_pos.get(key)
        if pos is None:
            rec = self.meta.get(f"replay/{collection}/{shard}") or {}
            pos = int(rec.get("pos", 0))
            self._sealed_upto_pos[key] = pos
        return pos

    # -------------------------------------------------------------- recovery
    def recover_state(self, store=None) -> dict:
        """Rebuild allocator + sealing state after a full restart.

        Sealed/retired segments come from the ``segment/`` meta records; the
        growing allocations are reconstructed by replaying the WAL and
        counting rows of every segment that never reached a binlog — exactly
        the rows the data nodes themselves rebuild.  ``store`` (optional)
        lets the scan also skip segments whose binlog survived a crash that
        lost the ``segment_sealed`` announcement; the system-level
        reconciliation re-announces those.
        """
        self.id_alloc.recover()
        seq = self.meta.get("segment_seq") or {}
        self._next_segment = max(self._next_segment, int(seq.get("next", 1)))
        sealed = 0
        for key, rec in self.meta.scan("segment/").items():
            _, coll, sid_s = key.split("/")
            sid = int(sid_s)
            self._next_segment = max(self._next_segment, sid + 1)
            self._recorded.add((coll, sid))
            if rec.get("state") == "sealed":
                self._sealed_rows[(coll, sid)] = int(rec["rows"])
                sealed += 1
        counts: dict[tuple[str, int, str], dict[int, int]] = {}
        for ckey, info in self.meta.scan("collection/").items():
            coll = ckey.split("/", 1)[1]
            for shard in range(int(info["num_shards"])):
                channel = dml_channel(coll, shard)
                if not self.broker.has_channel(channel):
                    continue
                for e in self.broker.read(channel, 0):
                    if e.type not in (EntryType.INSERT, EntryType.UPSERT):
                        continue
                    p = e.payload
                    sid = p["segment_id"]
                    if (coll, sid) in self._sealed_rows:
                        continue
                    if self.meta.get(f"segment/{coll}/{sid}") is not None:
                        continue  # retired: durable, not growing
                    if store is not None and store.exists(f"binlog/{coll}/{sid}/meta"):
                        continue  # archived; announcement reconciled elsewhere
                    gkey = (coll, shard, p.get("partition", DEFAULT_PARTITION))
                    per = counts.setdefault(gkey, {})
                    per[sid] = per.get(sid, 0) + len(p["pk"])
        growing = 0
        for gkey, per_sid in counts.items():
            coll = gkey[0]
            sids = sorted(per_sid)
            # every sid but the newest had a successor allocated pre-crash,
            # which only happens once the sid was marked for sealing
            for sid in sids[:-1]:
                self._to_seal.add((coll, sid))
            last = sids[-1]
            alloc = SegmentAlloc(
                last, rows=per_sid[last], last_alloc_ms=self.clock.now_ms()
            )
            if per_sid[last] >= self.seal_rows_for(coll):
                self._to_seal.add((coll, last))
                alloc = SegmentAlloc(self._alloc_sid())
            self._growing[gkey] = alloc
            growing += 1
        return {"sealed": sealed, "growing": growing, "to_seal": len(self._to_seal)}


# ---------------------------------------------------------------------------
# Index coordinator: build-task fan-out, idle-node shutdown
# ---------------------------------------------------------------------------


class IndexCoordinator:
    """Per-vector-field index specs: ``index_spec/{collection}/{field}``
    in the meta store, one build task per (segment, field)."""

    def __init__(
        self,
        broker: LogBroker,
        meta: MetaStore,
        tso: TSO,
        events: EventLog | None = None,
    ):
        self.broker = broker
        self.meta = meta
        self.tso = tso
        self.events = events
        self.sub = Subscription(broker, COORD_CHANNEL)
        # (collection, segment_id, field) -> task / index_built payload
        self.pending_tasks: dict[tuple[str, int, str], dict] = {}
        self.built: dict[tuple[str, int, str], dict] = {}

    def set_index_spec(
        self,
        collection: str,
        field: str,
        kind: str,
        params: dict[str, Any] | None = None,
        metric: Metric = Metric.L2,
        column: str | None = None,
    ) -> None:
        """Declare the index of one vector field.  ``column`` is the
        segment column backing the field (the first vector field is stored
        as the primary "vector" column); defaults to the field name."""
        self.meta.put(
            f"index_spec/{collection}/{field}",
            {
                "field": field,
                "column": column or field,
                "kind": kind,
                "params": params or {},
                "metric": metric.value,
            },
        )

    def index_spec(self, collection: str, field: str = "vector") -> dict | None:
        return self.meta.get(f"index_spec/{collection}/{field}")

    def index_specs(self, collection: str) -> dict[str, dict]:
        """All field specs of a collection: field name -> spec."""
        return {
            key.rsplit("/", 1)[1]: spec
            for key, spec in self.meta.scan(f"index_spec/{collection}/").items()
        }

    def _task_of(self, collection: str, segment_id: int, spec: dict) -> dict:
        return {
            "msg": "index_build_task",
            "collection": collection,
            "segment_id": segment_id,
            "field": spec["field"],
            "column": spec.get("column", spec["field"]),
            "index_kind": spec["kind"],
            "params": spec["params"],
            "metric": spec["metric"],
        }

    def step(self) -> bool:
        progress = False
        for entry in self.sub.poll():
            if entry.type is not EntryType.COORD:
                continue
            p = entry.payload
            if p.get("msg") == "segment_sealed":
                for field, spec in self.index_specs(p["collection"]).items():
                    key = (p["collection"], p["segment_id"], field)
                    if key in self.pending_tasks or key in self.built:
                        continue
                    task = self._task_of(p["collection"], p["segment_id"], spec)
                    self.pending_tasks[key] = task
                    self.broker.publish(
                        COORD_CHANNEL,
                        LogEntry(ts=self.tso.next(), type=EntryType.COORD, payload=task),
                    )
                    if self.events is not None:
                        self.events.emit(
                            "index_task", "index_coord",
                            collection=p["collection"],
                            segment_id=p["segment_id"],
                            field=field, index_kind=spec["kind"],
                        )
                    progress = True
            elif p.get("msg") == "index_built":
                field = p.get("field", "vector")
                key = (p["collection"], p["segment_id"], field)
                self.pending_tasks.pop(key, None)
                self.built[key] = p
                self.meta.put(
                    f"index/{p['collection']}/{p['segment_id']}/{field}",
                    {
                        "kind": p["index_kind"],
                        "key": p["index_key"],
                        "column": p.get("column", field),
                    },
                )
                if self.events is not None:
                    self.events.emit(
                        "index_built", "index_coord",
                        collection=p["collection"],
                        segment_id=p["segment_id"],
                        field=field, index_kind=p["index_kind"],
                        built_by=p.get("built_by"),
                    )
                progress = True
            elif p.get("msg") == "segment_compacted":
                # The rewrite produced fresh segments: index them, and forget
                # build state of the sources they replaced.
                for sid in p.get("sources", ()):
                    for key in [
                        k for k in self.pending_tasks
                        if k[:2] == (p["collection"], sid)
                    ]:
                        self.pending_tasks.pop(key, None)
                    for key in [
                        k for k in self.built if k[:2] == (p["collection"], sid)
                    ]:
                        self.built.pop(key, None)
                for t in p["segments"]:
                    if t["num_rows"]:
                        self.rebuild_segment(p["collection"], t["segment_id"])
                progress = True
            elif p.get("msg") == "segment_gc":
                coll, sid = p["collection"], p["segment_id"]
                for key in [k for k in self.pending_tasks if k[:2] == (coll, sid)]:
                    self.pending_tasks.pop(key, None)
                for key in [k for k in self.built if k[:2] == (coll, sid)]:
                    self.built.pop(key, None)
                for ikey in self.meta.scan(f"index/{coll}/{sid}/"):
                    self.meta.delete(ikey)
                for claim in self.meta.scan(f"index_claim/{coll}/{sid}/"):
                    self.meta.delete(claim)
                progress = True
        return progress

    # -------------------------------------------------------------- recovery
    def recover_state(self) -> dict:
        """Rebuild build-state after a restart: adopt finished builds from
        the ``index/`` meta records, clear claims whose builder died before
        finishing, and re-issue tasks for sealed segments missing an index.
        Fast-forwards past the pre-crash coordination history — its durable
        effects were just adopted."""
        adopted = 0
        for key, rec in self.meta.scan("index/").items():
            _, coll, sid_s, field = key.split("/")
            self.built[(coll, int(sid_s), field)] = {
                "msg": "index_built",
                "collection": coll,
                "segment_id": int(sid_s),
                "field": field,
                "column": rec.get("column", field),
                "index_kind": rec["kind"],
                "index_key": rec["key"],
            }
            adopted += 1
        cleared = 0
        for claim in list(self.meta.scan("index_claim/")):
            _, coll, sid_s, field, _kind = claim.split("/")
            if (coll, int(sid_s), field) not in self.built:
                # claimed but never finished: the builder died mid-build
                self.meta.delete(claim)
                cleared += 1
        self.sub.seek(self.broker.end_position(COORD_CHANNEL))
        reissued = 0
        for key, seg in self.meta.scan("segment/").items():
            if seg.get("state") != "sealed":
                continue
            _, coll, sid_s = key.split("/")
            sid = int(sid_s)
            for field, spec in self.index_specs(coll).items():
                k = (coll, sid, field)
                if k in self.built or k in self.pending_tasks:
                    continue
                task = self._task_of(coll, sid, spec)
                self.pending_tasks[k] = task
                self.broker.publish(
                    COORD_CHANNEL,
                    LogEntry(ts=self.tso.next(), type=EntryType.COORD, payload=task),
                )
                reissued += 1
        return {"built": adopted, "claims_cleared": cleared, "tasks_reissued": reissued}

    def rebuild_segment(
        self, collection: str, segment_id: int, fields: "list[str] | None" = None
    ) -> None:
        """Re-issue builds (after compaction, heavy deletes, or a new
        field spec); ``fields=None`` rebuilds every spec'd field."""
        specs = self.index_specs(collection)
        for field, spec in specs.items():
            if fields is not None and field not in fields:
                continue
            self.built.pop((collection, segment_id, field), None)
            self.meta.delete(
                f"index_claim/{collection}/{segment_id}/{field}/{spec['kind']}"
            )
            task = self._task_of(collection, segment_id, spec)
            self.pending_tasks[(collection, segment_id, field)] = task
            self.broker.publish(
                COORD_CHANNEL,
                LogEntry(ts=self.tso.next(), type=EntryType.COORD, payload=task),
            )


# ---------------------------------------------------------------------------
# Query coordinator: replica groups, load balance, failover, scaling
# ---------------------------------------------------------------------------


@dataclass
class QueryNodeState:
    node_id: str
    lease_id: int
    segments: set[tuple[str, int]] = field(default_factory=set)
    channels: set[str] = field(default_factory=set)
    draining: bool = False
    last_beat_ms: float = 0.0


class QueryCoordinator:
    """Single-leader query coordinator (paper §3.2, §3.6).

    Every sealed segment is owned by a **replica group** — an ordered list
    of query nodes (index 0 is the primary).  The authoritative placement
    record lives in the meta store at ``assignment/{coll}/{sid}`` and every
    mutation goes through the CAS-safe ``update_placement`` primitive, so a
    failover racing a rebalance converges on the committed winner instead
    of clobbering it.  Health observation (``HealthMonitor``) and
    convergence (``StateReconciler``) are split per the single-writer
    control-loop idiom: the monitor only observes, the reconciler acts.
    """

    HEARTBEAT_TTL_MS = 5_000

    def __init__(
        self,
        broker: LogBroker,
        meta: MetaStore,
        tso: TSO,
        data_coord: DataCoordinator,
        replication_factor: int = 1,
        heartbeat_ttl_ms: float | None = None,
        events: EventLog | None = None,
    ):
        self.broker = broker
        self.meta = meta
        self.tso = tso
        self.data_coord = data_coord
        self.clock = data_coord.clock
        self.events = events
        self.sub = Subscription(broker, COORD_CHANNEL)
        self.nodes: dict[str, QueryNodeState] = {}
        # (collection, segment_id) -> ordered replica group (node ids);
        # in-memory mirror of the committed ``assignment/`` meta records.
        self.replica_sets: dict[tuple[str, int], list[str]] = {}
        self.replication_factor = max(1, int(replication_factor))
        self.heartbeat_ttl_ms = float(
            heartbeat_ttl_ms if heartbeat_ttl_ms is not None else self.HEARTBEAT_TTL_MS
        )
        # DML channel -> standby follower node ids: replicas that consume
        # the channel (rf > 1) WITHOUT owning it.  Kept out of
        # ``QueryNodeState.channels`` (the ownership/committed surface that
        # failover, drain and cluster_state reason about) — followers are
        # a read-routing surface: the proxy serves bounded-staleness reads
        # from whichever candidate's watermark already covers the request.
        self.channel_followers: dict[str, set[str]] = {}
        # (collection, segment_id) -> {field: index_built payload}
        self._known_indexes: dict[tuple[str, int], dict[str, dict]] = {}
        # (collection, segment_id) -> visible_from_ts MVCC gate of compacted
        # rewrites; must survive failover/rebalance reloads or a pinned
        # query would see both the rewrite and its retired sources.
        self._visible_from: dict[tuple[str, int], int] = {}
        # (collection, segment_id) -> MVCC window of a retired segment
        # version that still serves reads pinned before its swap:
        # {"visible_from_ts", "retired_at_ts", "partition", "indexes",
        # "nodes"}.  Dropped at the retention horizon, GC or a partition
        # drop; a window whose holders all died is served again on a live
        # node (``place_retired_windows``).  The reference keeps no such
        # record and relies on a fresh node replaying its predecessor's
        # commands (ROADMAP Queue 3).
        self.retired_windows: dict[tuple[str, int], dict] = {}
        # Serializes control-loop passes against coordination-log consumption
        # when a threaded watchdog reconciles concurrently with the pump.
        self._mutex = threading.RLock()
        self.health = HealthMonitor(self)
        self.reconciler = StateReconciler(self)

    # ------------------------------------------------------------ membership
    def register_node(self, node_id: str) -> int:
        lease = self.meta.grant_lease(self.heartbeat_ttl_ms)
        self.meta.put(f"querynode/{node_id}", {"node_id": node_id}, lease_id=lease)
        self.nodes[node_id] = QueryNodeState(
            node_id, lease, last_beat_ms=self.clock.now_ms()
        )
        if self.events is not None:
            self.events.emit("node_join", "query_coord", node=node_id)
        return lease

    def heartbeat(self, node_id: str) -> None:
        st = self.nodes.get(node_id)
        if st:
            self.meta.keepalive(st.lease_id)
            st.last_beat_ms = self.clock.now_ms()

    def deregister_node(self, node_id: str) -> None:
        # Revoke the lease only; the node stays in ``self.nodes`` until
        # ``handle_failures`` reassigns its segments/channels (popping it
        # here would orphan its assignments).
        st = self.nodes.get(node_id)
        if st:
            self.meta.revoke_lease(st.lease_id)

    def start_drain(self, node_id: str) -> None:
        """Mark a node for graceful scale-down: it keeps serving, but the
        reconciler sheds its replicas (load-before-release) and it stops
        receiving new placements."""
        st = self.nodes.get(node_id)
        if st:
            st.draining = True
            if self.events is not None:
                self.events.emit(
                    "drain_start", "query_coord",
                    node=node_id, replicas=len(st.segments),
                )

    def live_nodes(self) -> list[str]:
        alive = set(self.meta.scan("querynode/"))
        return sorted(
            n for n in self.nodes if f"querynode/{n}" in alive
        )

    def on_node_down(self, node_id: str) -> None:
        """Immediate failure report from the dispatch path (a request found
        the node dead): revoke its lease and reconcile now rather than
        waiting out the heartbeat TTL."""
        st = self.nodes.get(node_id)
        if st is not None:
            self.meta.revoke_lease(st.lease_id)
        if self.events is not None:
            self.events.emit("node_down_reported", "query_coord", node=node_id)
        self.reconciler.reconcile()

    # ------------------------------------------------------------ placement
    @property
    def assignment(self) -> dict[tuple[str, int], str]:
        """Legacy single-owner view: segment -> primary replica."""
        return {key: nodes[0] for key, nodes in self.replica_sets.items() if nodes}

    def replication_for(self, collection: str) -> int:
        """Desired replica count: per-collection override, else config."""
        info = self.meta.get(f"collection/{collection}") or {}
        return max(1, int(info.get("replication_factor", self.replication_factor)))

    def placement_for(self, collection: str) -> dict[int, list[str]]:
        """segment_id -> replica group, for the proxy's dispatch planner."""
        return {
            sid: list(nodes)
            for (coll, sid), nodes in self.replica_sets.items()
            if coll == collection
        }

    def _placement_candidates(self, exclude: set[str] | None = None) -> list[str]:
        """Live, non-draining nodes eligible to receive new replicas."""
        exclude = exclude or set()
        return [
            n for n in self.live_nodes()
            if n not in exclude and not self.nodes[n].draining
        ]

    def _least_loaded(self, exclude: set[str] | None = None) -> str | None:
        nodes = self._placement_candidates(exclude)
        if not nodes:
            return None
        return min(nodes, key=lambda n: (len(self.nodes[n].segments), n))

    def update_placement(
        self,
        collection: str,
        segment_id: int,
        fn: Callable[[list[str]], "list[str] | None"],
    ) -> list[str]:
        """CAS-safe read-modify-write of one segment's replica group.

        ``fn(current_nodes) -> new_nodes | None`` computes the new replica
        list from the value *actually committed* in the meta store (None
        aborts).  The write is retried until the compare-and-swap lands, so
        a reassignment racing a concurrent rebalance recomputes from the
        winner's committed record instead of overwriting it.  Load/release
        messages and in-memory mirrors are applied only for the committed
        value.  Returns the committed replica list (the pre-existing one on
        abort).
        """
        with self._mutex:
            key = (collection, segment_id)
            mkey = f"assignment/{collection}/{segment_id}"
            desired = self.replication_for(collection)
            while True:
                rev = self.meta.get_rev(mkey)
                cur = self.meta.get(mkey) or {}
                cur_nodes = list(cur.get("nodes") or ())
                if not cur_nodes and cur.get("node"):
                    cur_nodes = [cur["node"]]
                new_nodes = fn(list(cur_nodes))
                if new_nodes is None:
                    return cur_nodes
                new_nodes = list(dict.fromkeys(new_nodes))
                record = {
                    "nodes": new_nodes,
                    "node": new_nodes[0] if new_nodes else None,
                    "visible_from_ts": self._visible_from.get(key, 0),
                    "under_replicated": len(new_nodes) < desired,
                }
                if not self.meta.cas(mkey, rev, record):
                    if self.events is not None:
                        self.events.emit(
                            "placement_cas_retry", "query_coord",
                            collection=collection, segment_id=segment_id,
                        )
                    continue  # lost the race: recompute from the winner
                self._apply_committed(key, new_nodes)
                return new_nodes

    def _apply_committed(self, key: tuple[str, int], new_nodes: list[str]) -> None:
        """Sync mirrors and publish load/release for a committed placement.
        Loads are published before releases, so a segment may briefly live
        on both nodes (the proxy dedups) but never on neither."""
        coll, sid = key
        old = self.replica_sets.get(key, [])
        added = [n for n in new_nodes if n not in old]
        removed = [n for n in old if n not in new_nodes]
        if new_nodes:
            self.replica_sets[key] = list(new_nodes)
        else:
            self.replica_sets.pop(key, None)
            self.meta.delete(f"assignment/{coll}/{sid}")
        for n in added:
            if n not in self.nodes:
                continue
            self.nodes[n].segments.add(key)
            self._publish(
                {
                    "msg": "load_segment",
                    "node_id": n,
                    "collection": coll,
                    "segment_id": sid,
                    "visible_from_ts": self._visible_from.get(key, 0),
                }
            )
            for idx in self._known_indexes.get(key, {}).values():
                self._publish(self._load_index_payload(n, idx))
        for n in removed:
            if n not in self.nodes:
                continue
            self.nodes[n].segments.discard(key)
            self._publish(
                {
                    "msg": "release_segment",
                    "node_id": n,
                    "collection": coll,
                    "segment_id": sid,
                }
            )

    def _fill_replicas(self, nodes: list[str], desired: int) -> list[str]:
        """Top a replica list up to ``desired`` with least-loaded candidates;
        degrades gracefully (shorter list) when the cluster is too small —
        the committed record then carries ``under_replicated: True``."""
        nodes = [n for n in nodes if n in self.nodes and not self.nodes[n].draining]
        while len(nodes) < desired:
            pick = self._least_loaded(exclude=set(nodes))
            if pick is None:
                break
            nodes.append(pick)
        return nodes

    def _publish(self, payload: dict) -> None:
        self.broker.publish(
            COORD_CHANNEL,
            LogEntry(ts=self.tso.next(), type=EntryType.COORD, payload=payload),
        )

    def step(self) -> bool:
        with self._mutex:
            return self._step_locked()

    def _step_locked(self) -> bool:
        progress = False
        for entry in self.sub.poll():
            if entry.type is not EntryType.COORD:
                continue
            p = entry.payload
            msg = p.get("msg")
            if msg == "segment_sealed":
                # The data node names the channel's replay point; the
                # reference records checkpoint_pos + 1, one entry past the
                # next segment's first insert (ROADMAP Queue 3).
                self.data_coord.record_sealed_position(
                    p["collection"], p["shard"], p.get("replay_from", p["checkpoint_pos"])
                )
                progress |= self._assign_segment(p["collection"], p["segment_id"])
            elif msg == "index_built":
                key = (p["collection"], p["segment_id"])
                self._known_indexes.setdefault(key, {})[p.get("field", "vector")] = p
                for node in self.replica_sets.get(key, ()):
                    if node in self.nodes:
                        self._publish(self._load_index_payload(node, p))
                progress = True
            elif msg == "segment_compacted":
                progress |= self._handle_compacted(p)
            elif msg == "partition_dropped":
                self._drop_windows(p)
                progress |= self._handle_partition_dropped(p)
            elif msg in ("retention_advance", "segment_gc"):
                self._drop_windows(p)
        return progress

    def _handle_partition_dropped(self, p: dict) -> bool:
        """Release every replica of a dropped partition's segments."""
        coll = p["collection"]
        changed = False
        for sid in p.get("segment_ids", ()):
            key = (coll, sid)
            owners = self.replica_sets.pop(key, [])
            self._known_indexes.pop(key, None)
            self._visible_from.pop(key, None)
            self.meta.delete(f"assignment/{coll}/{sid}")
            for owner in owners:
                if owner in self.nodes:
                    self.nodes[owner].segments.discard(key)
                    self._publish(
                        {
                            "msg": "release_segment",
                            "node_id": owner,
                            "collection": coll,
                            "segment_id": sid,
                        }
                    )
            changed = True
        return changed

    def _handle_compacted(self, p: dict) -> bool:
        """Hot-swap a compacted rewrite for its source segments.

        The new segments are loaded (gated at ``compact_ts``) before the
        sources are retired, so there is never a serving gap; the sources
        keep answering queries pinned before the swap until the retention
        horizon releases them.
        """
        coll = p["collection"]
        sources = list(p["sources"])
        live = set(self.live_nodes())
        # The primary stays aligned with the shard's DML channel subscriber
        # so future delta deletes keep reaching the node serving the rows.
        ch = dml_channel(coll, p["shard"])
        anchor = next(
            (n for n in sorted(live) if ch in self.nodes[n].channels), None
        )
        if anchor is None:
            owners = [
                n
                for sid in sources
                for n in self.replica_sets.get((coll, sid), ())
                if n in live
            ]
            anchor = (
                max(set(owners), key=owners.count) if owners else self._least_loaded()
            )
        if anchor is None:
            return False
        desired = self.replication_for(coll)
        for t in p["segments"]:
            new_sid = t["segment_id"]
            key = (coll, new_sid)
            if key in self.replica_sets or t["num_rows"] == 0:
                continue
            self._visible_from[key] = p["compact_ts"]

            def place(cur: list[str], anchor: str = anchor) -> list[str]:
                nodes = [n for n in cur if n in self.nodes]
                if anchor not in nodes and anchor in self.nodes:
                    nodes.insert(0, anchor)
                return self._fill_replicas(nodes, desired) or nodes

            self.update_placement(coll, new_sid, place)
        # Broadcast the folded tombstones: every node prunes its
        # delta-delete map once the retention horizon passes the swap.
        self._publish(
            {
                "msg": "tombstones_folded",
                "collection": coll,
                "folded_pks": p["folded_pks"],
                "compact_ts": p["compact_ts"],
            }
        )
        if self.events is not None:
            self.events.emit(
                "segment_hot_swap", "query_coord",
                collection=coll, sources=sources,
                targets=[t["segment_id"] for t in p["segments"]],
                compact_ts=p["compact_ts"],
            )
        for sid in sources:
            skey = (coll, sid)
            owners = self.replica_sets.pop(skey, [])
            self.retired_windows[skey] = {
                "visible_from_ts": self._visible_from.pop(skey, 0),
                "retired_at_ts": p["compact_ts"],
                "partition": p.get("partition", DEFAULT_PARTITION),
                "indexes": list(self._known_indexes.pop(skey, {}).values()),
                "nodes": {o for o in owners if o in self.nodes},
            }
            for owner in owners:
                if owner in self.nodes:
                    self.nodes[owner].segments.discard(skey)
                    self._publish(
                        {
                            "msg": "retire_segment",
                            "node_id": owner,
                            "collection": coll,
                            "segment_id": sid,
                            "retired_at_ts": p["compact_ts"],
                        }
                    )
            self.meta.delete(f"assignment/{coll}/{sid}")
        return True

    def _assign_segment(self, collection: str, segment_id: int) -> bool:
        """Least-loaded placement of a fresh sealed segment's replica group."""
        key = (collection, segment_id)
        if key in self.replica_sets:
            return False
        desired = self.replication_for(collection)

        def place(cur: list[str]) -> "list[str] | None":
            return self._fill_replicas(cur, desired) or None

        return bool(self.update_placement(collection, segment_id, place))

    def _load_index_payload(self, node: str, built: dict) -> dict:
        return {
            "msg": "load_index",
            "node_id": node,
            "collection": built["collection"],
            "segment_id": built["segment_id"],
            "field": built.get("field", "vector"),
            "column": built.get("column", built.get("field", "vector")),
            "index_kind": built["index_kind"],
            "index_key": built["index_key"],
        }

    # -------------------------------------------------------------- recovery
    def recover_state(self) -> dict:
        """Adopt committed placement inputs from the meta store after a full
        restart: MVCC visibility pins (``segment/*.visible_from_ts``) and
        finished index builds (``index/``).  The coordination-log history is
        fast-forwarded — its committed effects live in the meta store — and
        the reconciler then re-places every sealed segment onto whatever
        nodes are registered now."""
        with self._mutex:
            pins = indexes = 0
            for key, rec in self.meta.scan("segment/").items():
                _, coll, sid_s = key.split("/")
                vts = int(rec.get("visible_from_ts", 0) or 0)
                if vts:
                    self._visible_from[(coll, int(sid_s))] = vts
                    pins += 1
            for key, rec in self.meta.scan("index/").items():
                _, coll, sid_s, field = key.split("/")
                skey = (coll, int(sid_s))
                self._known_indexes.setdefault(skey, {})[field] = {
                    "msg": "index_built",
                    "collection": coll,
                    "segment_id": int(sid_s),
                    "field": field,
                    "column": rec.get("column", field),
                    "index_kind": rec["kind"],
                    "index_key": rec["key"],
                }
                indexes += 1
            self.sub.seek(self.broker.end_position(COORD_CHANNEL))
            return {"visible_pins": pins, "indexes": indexes}

    def recover_retired(self, store) -> int:
        """Reload retired-but-not-GC'd segments so reads pinned before their
        hot-swap keep answering after a restart.  Each is loaded onto a live
        node and immediately re-retired, restoring the bounded MVCC window
        ``[visible_from_ts, retired_at_ts)`` the handle had before the crash."""
        with self._mutex:
            count = 0
            for key, rec in self.meta.scan("retired_segment/").items():
                _, coll, sid_s = key.split("/")
                sid = int(sid_s)
                if self.meta.get(f"collection/{coll}") is None:
                    continue
                if not store.exists(f"binlog/{coll}/{sid}/meta"):
                    continue  # GC already reclaimed it
                seg = self.meta.get(f"segment/{coll}/{sid}") or {}
                part = seg.get("partition", DEFAULT_PARTITION)
                if self.meta.get(f"partition/{coll}/{part}") is None:
                    continue  # dropped partitions stay dropped
                node = self._least_loaded()
                if node is None:
                    break
                window = {
                    "visible_from_ts": int(seg.get("visible_from_ts", 0)),
                    "retired_at_ts": int(rec.get("retired_at_ts", 0)),
                    "partition": part,
                    "indexes": list(self._known_indexes.get((coll, sid), {}).values()),
                    "nodes": set(),
                }
                self.retired_windows[(coll, sid)] = window
                self._serve_window((coll, sid), window, node)
                count += 1
            return count

    def _serve_window(self, key: tuple[str, int], window: dict, node: str) -> None:
        """Load a retired segment version onto ``node`` and retire it there
        at once: the handle serves exactly its MVCC window."""
        coll, sid = key
        self._publish(
            {
                "msg": "load_segment",
                "node_id": node,
                "collection": coll,
                "segment_id": sid,
                "visible_from_ts": window["visible_from_ts"],
            }
        )
        for idx in window["indexes"]:
            self._publish(self._load_index_payload(node, idx))
        self._publish(
            {
                "msg": "retire_segment",
                "node_id": node,
                "collection": coll,
                "segment_id": sid,
                "retired_at_ts": window["retired_at_ts"],
            }
        )
        window["nodes"].add(node)

    def place_retired_windows(self) -> int:
        """Serve every retired window whose holders all died on the least
        loaded live node (reads pinned before a swap keep their rows
        through a failover).  Returns the windows placed."""
        with self._mutex:
            placed = 0
            for key, window in sorted(self.retired_windows.items()):
                if window["nodes"]:
                    continue
                node = self._least_loaded()
                if node is None:
                    break
                self._serve_window(key, window, node)
                placed += 1
            return placed

    def _drop_windows(self, p: dict) -> None:
        """Forget the retired windows a retention advance, a GC or a
        partition drop ended (the query nodes drop the handles)."""
        msg, coll = p["msg"], p.get("collection")
        for (c, sid), window in list(self.retired_windows.items()):
            if coll is not None and c != coll:
                continue
            if (
                (msg == "retention_advance" and window["retired_at_ts"] <= p["horizon_ts"])
                or (msg == "segment_gc" and sid == p["segment_id"])
                or (msg == "partition_dropped" and window["partition"] == p["partition"])
            ):
                del self.retired_windows[(c, sid)]

    # ------------------------------------------------------ channel coverage
    def assign_channels(self, collection: str, num_shards: int) -> None:
        """Distribute DML channel subscriptions over live nodes (draining
        nodes shed channel ownership so scale-down leaves them idle).

        With replication factor > 1, the next rf-1 candidates consume each
        channel as standby *followers* (``channel_followers``): same WAL
        replay, no ownership.  Their consumed watermarks give the proxy
        routing choices for bounded-staleness reads and a warm takeover
        target on failover.  Idempotent — the reconciler re-runs this
        every pass, so only membership diffs publish messages."""
        nodes = self._placement_candidates() or self.live_nodes()
        if not nodes:
            return
        all_nodes = self.live_nodes()
        for shard in range(num_shards):
            ch = dml_channel(collection, shard)
            owner = nodes[shard % len(nodes)]
            for n in all_nodes:
                st = self.nodes[n]
                if n == owner and ch not in st.channels:
                    st.channels.add(ch)
                    self._publish(
                        {
                            "msg": "subscribe_channel",
                            "node_id": n,
                            "channel": ch,
                            "from_position": self.data_coord.replay_position(collection, shard),
                        }
                    )
                elif n != owner and ch in st.channels:
                    st.channels.discard(ch)
                    self._publish(
                        {"msg": "unsubscribe_channel", "node_id": n, "channel": ch}
                    )
            # ---- standby followers (rf - 1 of the remaining candidates)
            desired = self.replication_for(collection) - 1
            cands = [n for n in nodes if n != owner]
            want = set(cands[:desired]) if desired > 0 else set()
            have = self.channel_followers.setdefault(ch, set())
            have.discard(owner)  # promoted by a re-home: owner, not follower
            for n in sorted(want - have):
                have.add(n)
                # The node-side subscribe is idempotent (an existing
                # subscription keeps its position), so an owner->follower
                # transition re-publishing here is harmless.
                self._publish(
                    {
                        "msg": "subscribe_channel",
                        "node_id": n,
                        "channel": ch,
                        "from_position": self.data_coord.replay_position(collection, shard),
                    }
                )
            for n in sorted(have - want):
                have.discard(n)
                if n in self.nodes and ch not in self.nodes[n].channels:
                    self._publish(
                        {"msg": "unsubscribe_channel", "node_id": n, "channel": ch}
                    )

    # -------------------------------------------------------------- failover
    def handle_failures(self) -> list[str]:
        """Detect dead nodes (lease expiry) and reassign their replicas to
        under-replicated survivors, one CAS-committed record at a time."""
        with self._mutex:
            self.meta.expire_now()
            live = set(self.live_nodes())
            dead = [n for n in self.nodes if n not in live]
            for node_id in dead:
                st = self.nodes.pop(node_id)
                for fs in self.channel_followers.values():
                    fs.discard(node_id)
                for window in self.retired_windows.values():
                    window["nodes"].discard(node_id)
                if self.events is not None:
                    self.events.emit(
                        "node_dead", "query_coord",
                        node=node_id, replicas=len(st.segments),
                        channels=sorted(st.channels),
                    )
                for key in sorted(st.segments):
                    coll, sid = key
                    desired = self.replication_for(coll)

                    def heal(cur: list[str], dead_id: str = node_id,
                             desired: int = desired) -> "list[str] | None":
                        survivors = [n for n in cur if n != dead_id]
                        return self._fill_replicas(survivors, desired)

                    # The dead node is already out of self.nodes, so the
                    # committed diff only loads onto survivors.
                    if key in self.replica_sets:
                        self.replica_sets[key] = [
                            n for n in self.replica_sets[key] if n != node_id
                        ]
                    self.update_placement(coll, sid, heal)
                # re-home channels: a live standby follower is the warm
                # takeover target (its subscription — kept by the
                # idempotent node-side subscribe — already consumed the
                # channel, so no replay gap); else least-loaded cold start.
                live_now = set(self.live_nodes())
                for ch in sorted(st.channels):
                    parts = ch.split("/")
                    coll, shard = parts[1], int(parts[2])
                    warm = sorted(
                        self.channel_followers.get(ch, ()) & live_now
                    )
                    target = warm[0] if warm else self._least_loaded()
                    if target:
                        self.channel_followers.get(ch, set()).discard(target)
                        self.nodes[target].channels.add(ch)
                        self._publish(
                            {
                                "msg": "subscribe_channel",
                                "node_id": target,
                                "channel": ch,
                                "from_position": self.data_coord.replay_position(coll, shard),
                            }
                        )
            self.place_retired_windows()
            return dead

    # -------------------------------------------------------------- balance
    def rebalance(self) -> int:
        """Move replicas from the most- to least-loaded node (paper §3.6),
        never co-locating two replicas of one segment on the same node."""
        with self._mutex:
            moved = 0
            while True:
                nodes = self._placement_candidates()
                if len(nodes) < 2:
                    return moved
                counts = {n: len(self.nodes[n].segments) for n in nodes}
                hi = max(nodes, key=lambda n: (counts[n], n))
                lo = min(nodes, key=lambda n: (counts[n], n))
                if counts[hi] - counts[lo] <= 1:
                    return moved
                key = next(
                    (
                        k
                        for k in sorted(self.nodes[hi].segments)
                        if lo not in self.replica_sets.get(k, ())
                    ),
                    None,
                )
                if key is None:
                    return moved
                coll, sid = key

                def move(cur: list[str], hi: str = hi, lo: str = lo) -> "list[str] | None":
                    if hi not in cur or lo in cur:
                        return None  # placement changed under us: abort
                    return [lo if n == hi else n for n in cur]

                self.update_placement(coll, sid, move)
                if lo not in self.replica_sets.get(key, ()):
                    return moved  # aborted: stop rather than spin
                moved += 1

    def nodes_for_collection(self, collection: str) -> list[str]:
        """All nodes holding segments or channels of the collection."""
        out = set()
        for (coll, _sid), nodes in self.replica_sets.items():
            if coll == collection:
                out.update(nodes)
        for n, st in self.nodes.items():
            if any(ch.startswith(f"dml/{collection}/") for ch in st.channels):
                out.add(n)
        return sorted(out & set(self.live_nodes()))


# ---------------------------------------------------------------------------
# Health + reconciliation control loop
# ---------------------------------------------------------------------------


class HealthMonitor:
    """Missed-heartbeat detector.  Observation only — it never mutates
    placement; the ``StateReconciler`` acts on what it reports (the
    observe/act split of the single-writer control-loop idiom)."""

    def __init__(self, coord: QueryCoordinator):
        self.coord = coord
        self._last: dict[str, str] = {}

    def observe(self) -> dict[str, str]:
        """Status per registered node: ``healthy`` / ``suspect`` (more than
        half a TTL since the last heartbeat) / ``dead`` (lease expired) /
        ``draining`` (graceful scale-down in progress)."""
        c = self.coord
        c.meta.expire_now()
        now = c.clock.now_ms()
        alive = set(c.live_nodes())
        out: dict[str, str] = {}
        for node_id, st in c.nodes.items():
            if node_id not in alive:
                out[node_id] = "dead"
            elif st.draining:
                out[node_id] = "draining"
            elif now - st.last_beat_ms > c.heartbeat_ttl_ms / 2:
                out[node_id] = "suspect"
            else:
                out[node_id] = "healthy"
        if c.events is not None:
            for node_id, status in out.items():
                if self._last.get(node_id, "healthy") != status:
                    c.events.emit(
                        "node_status_change", "health_monitor",
                        node=node_id, status=status,
                        was=self._last.get(node_id, "healthy"),
                    )
        self._last = dict(out)
        return out


class StateReconciler:
    """Converges desired placement with observed cluster state.  One pass:

    1. **failures** — expired leases: every replica the dead node held is
       CAS-reassigned to under-replicated survivors,
    2. **heal** — any sealed segment below its collection's replication
       factor (node join, prior total outage) gains replicas on the
       least-loaded candidates,
    3. **drain** — draining nodes shed replicas load-before-release (a
       replica leaves the draining node only once a replacement exists),
    4. **channels** — DML channel ownership re-converges over candidates,
    5. **rebalance** — replica counts converge toward even load.

    MVCC epoch pins ride along automatically: ``update_placement`` stamps
    every committed record with the segment's ``visible_from_ts``.
    """

    def __init__(self, coord: QueryCoordinator):
        self.coord = coord

    def reconcile(self) -> dict:
        c = self.coord
        with c._mutex:
            report = {
                "statuses": c.health.observe(),
                "dead": c.handle_failures(),
            }
            report["healed"] = self.heal()
            report["drained"] = self.drain()
            for key, info in c.meta.scan("collection/").items():
                c.assign_channels(key.split("/", 1)[1], info["num_shards"])
            report["moved"] = c.rebalance()
            if c.events is not None and (
                report["dead"] or report["healed"] or report["drained"]
                or report["moved"]
            ):
                c.events.emit(
                    "reconcile", "reconciler",
                    dead=list(report["dead"]), healed=report["healed"],
                    drained=report["drained"], moved=report["moved"],
                )
            return report

    def heal(self) -> int:
        """Top every under-replicated sealed segment back up to its desired
        replica count; returns the number of replicas added."""
        c = self.coord
        healed = 0
        for key in c.meta.scan("collection/"):
            coll = key.split("/", 1)[1]
            desired = c.replication_for(coll)
            capacity = len(c._placement_candidates())
            for sid in c.data_coord.sealed_segments(coll):
                skey = (coll, sid)
                cur = c.replica_sets.get(skey, [])
                have = [
                    n for n in cur if n in c.nodes and not c.nodes[n].draining
                ]
                if len(have) >= min(desired, capacity):
                    continue

                def grow(nodes_in: list[str], desired: int = desired) -> "list[str] | None":
                    grown = self.coord._fill_replicas(list(nodes_in), desired)
                    return grown if grown != nodes_in else None

                before = len(cur)
                new = c.update_placement(coll, sid, grow)
                healed += max(0, len(new) - before)
        return healed

    def drain(self) -> int:
        """Shed replicas off draining nodes; a replica is only released once
        a replacement node carries it (or another replica already does), so
        pinned MVCC reads keep a serving copy throughout."""
        c = self.coord
        shed = 0
        for node_id, st in list(c.nodes.items()):
            if not st.draining:
                continue
            for key in sorted(st.segments):
                coll, sid = key

                def shed_one(cur: list[str], node_id: str = node_id) -> "list[str] | None":
                    if node_id not in cur:
                        return None
                    rest = [n for n in cur if n != node_id]
                    repl = c._least_loaded(exclude=set(cur))
                    if repl is not None:
                        rest.append(repl)
                    # Keep the last copy on the draining node until some
                    # other node can take it: no serving gap, ever.
                    return rest if rest else None

                new = c.update_placement(coll, sid, shed_one)
                if node_id not in new:
                    shed += 1
                    if c.events is not None:
                        c.events.emit(
                            "drain_step", "reconciler",
                            node=node_id, collection=coll, segment_id=sid,
                            moved_to=[n for n in new if n not in (node_id,)],
                        )
        return shed
