"""Data nodes: WAL -> binlog archivers (paper §3.3); mirrors
``repro.core.data_node``.

A data node subscribes to a set of DML channels, accumulates rows into the
authoritative growing segments, and when the data coordinator marks a
segment for sealing (size or idle-time policy), serializes it to columnar
binlog objects and announces ``segment_sealed`` on the coordination
channel.  Data nodes are stateless in the recovery sense: everything they
hold is reconstructible by replaying the WAL from the last sealed
checkpoint positions.  Each ``segment_sealed`` names that position,
``replay_from``: the first insert of any segment of the shard still growing
here, else the entry after the sealed segment's last insert.  (The
reference derives it from ``checkpoint_pos + 1``, which skips one entry.)

A data node computes nothing on the rows: it buffers them and serializes
them into ``.npy`` binlog bytes.  So its growing segments live on the host
(``device="cpu"``), whatever devices the query and index nodes use; staging
them on a card would only copy every row there and back.
"""

from __future__ import annotations

import threading

from .log import COORD_CHANNEL, EntryType, LogBroker, LogEntry, Subscription
from .binlog import write_attr_satellites, write_segment_binlog
from .object_store import ObjectStore
from .segment import DEFAULT_PARTITION, Segment
from .telemetry import MetricsRegistry
from .timestamp import TSO

#: Where data-node buffer segments live (see the module docstring).
BUFFER_DEVICE = "cpu"


class DataNode:
    def __init__(
        self,
        node_id: str,
        broker: LogBroker,
        store: ObjectStore,
        tso: TSO,
        data_coord,
        metrics: MetricsRegistry | None = None,
        wal_lock: "threading.Lock | None" = None,
    ):
        self.node_id = node_id
        self.broker = broker
        self.store = store
        self.tso = tso
        self.data_coord = data_coord
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.subscriptions: dict[str, Subscription] = {}
        # (collection, segment_id) -> growing Segment
        self.growing: dict[tuple[str, int], Segment] = {}
        # LSN-keyed dedup: highest applied position per channel.  The broker
        # is at-least-once (duplicate delivery is an injectable fault), so
        # every subscriber must treat re-delivered entries as no-ops.
        self._applied_pos: dict[str, int] = {}
        # (collection, segment_id) -> already archived to binlog?  Replaying
        # the WAL from position 0 after a crash must skip insert halves whose
        # segment is durable in the base log (binlog); delete halves always
        # apply (they tombstone the *growing* segments being rebuilt).
        self._archived: dict[tuple[str, int], bool] = {}
        # (collection, segment_id) -> WAL position of the growing segment's
        # first insert: where a replay must start to rebuild it.
        self._first_pos: dict[tuple[str, int], int] = {}
        self.alive = True
        # The loggers' WAL append lock (a system shares one): a logger
        # assigns rows to a segment and publishes them under it, so seal
        # marks read under it name only segments whose rows are all in the
        # log, and the poll after the read takes them all.  In threaded
        # mode a mark may come from the caller's thread while this node
        # steps on the pump thread.
        self._wal_lock = wal_lock if wal_lock is not None else threading.Lock()

    def subscribe(self, channel: str, from_position: int = 0) -> None:
        self.subscriptions[channel] = Subscription(self.broker, channel, from_position)

    def unsubscribe(self, channel: str) -> None:
        self.subscriptions.pop(channel, None)

    # ----------------------------------------------------------------- step
    def step(self) -> bool:
        if not self.alive:
            return False
        progress = False
        with self._wal_lock:
            marked = self.data_coord.marked_to_seal()
        for sub in list(self.subscriptions.values()):
            watermark = self._applied_pos.get(sub.channel, -1)
            for entry in sub.poll():
                if entry.position <= watermark:
                    self.metrics.inc("log_dedup_skipped_total",
                                     labels={"node": self.node_id})
                    continue
                progress |= self._consume(entry, entry.position + 1)
                watermark = entry.position
            self._applied_pos[sub.channel] = watermark
        progress |= self._flush_sealed(marked)
        return progress

    def _is_archived(self, coll: str, sid: int) -> bool:
        key = (coll, sid)
        hit = self._archived.get(key)
        if hit is None:
            hit = self.store.exists(f"binlog/{coll}/{sid}/meta") or (
                self.data_coord.segment_recorded(coll, sid)  # reclaimed by GC
            )
            self._archived[key] = hit
        return hit

    def _consume(self, entry: LogEntry, position: int) -> bool:
        import numpy as np

        if entry.type in (EntryType.INSERT, EntryType.UPSERT):
            p = entry.payload
            if entry.type is EntryType.UPSERT:
                # Delete half of the atomic upsert record: tombstone older
                # versions of these pks (rows with ts < entry.ts) wherever
                # they live; the insert half below lands at the same LSN.
                for (coll, _sid), seg in self.growing.items():
                    if coll == p["collection"]:
                        seg.delete(p["pk"], entry.ts)
            key = (p["collection"], p["segment_id"])
            if key not in self.growing and self._is_archived(*key):
                # Crash-recovery replay: this insert is already durable in
                # the sealed binlog; rebuilding it as growing rows would
                # double-count.  (The delete half above still applied.)
                return entry.type is EntryType.UPSERT
            seg = self.growing.get(key)
            if seg is None:
                dim = p["vector"].shape[1]
                extra_fields = tuple(sorted(p.get("extras", {})))
                seg = Segment(
                    p["segment_id"], p["collection"], p["shard"], dim,
                    extra_fields=extra_fields,
                    partition=p.get("partition", DEFAULT_PARTITION),
                    device=BUFFER_DEVICE,
                )
                self.growing[key] = seg
                self._first_pos[key] = entry.position
            n = len(p["pk"])
            seg.append(
                p["pk"], p["vector"], np.full(n, entry.ts, np.int64), p.get("extras")
            )
            seg.checkpoint_pos = position
            return True
        if entry.type is EntryType.DELETE:
            p = entry.payload
            for (coll, _sid), seg in self.growing.items():
                if coll == p["collection"]:
                    seg.delete(p["pk"], entry.ts)
            return True
        return False

    def _flush_sealed(self, marked: frozenset) -> bool:
        """Seal + flush the growing segments among ``marked``, the segments
        the data coordinator had marked before this step's poll."""
        import time as _t

        progress = False
        for key in list(self.growing):
            coll, sid = key
            if key not in marked:
                continue
            seg = self.growing.pop(key)
            self._first_pos.pop(key, None)
            # The channel's replay point after this seal: the first insert
            # of any segment of the shard still growing here, else the
            # entry after this segment's last insert.
            replay_from = min(
                [pos for (c, gsid), pos in self._first_pos.items()
                 if c == coll and self.growing[(c, gsid)].shard == seg.shard]
                + [seg.checkpoint_pos]
            )
            t0 = _t.perf_counter()
            seg.seal()
            keys = write_segment_binlog(self.store, seg)
            # Attribute-index satellites ride behind the binlog meta (the
            # flush-complete proof): a crash in this window leaves a sealed
            # binlog without satellites, which reconcile_sealed rebuilds.
            attr_keys = write_attr_satellites(self.store, seg)
            self.metrics.inc("data_node_attr_indexes_built_total", len(attr_keys))
            self.metrics.observe(
                "data_node_seal_flush_us", (_t.perf_counter() - t0) * 1e6
            )
            self.metrics.inc("data_node_segments_sealed_total")
            self.metrics.inc("data_node_rows_flushed_total", seg.num_rows)
            ts = self.tso.next()
            self.broker.publish(
                COORD_CHANNEL,
                LogEntry(
                    ts=ts,
                    type=EntryType.COORD,
                    payload={
                        "msg": "segment_sealed",
                        "collection": coll,
                        "segment_id": sid,
                        "shard": seg.shard,
                        "partition": seg.partition,
                        "num_rows": seg.num_rows,
                        "binlog_keys": keys,
                        "attr_keys": attr_keys,
                        "checkpoint_pos": seg.checkpoint_pos,
                        "replay_from": replay_from,
                        "min_ts": seg.min_ts(),
                        "max_ts": seg.max_ts(),
                    },
                ),
            )
            self.data_coord.on_sealed(
                coll, sid, seg.num_rows, seg.partition, shard=seg.shard,
                attr_fields=sorted(attr_keys),
            )
            progress = True
        return progress

    def drop_partition(self, collection: str, partition: str) -> int:
        """Discard growing segments of a dropped partition (their rows
        must not seal into binlogs after the drop)."""
        doomed = [
            key
            for key, seg in self.growing.items()
            if key[0] == collection and seg.partition == partition
        ]
        for key in doomed:
            del self.growing[key]
            self._first_pos.pop(key, None)
        return len(doomed)
