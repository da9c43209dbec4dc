"""Compaction & garbage collection as log subscribers (mirrors
``repro.core.compaction``).

* The **compaction coordinator** watches the coord channel for sealed
  segments and the DML channels for delete tombstones, applies the policy
  (delete-ratio threshold, small-segment merging up to the seal size) and
  publishes ``compaction_task`` messages.  It owns the segment-map epoch and
  broadcasts the retention horizon.
* Stateless **compaction nodes** claim tasks with a meta-store CAS, read the
  sources' binlog columns, drop the rows the task's tombstones kill, write
  the repacked binlog back and announce ``segment_compacted``.
* The **GC reaper** deletes the binlog / index / attr objects of segments
  retired before the horizon, unless a time-travel checkpoint references
  them, and announces ``segment_gc``.

All of it is host work, as in the reference: the rewrite reads and writes
binlog bytes and never touches a device, so its columns are host arrays and
its masks run through ``ops`` on CPU tensors.  The rewritten segments reach
the card when the index node rebuilds them and the query nodes load them.

MVCC through the swap: the query coordinator loads the rewrite gated at
``compact_ts`` and retires the sources at the same timestamp, so a query
pinned before the swap keeps reading the old versions until
``retention_advance`` moves the horizon past it.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..kernels import ops
from .binlog import (
    read_binlog_column,
    read_binlog_meta,
    write_attr_satellites,
    write_segment_binlog,
)
from .log import COORD_CHANNEL, EntryType, LogBroker, LogEntry, Subscription
from .meta_store import MetaStore, SegmentMap
from .object_store import ObjectStore
from .segment import DEFAULT_PARTITION, Segment, add_tombstone, flatten_tombstones
from .telemetry import EventLog, MetricsRegistry
from .timestamp import TSO

DEFAULT_DELETE_RATIO = 0.2
DEFAULT_SMALL_FRACTION = 0.5
MAX_TASK_SEAL_FACTOR = 4  # one task rewrites at most this many seals of rows
#: Where the rewrite's segments live: compaction is host work.
REWRITE_DEVICE = "cpu"
_NO_DELETE = np.iinfo(np.int64).max


def _cpu(arr) -> torch.Tensor:
    """A host int64 array as a CPU tensor (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.int64)))


def _doomed(dd: dict, ts: int):
    """(sorted pks, effective delete ts) of a tombstone map at ``ts``, as
    CPU tensors, or None when no tombstone applies."""
    if not dd:
        return None
    pks, dts = flatten_tombstones(dd, REWRITE_DEVICE)
    return ops.eff_tombstones(pks, dts, ts)


def prune_folded(dd: dict, folded_pks, compact_ts: int) -> dict | None:
    """Drop tombstones folded into a compaction from a pk->delete-ts map
    (values may be a bare ts or a sorted ts list -- upsert histories).

    A tombstone dies iff its pk was rewritten out (``folded_pks``, sorted)
    AND its delete predates the swap (``dts <= compact_ts``); later deletes
    of the same pk and tombstones of other segments survive.  Returns the
    pruned dict, or None when nothing changed.  Shared by the query nodes'
    retention handler and the compaction coordinator, so the two tombstone
    views cannot drift apart."""
    folded = _cpu(folded_pks)
    if not dd or folded.numel() == 0:
        return None
    pks, dts = flatten_tombstones(dd, REWRITE_DEVICE)
    kill = ops.isin_sorted(pks, folded) & (dts <= compact_ts)
    if not bool(kill.any()):
        return None
    out: dict = {}
    for pk, t, dead in zip(pks.tolist(), dts.tolist(), kill.tolist()):
        if not dead:
            add_tombstone(out, pk, t)
    return out


# ---------------------------------------------------------------------------
# Coordinator: policy + task fan-out + epoch bookkeeping
# ---------------------------------------------------------------------------


class CompactionCoordinator:
    """Decides *what* to compact; the nodes decide *who* does it (CAS)."""

    def __init__(
        self,
        broker: LogBroker,
        meta: MetaStore,
        tso: TSO,
        data_coord,
        store: ObjectStore,
        delete_ratio: float = DEFAULT_DELETE_RATIO,
        small_fraction: float = DEFAULT_SMALL_FRACTION,
        retention_ms: float = 0.0,
        events: EventLog | None = None,
    ):
        self.broker = broker
        self.meta = meta
        self.tso = tso
        self.data_coord = data_coord
        self.store = store
        self.delete_ratio = delete_ratio
        self.small_fraction = small_fraction
        self.retention_ms = retention_ms
        self.events = events
        self.sub = Subscription(broker, COORD_CHANNEL)
        self._dml_subs: dict[str, Subscription] = {}
        # collection -> pk -> delete ts (ts list for repeated deletes), fed
        # by subscribing to every DML channel like any query node
        self.tombstones: dict[str, dict] = {}
        # (collection, segment_id) -> {"rows", "shard", "partition"}
        self.sealed: dict[tuple[str, int], dict] = {}
        # (collection, segment_id) -> (pk column, ts column) scoring cache
        self._seg_cols: dict[tuple[str, int], tuple[torch.Tensor, torch.Tensor]] = {}
        self.pending: dict[str, dict] = {}  # task_id -> task payload
        self._next_task = 1
        self.segment_map = SegmentMap(meta)
        self.compactions_completed = 0
        # LSN-keyed dedup: highest applied position per channel
        self._applied_pos: dict[str, int] = {}

    # ------------------------------------------------------------------ log
    def _refresh_dml_subs(self) -> None:
        for ch in self.broker.channels("dml/"):
            if ch not in self._dml_subs:
                self._dml_subs[ch] = Subscription(self.broker, ch)

    def step(self) -> bool:
        progress = False
        self._refresh_dml_subs()
        for sub in self._dml_subs.values():
            watermark = self._applied_pos.get(sub.channel, -1)
            for entry in sub.poll():
                if entry.position <= watermark:
                    continue  # duplicate delivery: already applied this LSN
                watermark = entry.position
                if entry.type in (EntryType.DELETE, EntryType.UPSERT):
                    # an upsert's delete half is a tombstone like any other
                    p = entry.payload
                    dd = self.tombstones.setdefault(p["collection"], {})
                    for pk in np.asarray(p["pk"]).tolist():
                        add_tombstone(dd, pk, entry.ts)
                    progress = True
            self._applied_pos[sub.channel] = watermark
        watermark = self._applied_pos.get(COORD_CHANNEL, -1)
        for entry in self.sub.poll():
            if entry.position <= watermark:
                continue
            watermark = entry.position
            if entry.type is not EntryType.COORD:
                continue
            p = entry.payload
            msg = p.get("msg")
            if msg == "segment_sealed":
                self.sealed[(p["collection"], p["segment_id"])] = {
                    "rows": p["num_rows"],
                    "shard": p["shard"],
                    "partition": p.get("partition", DEFAULT_PARTITION),
                }
                progress = True
            elif msg == "compaction_task":
                progress |= self._on_task_replayed(p)
            elif msg == "segment_compacted":
                progress |= self._on_compacted(p)
            elif msg == "partition_dropped":
                for sid in p.get("segment_ids", ()):
                    self.sealed.pop((p["collection"], sid), None)
                    self._seg_cols.pop((p["collection"], sid), None)
                progress = True
        self._applied_pos[COORD_CHANNEL] = watermark
        return progress

    # ------------------------------------------------------------- recovery
    def _claim_key(self, coll: str, task_id: str) -> str:
        return f"compaction_claim/{coll}/{task_id}"

    def _is_done(self, coll: str, task_id: str) -> bool:
        claim = self.meta.get(self._claim_key(coll, task_id))
        return bool(claim and claim.get("done"))

    def _on_task_replayed(self, p: dict) -> bool:
        """A ``compaction_task`` read back from the coord channel: a
        restarted coordinator rebuilds its in-flight task table from these
        entries (the log is the durable task queue); completed tasks (a
        done-marker on the claim) stay out of ``pending``.  The task-id
        sequence resumes past every replayed id."""
        task_id = p["task_id"]
        prefix, _, seq = task_id.rpartition("-")
        if prefix and seq.isdigit():
            self._next_task = max(self._next_task, int(seq) + 1)
        if task_id in self.pending or self._is_done(p["collection"], task_id):
            return False
        self.pending[task_id] = dict(p)
        return True

    def clear_stale_claims(self, owner: str | None = None) -> int:
        """Release not-done claims (optionally only ``owner``'s) so pending
        tasks wedged behind a crashed node's claim become takeable again."""
        cleared = 0
        for key, claim in list(self.meta.scan("compaction_claim/").items()):
            if claim.get("done"):
                continue
            if owner is not None and claim.get("owner") != owner:
                continue
            task_id = key.rsplit("/", 1)[1]
            if task_id in self.pending:
                self.meta.delete(key)
                cleared += 1
        return cleared

    def _on_compacted(self, p: dict) -> bool:
        task = self.pending.pop(p["task_id"], None)
        if task is None:
            if self._is_done(p["collection"], p["task_id"]):
                # Replay of a completed task: the durable writes already
                # happened; refresh the in-memory view only.
                self._apply_compacted_view(p)
            return False
        coll = p["collection"]
        targets = list(p["segments"])  # [{"segment_id", "num_rows"}, ...]
        sources = list(p["sources"])
        partition = p.get("partition", DEFAULT_PARTITION)
        for sid in sources:
            self.meta.put(
                f"retired_segment/{coll}/{sid}",
                {
                    "retired_at_ts": p["compact_ts"],
                    "compacted_into": [t["segment_id"] for t in targets],
                },
            )
        self._apply_compacted_view(p)
        self.segment_map.apply(
            coll,
            add=[t["segment_id"] for t in targets],
            remove=sources,
            ts=p["compact_ts"],
        )
        self.data_coord.on_compacted(
            coll, sources, targets, partition,
            shard=p.get("shard", 0), compact_ts=p["compact_ts"],
            attr_fields=p.get("attr_fields"),
        )
        # A done-marker instead of deleting the claim: a replay can tell
        # "completed" apart from "never ran".
        self.meta.put(
            self._claim_key(coll, p["task_id"]),
            {"owner": p.get("built_by"), "done": True},
        )
        self.compactions_completed += 1
        if self.events is not None:
            self.events.emit(
                "compaction_done", "compaction_coord",
                collection=coll, task_id=p["task_id"], sources=sources,
                targets=[t["segment_id"] for t in targets],
                rows_purged=p.get("rows_purged", 0),
            )
        return True

    def _apply_compacted_view(self, p: dict) -> None:
        """In-memory effects of a completed compaction (idempotent): swap
        sources for targets in the sealed table and prune the folded
        tombstones from the coordinator's view."""
        coll = p["collection"]
        partition = p.get("partition", DEFAULT_PARTITION)
        for sid in p["sources"]:
            self.sealed.pop((coll, sid), None)
            self._seg_cols.pop((coll, sid), None)
        for t in p["segments"]:
            self.sealed[(coll, t["segment_id"])] = {
                "rows": t["num_rows"],
                "shard": p["shard"],
                "partition": partition,
            }
        pruned = prune_folded(
            self.tombstones.get(coll) or {}, p["folded_pks"], p["compact_ts"]
        )
        if pruned is not None:
            self.tombstones[coll] = pruned

    def lag(self) -> int:
        """Unconsumed log entries across this coordinator's subscriptions."""
        return self.sub.lag() + sum(s.lag() for s in self._dml_subs.values())

    # --------------------------------------------------------------- policy
    def _cols_of(self, collection: str, segment_id: int) -> tuple[torch.Tensor, torch.Tensor]:
        key = (collection, segment_id)
        cols = self._seg_cols.get(key)
        if cols is None:
            cols = (
                _cpu(read_binlog_column(self.store, collection, segment_id, "pk")),
                _cpu(read_binlog_column(self.store, collection, segment_id, "ts")),
            )
            self._seg_cols[key] = cols
        return cols

    def plan(self, collection: str) -> list[dict]:
        """Evaluate the policy and publish the rewrite tasks.

        A segment is a candidate when >= ``delete_ratio`` of its rows are
        tombstoned (purge) or its live rows fall below ``small_fraction *
        seal_rows`` (fragment).  Candidates group per (shard, partition) and
        pack into tasks of at most ``MAX_TASK_SEAL_FACTOR`` seals of live
        rows, each repacked into seal-size targets.  A lone candidate with
        nothing to fold is left alone."""
        seal_rows = self.data_coord.seal_rows_for(collection)
        busy = {
            sid
            for t in self.pending.values()
            if t["collection"] == collection
            for sid in t["sources"]
        }
        doomed = _doomed(self.tombstones.get(collection), _NO_DELETE)
        # (shard, partition) -> [(segment_id, live, dead), ...]
        cands: dict[tuple[int, str], list[tuple[int, int, int]]] = {}
        for (coll, sid), info in sorted(self.sealed.items()):
            if coll != collection or sid in busy:
                continue
            rows = info["rows"]
            if rows == 0:
                continue
            n_dead = 0
            if doomed is not None:
                pk_col, ts_col = self._cols_of(coll, sid)
                n_dead = int(ops.tombstone_mask(pk_col, ts_col, doomed[0], doomed[1]).sum())
            if (
                n_dead / rows >= self.delete_ratio
                or rows - n_dead < self.small_fraction * seal_rows
            ):
                group_key = (info["shard"], info.get("partition", DEFAULT_PARTITION))
                cands.setdefault(group_key, []).append((sid, rows - n_dead, n_dead))

        tasks = []
        max_rows = MAX_TASK_SEAL_FACTOR * seal_rows
        for shard, partition in sorted(cands):
            group: list[tuple[int, int, int]] = []
            group_live = 0

            def emit_group():
                nonlocal group, group_live
                if group and (len(group) >= 2 or any(d for _s, _l, d in group)):
                    tasks.append(
                        self._publish_task(
                            collection, shard, partition,
                            [s for s, _l, _d in group], group_live, seal_rows,
                        )
                    )
                group, group_live = [], 0

            for cand in cands[(shard, partition)]:
                if group and group_live + cand[1] > max_rows:
                    emit_group()
                group.append(cand)
                group_live += cand[1]
            emit_group()
        # The pk/ts columns are only needed while scoring candidates.
        self._seg_cols.clear()
        return tasks

    def _publish_task(
        self,
        collection: str,
        shard: int,
        partition: str,
        sources: list[int],
        live_rows: int,
        seal_rows: int,
    ) -> dict:
        compact_ts = self.tso.next()
        doomed = _doomed(self.tombstones.get(collection), compact_ts)
        if doomed is None:
            doomed_pks, doomed_eff = np.empty(0, np.int64), np.empty(0, np.int64)
        else:
            doomed_pks, doomed_eff = doomed[0].numpy(), doomed[1].numpy()
        n_targets = max(1, -(-live_rows // seal_rows))  # ceil
        task_id = f"ct-{self._next_task}"
        self._next_task += 1
        payload = {
            "msg": "compaction_task",
            "task_id": task_id,
            "collection": collection,
            "shard": shard,
            "partition": partition,
            "sources": list(sources),
            "targets": [
                self.data_coord.allocate_segment_id() for _ in range(n_targets)
            ],
            "seal_rows": seal_rows,
            "compact_ts": compact_ts,
            "doomed_pks": doomed_pks,
            "doomed_eff": doomed_eff,
        }
        self.pending[task_id] = payload
        self.broker.publish(
            COORD_CHANNEL,
            LogEntry(ts=compact_ts, type=EntryType.COORD, payload=payload),
        )
        if self.events is not None:
            self.events.emit(
                "compaction_task", "compaction_coord",
                collection=collection, task_id=task_id, shard=shard,
                partition=partition, sources=list(sources),
                live_rows=live_rows,
            )
        return payload

    # ------------------------------------------------------------ retention
    def advance_horizon(self, horizon_ts: int, collection: str | None = None) -> None:
        """Broadcast a retention-horizon advance: query nodes release
        retired segment versions and prune folded tombstones; the GC reaper
        may reclaim objects retired before ``horizon_ts``.
        ``collection=None`` advances every collection's horizon."""
        payload = {"msg": "retention_advance", "horizon_ts": horizon_ts}
        if collection is not None:
            payload["collection"] = collection
        self.broker.publish(
            COORD_CHANNEL,
            LogEntry(ts=self.tso.next(), type=EntryType.COORD, payload=payload),
        )


# ---------------------------------------------------------------------------
# Worker: stateless rewrite executors
# ---------------------------------------------------------------------------


class CompactionNode:
    """Claims ``compaction_task``s via meta-store CAS and rewrites binlogs:
    one keep-mask per source (a binary-search probe of the sorted doomed
    pks) and one gather per column."""

    def __init__(
        self,
        node_id: str,
        broker: LogBroker,
        store: ObjectStore,
        meta: MetaStore,
        tso: TSO,
        metrics: MetricsRegistry | None = None,
    ):
        self.node_id = node_id
        self.broker = broker
        self.store = store
        self.meta = meta
        self.tso = tso
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.sub = Subscription(broker, COORD_CHANNEL)
        self.alive = True
        self.compactions_completed = 0
        self.rows_purged = 0
        self._applied_pos = -1  # LSN-keyed dedup over the coord channel
        self._retry: list[dict] = []  # tasks whose claim CAS lost spuriously

    def step(self) -> bool:
        if not self.alive:
            return False
        progress = False
        retries, self._retry = self._retry, []
        for task in retries:
            progress |= self._try_compact(task)
        for entry in self.sub.poll():
            if entry.position <= self._applied_pos:
                continue  # duplicate delivery: already saw this LSN
            self._applied_pos = entry.position
            if entry.type is not EntryType.COORD:
                continue
            p = entry.payload
            if p.get("msg") != "compaction_task":
                continue
            progress |= self._try_compact(p)
        return progress

    def _try_compact(self, task: dict) -> bool:
        coll = task["collection"]
        claim_key = f"compaction_claim/{coll}/{task['task_id']}"
        # CAS claim: only one compaction node executes a given task.
        if not self.meta.cas(claim_key, None, {"owner": self.node_id}):
            if self.meta.get(claim_key) is None:
                # Lost the CAS yet nobody holds the claim (a conflict storm):
                # requeue locally instead of wedging the task.
                self._retry.append(task)
            return False
        try:
            return self._rewrite(task)
        except Exception:
            # Release the claim so the task stays takeable, then re-raise.
            # (A simulated Crash is a BaseException: the claim leaks, as with
            # a real kill; the coordinator's clear_stale_claims handles it.)
            self.meta.delete(claim_key)
            raise

    def _rewrite(self, task: dict) -> bool:
        t0 = time.perf_counter()
        coll = task["collection"]
        sources = list(task["sources"])
        # Sorted pks + aligned effective delete ts: a row dies iff its pk is
        # doomed AND its row ts predates the effective delete.
        doomed_pks = _cpu(task["doomed_pks"])
        doomed_eff = _cpu(task.get("doomed_eff", np.full(len(doomed_pks), _NO_DELETE)))
        metas = [read_binlog_meta(self.store, coll, sid) for sid in sources]
        extra_fields = tuple(metas[0].get("extra_fields", ()))
        partition = task.get("partition", metas[0].get("partition", DEFAULT_PARTITION))
        cols: dict[str, list[np.ndarray]] = {f: [] for f in ("pk", "vector", "ts", *extra_fields)}
        folded: list[np.ndarray] = []
        rows_in = 0
        for sid, m in zip(sources, metas):
            if m["num_rows"] == 0:
                continue
            pks = read_binlog_column(self.store, coll, sid, "pk")
            ts_col = read_binlog_column(self.store, coll, sid, "ts")
            rows_in += len(pks)
            keep = (~ops.tombstone_mask(_cpu(pks), _cpu(ts_col), doomed_pks, doomed_eff)).numpy()
            if not keep.all():
                folded.append(pks[~keep])
            if not keep.any():
                continue
            cols["pk"].append(pks[keep])
            cols["ts"].append(ts_col[keep])
            for field in ("vector", *extra_fields):
                cols[field].append(read_binlog_column(self.store, coll, sid, field)[keep])

        merged = {f: (np.concatenate(chunks) if chunks else None) for f, chunks in cols.items()}
        n_live = len(merged["pk"]) if merged["pk"] is not None else 0
        checkpoint_pos = max(m["checkpoint_pos"] for m in metas)

        # Repack the live rows into seal-size targets; an empty chunk (every
        # row dead) produces no segment at all.
        targets = list(task["targets"])
        seal_rows = task["seal_rows"]
        out_segments = []
        attr_fields: list[str] = []
        for i, target in enumerate(targets):
            lo = i * seal_rows
            hi = (i + 1) * seal_rows if i < len(targets) - 1 else n_live
            if lo >= n_live or lo >= hi:
                continue
            seg = Segment(
                target, coll, metas[0]["shard"], metas[0]["dim"],
                extra_fields=extra_fields, partition=partition, device=REWRITE_DEVICE,
            )
            seg.append(
                merged["pk"][lo:hi],
                merged["vector"][lo:hi],
                merged["ts"][lo:hi],
                {f: merged[f][lo:hi] for f in extra_fields},
            )
            seg.checkpoint_pos = checkpoint_pos
            seg.seal()
            write_segment_binlog(self.store, seg)
            attr_fields = sorted(write_attr_satellites(self.store, seg))
            out_segments.append({"segment_id": target, "num_rows": seg.num_rows})

        folded_pks = np.unique(np.concatenate(folded)) if folded else np.empty(0, np.int64)
        self.compactions_completed += 1
        self.rows_purged += rows_in - n_live
        self.metrics.observe("compaction_rewrite_us", (time.perf_counter() - t0) * 1e6)
        self.metrics.inc("compactions_total")
        self.metrics.inc("compaction_rows_purged_total", rows_in - n_live)
        self.broker.publish(
            COORD_CHANNEL,
            LogEntry(
                ts=self.tso.next(),
                type=EntryType.COORD,
                payload={
                    "msg": "segment_compacted",
                    "task_id": task["task_id"],
                    "collection": coll,
                    "segments": out_segments,
                    "sources": sources,
                    "shard": metas[0]["shard"],
                    "partition": partition,
                    "num_rows": n_live,
                    "rows_purged": rows_in - n_live,
                    "compact_ts": task["compact_ts"],
                    # only the tombstones folded into THIS rewrite are
                    # prunable: a doomed pk of another segment keeps its entry
                    "folded_pks": folded_pks,
                    "attr_fields": attr_fields,
                    "built_by": self.node_id,
                },
            ),
        )
        return True


# ---------------------------------------------------------------------------
# GC reaper: object-store reclamation behind the retention horizon
# ---------------------------------------------------------------------------


class GCReaper:
    """Deletes binlog/index/attr objects of retired segments past the
    horizon.  Segments referenced by a time-travel checkpoint are never
    reclaimed, so ``restore`` keeps working (paper §4.3)."""

    def __init__(
        self,
        broker: LogBroker,
        store: ObjectStore,
        meta: MetaStore,
        tso: TSO,
        metrics: MetricsRegistry | None = None,
        events: EventLog | None = None,
    ):
        self.broker = broker
        self.store = store
        self.meta = meta
        self.tso = tso
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events = events
        self.segments_reclaimed = 0
        self.bytes_reclaimed = 0

    def protected_segments(self, collection: str) -> set[int]:
        protected: set[int] = set()
        for m in self.store.list(f"checkpoint/{collection}/"):
            d = json.loads(self.store.get(m.key).decode())
            protected.update(d.get("sealed_segment_ids", ()))
        return protected

    def reap(self, horizon_ts: int, collection: str | None = None) -> dict:
        report = {"segments": [], "objects": 0, "bytes": 0, "protected": 0}
        protected_of: dict[str, set[int]] = {}  # one checkpoint scan per coll
        for key, val in self.meta.scan("retired_segment/").items():
            _, coll, sid_s = key.rsplit("/", 2)
            sid = int(sid_s)
            if collection is not None and coll != collection:
                continue
            if val["retired_at_ts"] > horizon_ts:
                continue
            if coll not in protected_of:
                protected_of[coll] = self.protected_segments(coll)
            if sid in protected_of[coll]:
                report["protected"] += 1
                continue
            for prefix in (f"binlog/{coll}/{sid}/", f"index/{coll}/{sid}/", f"attr/{coll}/{sid}/"):
                for m in list(self.store.list(prefix)):
                    if self.store.delete(m.key):
                        report["objects"] += 1
                        report["bytes"] += m.size
            self.meta.delete(key)
            # A record of the reclamation, where the reference deletes the
            # segment's record: a restart's WAL replay must not archive the
            # reclaimed rows again (ROADMAP Queue 3).
            self.meta.put(f"segment/{coll}/{sid}", {"rows": 0, "state": "reclaimed"})
            for ak in list(self.meta.scan(f"attr_index/{coll}/{sid}/")):
                self.meta.delete(ak)
            self.broker.publish(
                COORD_CHANNEL,
                LogEntry(
                    ts=self.tso.next(),
                    type=EntryType.COORD,
                    payload={"msg": "segment_gc", "collection": coll, "segment_id": sid},
                ),
            )
            report["segments"].append((coll, sid))
        self.segments_reclaimed += len(report["segments"])
        self.bytes_reclaimed += report["bytes"]
        if report["segments"] or report["protected"]:
            self.metrics.inc("gc_segments_reclaimed_total", len(report["segments"]))
            self.metrics.inc("gc_bytes_reclaimed_total", report["bytes"])
            if self.events is not None:
                self.events.emit(
                    "gc_reap", "gc_reaper",
                    horizon_ts=horizon_ts,
                    segments=[sid for _c, sid in report["segments"]],
                    objects=report["objects"], bytes=report["bytes"],
                    protected=report["protected"],
                )
        return report
