"""Query nodes: the search workers (mirrors ``repro.core.query_node``).

A query node keeps growing segments fed from its WAL subscriptions, loads
sealed segments from the binlog and their indexes from the object store,
and answers node-level search requests under MVCC: a query pinned at
``ts`` sees exactly the rows with LSN <= ts that are not deleted as of ts.

Column data, masks and results are tensors on the node's device; the plan
and the tombstone maps are host Python.  One execution class of brute
units runs as one ``l2_topk`` launch, indexed units of one spec as one
``search_batched`` dispatch, the node-wise reduce as one ``merge_topk``
launch (more where the pool is wider than the kernel takes; see
``ops.merge_topk``).  Each full slice of a growing segment gets a temporary
IVF-FLAT index (built L2); the rows past the last full slice stay in the
brute tail.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..index.base import VectorIndex, normalize_if_cosine
from ..index.ivf import IVFFlatIndex
from ..kernels import ops
from .binlog import load_segment
from .collection import Metric
from .consistency import GuaranteeTs
from .log import EntryType, LogBroker, LogEntry, Subscription, shard_of_channel
from .object_store import ObjectStore
from .request import PRIMARY_VECTOR_COLUMN, AnnsQuery, NodeSearchRequest
from .segment import DEFAULT_PARTITION, Segment, TombstoneSet, add_tombstone
from .telemetry import MetricsRegistry

TEMP_INDEX_SLICE_ROWS = 2_048

# Selectivity-adaptive filtered-search thresholds (same as the reference).
FILTER_BRUTE_FRAC = 0.25
FILTER_BRUTE_MIN_ROWS = 64
FILTER_POST_FRAC = 0.5


def choose_filter_strategy(
    override: str | None, n_vis: int, n_comb: int, k: int, has_index: bool
) -> str:
    """The reference's rule, with one addition: post-filtering scans at
    k + (n_vis - n_comb), so where that is above the scan kernel's k limit
    the unit is pre-filtered instead (exact as well, the same answer)."""
    if override is not None:
        return override
    if n_comb <= max(2 * k, FILTER_BRUTE_MIN_ROWS) or n_comb <= FILTER_BRUTE_FRAC * n_vis:
        return "brute"
    if (
        has_index and n_comb >= FILTER_POST_FRAC * n_vis
        and k + (n_vis - n_comb) <= ops.MAX_SCAN_K
    ):
        return "post"
    return "pre"


class StalePlanError(Exception):
    """The dispatch plan references segments this node can no longer serve
    at the request timestamp; the proxy re-plans."""


def _seg_column(seg: Segment, column: str) -> torch.Tensor | None:
    """A segment's vector column on the device (None if absent)."""
    if column == PRIMARY_VECTOR_COLUMN or column in seg.extra_fields:
        return seg.vector_column(column)
    return None


def _scalar_columns(seg: Segment) -> dict[str, np.ndarray]:
    """Host copies of the filterable columns (pk + 1-D extras)."""
    cols: dict[str, np.ndarray] = {"pk": seg.pks().cpu().numpy()}
    for f in seg.extra_fields:
        arr = np.asarray(seg.extra(f))
        if arr.ndim == 1:
            cols[f] = arr
    return cols


@dataclass
class SealedHandle:
    segment: Segment
    index: VectorIndex | None = None
    index_kind: str | None = None
    visible_from_ts: int = 0
    retired_at_ts: int | None = None
    extra_indexes: dict[str, VectorIndex] = field(default_factory=dict)
    extra_index_kinds: dict[str, str] = field(default_factory=dict)
    attr_indexes: dict[str, object] = field(default_factory=dict)

    def covers_ts(self, ts: int) -> bool:
        if ts < self.visible_from_ts:
            return False
        return self.retired_at_ts is None or ts < self.retired_at_ts

    def index_for(self, column: str) -> VectorIndex | None:
        if column == PRIMARY_VECTOR_COLUMN:
            return self.index
        return self.extra_indexes.get(column)

    def set_index(self, column: str, index: VectorIndex, kind: str) -> None:
        if column == PRIMARY_VECTOR_COLUMN:
            self.index, self.index_kind = index, kind
        else:
            self.extra_indexes[column] = index
            self.extra_index_kinds[column] = kind


@dataclass
class ScanUnit:
    """One plannable piece of search work (device tensors): ``index`` set ->
    run through it, else brute-scan ``vectors``; ``pks`` maps local rows to
    primary keys; ``post_mask``/``k_extra`` carry the post-filter state."""

    segment_id: int
    pks: torch.Tensor
    mask: torch.Tensor
    index: VectorIndex | None = None
    vectors: torch.Tensor | None = None
    post_mask: torch.Tensor | None = None
    k_extra: int = 0


@dataclass
class SearchPlan:
    """Planner output: candidate units grouped by execution class."""

    indexed: list[ScanUnit] = field(default_factory=list)
    brute_sealed: list[ScanUnit] = field(default_factory=list)
    growing_slice: list[ScanUnit] = field(default_factory=list)  # temp slice index
    brute_tail: list[ScanUnit] = field(default_factory=list)
    post_indexed: list[ScanUnit] = field(default_factory=list)
    post_brute: list[ScanUnit] = field(default_factory=list)
    brute_filtered: list[ScanUnit] = field(default_factory=list)
    filter_info: list = field(default_factory=list)

    def units(self) -> "list[ScanUnit]":
        return (
            self.indexed + self.brute_sealed + self.growing_slice
            + self.brute_tail + self.post_indexed + self.post_brute
            + self.brute_filtered
        )


def _map_pks(idx: torch.Tensor, pks: torch.Tensor) -> torch.Tensor:
    """Local row indices -> primary keys; -1 slots pass through."""
    if pks.numel() == 0:
        return torch.full_like(idx, -1)
    return torch.where(idx >= 0, pks[idx.clamp(0, pks.numel() - 1)], -1)


class QueryNode:
    def __init__(
        self,
        node_id: str,
        broker: LogBroker,
        store: ObjectStore,
        tso=None,
        slice_rows: int = TEMP_INDEX_SLICE_ROWS,
        metrics: MetricsRegistry | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.node_id = node_id
        self.broker = broker
        self.store = store
        self.tso = tso
        self.slice_rows = slice_rows
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.subscriptions: dict[str, Subscription] = {}
        self.coord_sub = Subscription(broker, "coord") if broker.has_channel("coord") else None
        self._applied_pos: dict[str, int] = {}
        self.sealed: dict[tuple[str, int], SealedHandle] = {}
        self.growing: dict[tuple[str, int], Segment] = {}
        # coll -> pk -> delete ts (or a sorted ts list); see the reference.
        self.delta_deletes: dict[str, dict[object, object]] = {}
        # coll -> delta_deletes flattened with its effective sets cached;
        # rebuilt after the next delete.
        self._delta_sets: dict[str, TombstoneSet] = {}
        self.dropped_partitions: set[tuple[str, str]] = set()
        # tombstones_folded broadcasts awaiting the retention horizon
        self._pending_prunes: list[dict] = []
        self.alive = True
        self.search_count = 0
        self.searches_primary = 0
        self.searches_hedged = 0
        self.inflight = 0
        self.inflight_primary = 0
        # One dispatch or log step at a time: a hedged request's straggler
        # thread may still be scanning when the proxy's fallback dispatch
        # (or a consistency-wait pump) reaches this node; the node's caches
        # and counters are not built for two at once.
        self._serve_lock = threading.RLock()
        # Segments GC reclaimed (``segment_gc`` broadcasts): a replay of
        # their WAL inserts must not rebuild them as growing rows.
        self.reclaimed: set[tuple[str, int]] = set()
        # Commands on the coord channel up to this ts were addressed to an
        # earlier process under this node id (see _handle_coord).
        self.born_ts = tso.last_issued() if tso is not None else 0

    # --------------------------------------------------------- subscriptions
    def subscribe(self, channel: str, from_position: int = 0) -> None:
        if channel not in self.subscriptions:
            self.subscriptions[channel] = Subscription(self.broker, channel, from_position)
            self._applied_pos[channel] = from_position - 1

    def unsubscribe(self, channel: str) -> None:
        self.subscriptions.pop(channel, None)
        self._applied_pos.pop(channel, None)

    def watermark(self, collection: str) -> int:
        """Min last-time-tick over this node's channels for the collection."""
        marks = [
            sub.last_tick_seen
            for ch, sub in self.subscriptions.items()
            if ch.startswith(f"dml/{collection}/")
        ]
        return min(marks) if marks else 0

    # ----------------------------------------------------------------- step
    def step(self) -> bool:
        """Consume coord and DML entries (LSN-deduplicated: the broker is
        at-least-once) and return whether anything changed."""
        if not self.alive:
            return False
        with self._serve_lock:
            return self._step()

    def _step(self) -> bool:
        progress = False
        t0 = time.perf_counter()
        if self.coord_sub is not None:
            progress |= self._drain(self.coord_sub, self._handle_coord)
        # Listed after the coord drain: a subscribe_channel message there
        # is consumed in this same step.
        for sub in list(self.subscriptions.values()):
            progress |= self._drain(sub, self._consume)
        t1 = time.perf_counter()
        progress |= self._build_slice_indexes()
        t2 = time.perf_counter()
        # What a search waiting on the serve lock (its ``serve_wait`` span)
        # waits for: each phase of the step that holds the lock.
        self.metrics.observe("query_node_step_us", (t1 - t0) * 1e6, labels={"phase": "drain"})
        self.metrics.observe("query_node_step_us", (t2 - t1) * 1e6, labels={"phase": "slice_index"})
        return progress

    def _drain(self, sub: Subscription, apply) -> bool:
        progress = False
        watermark = self._applied_pos.get(sub.channel, -1)
        for entry in sub.poll():
            if entry.position <= watermark:
                self.metrics.inc("log_dedup_skipped_total", labels={"node": self.node_id})
                continue
            progress |= apply(entry)
            watermark = entry.position
        if sub is self.coord_sub or sub.channel in self.subscriptions:
            self._applied_pos[sub.channel] = watermark
        return progress

    def _handle_coord(self, entry: LogEntry) -> bool:
        if entry.type is not EntryType.COORD:
            return False
        p = entry.payload
        msg = p.get("msg")
        if msg == "segment_loaded":
            if p.get("node_id") != self.node_id:
                self.drop_growing(p["collection"], p["segment_id"])
            return True
        if msg == "tombstones":
            self._apply_delete(p["collection"], p["pk"], entry.ts)
            return True
        if msg == "tombstones_folded":
            # Broadcast: these tombstones' pks were folded away (a compaction
            # or a partition drop).  Every node prunes them from its
            # delta-delete map once the retention horizon passes compact_ts.
            self._pending_prunes.append(
                {
                    "collection": p["collection"],
                    "folded_pks": np.asarray(p["folded_pks"]),
                    "compact_ts": p["compact_ts"],
                }
            )
            return True
        if msg == "retention_advance":
            return self.apply_retention(p["horizon_ts"], p.get("collection"))
        if msg == "segment_gc":
            # Broadcast: the segment's objects are gone.  A node replaying
            # a channel from before its inserts must not rebuild its rows
            # as growing (their folded tombstones are pruned).
            key = (p["collection"], p["segment_id"])
            self.reclaimed.add(key)
            self.growing.pop(key, None)
            return True
        if msg == "partition_dropped":
            coll, part = p["collection"], p["partition"]
            self.dropped_partitions.add((coll, part))
            for sid in p.get("segment_ids", ()):
                self.sealed.pop((coll, sid), None)
                self.growing.pop((coll, sid), None)
            for key, seg in list(self.growing.items()):
                if key[0] == coll and seg.partition == part:
                    del self.growing[key]
            for key, handle in list(self.sealed.items()):
                if key[0] == coll and handle.segment.partition == part:
                    del self.sealed[key]
            return True
        if p.get("node_id") != self.node_id:
            return False
        if entry.ts <= self.born_ts:
            # A fresh process re-reads the coord channel from 0 for the
            # broadcasts (tombstones, folds, retention, drops); the commands
            # to the process it replaces are stale (loads of segments moved
            # or reclaimed since).  The coordinators re-issue what this one
            # must serve, retired windows included (the reference replays
            # them; ROADMAP Queue 3).
            return False
        if msg == "load_segment":
            self.load_sealed(
                p["collection"], p["segment_id"], visible_from_ts=p.get("visible_from_ts", 0)
            )
            if self.tso is not None:
                self.broker.publish(
                    "coord",
                    LogEntry(
                        ts=self.tso.next(),
                        type=EntryType.COORD,
                        payload={
                            "msg": "segment_loaded",
                            "node_id": self.node_id,
                            "collection": p["collection"],
                            "segment_id": p["segment_id"],
                        },
                    ),
                )
            return True
        if msg == "load_index":
            self.load_index(
                p["collection"], p["segment_id"], p["index_kind"], p["index_key"],
                column=p.get("column", PRIMARY_VECTOR_COLUMN),
            )
            return True
        if msg == "release_segment":
            self.release_segment(p["collection"], p["segment_id"])
            return True
        if msg == "retire_segment":
            self.retire_segment(p["collection"], p["segment_id"], p["retired_at_ts"])
            return True
        if msg == "subscribe_channel":
            self.subscribe(p["channel"], p.get("from_position", 0))
            return True
        if msg == "unsubscribe_channel":
            self.unsubscribe(p["channel"])
            return True
        return False

    def _apply_delete(self, collection: str, pks, ts: int) -> None:
        """Record tombstones for sealed rows and growing copies alike."""
        dd = self.delta_deletes.setdefault(collection, {})
        for pk in np.atleast_1d(np.asarray(pks)).tolist():
            add_tombstone(dd, pk, ts)
        self._delta_sets.pop(collection, None)
        for (c, _sid), seg in self.growing.items():
            if c == collection:
                seg.delete(pks, ts)

    def _consume(self, entry: LogEntry) -> bool:
        if entry.type in (EntryType.INSERT, EntryType.UPSERT):
            p = entry.payload
            if entry.type is EntryType.UPSERT:
                # delete half at the same LSN as the insert half below
                self._apply_delete(p["collection"], p["pk"], entry.ts)
            key = (p["collection"], p["segment_id"])
            partition = p.get("partition", DEFAULT_PARTITION)
            if (p["collection"], partition) in self.dropped_partitions or key in self.reclaimed:
                return True
            if key in self.sealed:
                return entry.type is EntryType.UPSERT
            seg = self.growing.get(key)
            if seg is None:
                seg = Segment(
                    p["segment_id"], p["collection"], p["shard"],
                    p["vector"].shape[1], slice_rows=self.slice_rows,
                    extra_fields=tuple(sorted(p.get("extras", {}))),
                    partition=partition, device=self.device,
                )
                self.growing[key] = seg
            n = len(p["pk"])
            seg.append(p["pk"], p["vector"], np.full(n, entry.ts, np.int64), p.get("extras"))
            return True
        if entry.type is EntryType.DELETE:
            p = entry.payload
            self._apply_delete(p["collection"], p["pk"], entry.ts)
            return True
        return False

    def _build_slice_indexes(self) -> bool:
        """Temporary IVF-FLAT per full slice of growing segments.

        Built L2 (the WAL carries no collection metric); the planner only
        uses a temp index whose metric matches the request and leaves
        mismatched slices to the brute tail, so IP/cosine growing reads
        stay exact."""
        progress = False
        for seg in self.growing.values():
            for s in seg.full_slices():
                if s in seg.slice_indexes:
                    continue
                lo, hi = seg.slice_bounds(s)
                idx = IVFFlatIndex(metric=Metric.L2, nlist=16, nprobe=4, device=self.device)
                idx.build(seg.vectors()[lo:hi])
                seg.slice_indexes[s] = idx
                progress = True
        return progress

    # ---------------------------------------------------------- assignments
    def load_sealed(self, collection: str, segment_id: int, visible_from_ts: int = 0) -> None:
        key = (collection, segment_id)
        if key in self.sealed:
            return
        seg = load_segment(self.store, collection, segment_id, device=self.device)
        self.sealed[key] = SealedHandle(
            seg, visible_from_ts=visible_from_ts, attr_indexes=self._attr_indexes_for(seg)
        )
        self.growing.pop(key, None)

    def _attr_indexes_for(self, seg: Segment) -> dict[str, object]:
        """Attribute indexes for a sealed segment's scalar columns: the
        stored satellites, or local builds where one is missing or stale."""
        from ..index.attribute import build_attribute_index
        from .binlog import load_attr_satellites

        columns = _scalar_columns(seg)
        loaded = load_attr_satellites(self.store, seg.collection, seg.segment_id, columns)
        out: dict[str, object] = {}
        for f, col in columns.items():
            idx = loaded.get(f)
            if idx is None or idx.n != seg.num_rows:
                idx = build_attribute_index(col)
                self.metrics.inc("query_node_attr_local_builds_total", labels={"node": self.node_id})
            out[f] = idx
        return out

    def load_index(
        self, collection: str, segment_id: int, kind: str, index_key: str,
        column: str = PRIMARY_VECTOR_COLUMN,
    ) -> None:
        handle = self.sealed.get((collection, segment_id))
        if handle is None:
            self.load_sealed(collection, segment_id)
            handle = self.sealed[(collection, segment_id)]
        index = VectorIndex.load(self.store.get(index_key), device=self.device)
        handle.set_index(column, index, kind)

    def release_segment(self, collection: str, segment_id: int) -> None:
        self.sealed.pop((collection, segment_id), None)
        self.growing.pop((collection, segment_id), None)

    def retire_segment(self, collection: str, segment_id: int, retired_at_ts: int) -> None:
        handle = self.sealed.get((collection, segment_id))
        if handle is not None and handle.retired_at_ts is None:
            handle.retired_at_ts = retired_at_ts
        self.growing.pop((collection, segment_id), None)

    def apply_retention(self, horizon_ts: int, collection: str | None = None) -> bool:
        """Drop retired segment versions (and with them their device
        columns and indexes) and prune the folded tombstones whose
        compaction fell behind the retention horizon (``collection=None``
        applies to every collection)."""
        from .compaction import prune_folded

        changed = False
        for key, handle in list(self.sealed.items()):
            if collection is not None and key[0] != collection:
                continue
            if handle.retired_at_ts is not None and handle.retired_at_ts <= horizon_ts:
                del self.sealed[key]
                changed = True
        still_pending: list[dict] = []
        for prune in self._pending_prunes:
            if (collection is not None and prune["collection"] != collection) or (
                prune["compact_ts"] > horizon_ts
            ):
                still_pending.append(prune)
                continue
            coll = prune["collection"]
            pruned = prune_folded(
                self.delta_deletes.get(coll) or {}, prune["folded_pks"], prune["compact_ts"]
            )
            if pruned is not None:
                self.delta_deletes[coll] = pruned
                self._delta_sets.pop(coll, None)
                changed = True
        self._pending_prunes = still_pending
        return changed

    def drop_growing(self, collection: str, segment_id: int) -> None:
        self.growing.pop((collection, segment_id), None)

    def held_segments(self, collection: str) -> list[int]:
        return sorted(sid for (c, sid) in self.sealed if c == collection)

    def memory_rows(self, collection: str | None = None) -> int:
        rows = sum(
            h.segment.num_rows
            for (c, _sid), h in self.sealed.items()
            if collection is None or c == collection
        )
        rows += sum(
            seg.num_rows
            for (c, _sid), seg in self.growing.items()
            if collection is None or c == collection
        )
        return rows

    def segment_rows(self, collection: str) -> "dict[tuple[str, int, bool], int]":
        """(collection, segment_id, is_sealed) -> row count, for the
        per-collection entity count (replicated segments dedup upstream)."""
        out: dict[tuple[str, int, bool], int] = {}
        for (c, sid), h in self.sealed.items():
            if c == collection and h.retired_at_ts is None:
                out[(c, sid, True)] = h.segment.num_rows
        for (c, sid), seg in self.growing.items():
            if c == collection:
                out[(c, sid, False)] = seg.num_rows
        return out

    # --------------------------------------------------------------- search
    def _request_doomed_pks(self, collection: str, ts: int):
        """The delta-delete set at ``ts`` as (sorted pks, effective delete
        ts) device tensors (or None), looked up once per request, and
        whether its cache held it ("hit"), built it ("miss", the one lookup
        that waits for the card) or found no tombstone at ``ts`` ("none")."""
        dd = self.delta_deletes.get(collection)
        if not dd:
            eff, outcome = None, "none"
        else:
            tombstones = self._delta_sets.get(collection)
            if tombstones is None:
                tombstones = self._delta_sets[collection] = TombstoneSet(dd, self.device)
            eff, outcome = tombstones.effective(ts)
        self.metrics.inc("query_node_tombstone_set_total", labels={"outcome": outcome})
        return eff, outcome

    _DOOMED_UNSET = object()

    def _visible(self, collection: str, seg: Segment, ts: int, doomed=_DOOMED_UNSET):
        if doomed is QueryNode._DOOMED_UNSET:
            doomed, _outcome = self._request_doomed_pks(collection, ts)
        mask = seg.visible_mask(ts)
        if doomed is not None:
            mask &= ~ops.tombstone_mask(seg.pks(), seg.timestamps(), doomed[0], doomed[1])
        return mask

    def _as_mask(self, m) -> torch.Tensor:
        return torch.as_tensor(np.asarray(m, bool) if not torch.is_tensor(m) else m).to(
            self.device, torch.bool
        )

    def plan_search(
        self,
        collection: str,
        ts: int,
        filter_masks=None,
        column: str = PRIMARY_VECTOR_COLUMN,
        metric: Metric | None = None,
        doomed=_DOOMED_UNSET,
        partitions: "tuple[str, ...] | None" = None,
        segments: "tuple[int, ...] | None" = None,
        shards: "tuple[int, ...] | None" = None,
        filter=None,
        filter_strategy: str | None = None,
        k: int = 10,
    ) -> SearchPlan:
        """Gather every candidate unit for a request pinned at ``ts`` and
        group it by execution class (see the reference for each knob).

        Without a filter nothing here waits for the card: a unit is left out
        only on what the host knows (no rows, every row written after
        ``ts``, a tail the slice indexes cover), and a unit whose mask is
        empty on the card is scanned and adds only empty slots.  Filtered
        units read their masks back: the filtered planner needs the counts."""
        plan = SearchPlan()
        if doomed is QueryNode._DOOMED_UNSET:
            doomed, _outcome = self._request_doomed_pks(collection, ts)
        prune = set(partitions) if partitions is not None else None
        scope = set(segments) if segments is not None else None
        unit_cols = metric is Metric.COSINE

        def brute_column(seg: Segment) -> torch.Tensor | None:
            raw = _seg_column(seg, column)
            if raw is None:
                return None
            return seg.unit_column(column) if unit_cols else raw

        def unit_mask(sid: int, seg: Segment) -> "tuple[torch.Tensor, bool]":
            """A unit's visibility mask at ``ts``, narrowed by its filter
            mask, and whether a filter applies to it."""
            mask = self._visible(collection, seg, ts, doomed)
            if filter_masks and sid in filter_masks:
                return mask & self._as_mask(filter_masks[sid]), True
            return mask, filter is not None

        served: set[int] = set()
        for (coll, sid), handle in self.sealed.items():
            if coll != collection:
                continue
            if scope is not None and sid in scope:
                if handle.retired_at_ts is None or handle.covers_ts(ts):
                    served.add(sid)
            if not handle.covers_ts(ts):
                continue
            if scope is not None and handle.retired_at_ts is None and sid not in scope:
                continue
            seg = handle.segment
            if prune is not None and seg.partition not in prune:
                continue
            if seg.num_rows == 0 or seg.min_ts() > ts:
                continue
            mask, filtered = unit_mask(sid, seg)
            if filtered and not bool(mask.any()):
                continue
            index = handle.index_for(column)
            if filter is not None:
                self._plan_filtered_unit(
                    plan, sid, seg, handle.attr_indexes, mask, index,
                    filter, filter_strategy, k, brute_column,
                )
                continue
            if index is not None:
                plan.indexed.append(ScanUnit(sid, seg.pks(), mask, index=index))
            else:
                vectors = brute_column(seg)
                if vectors is None:
                    continue
                plan.brute_sealed.append(ScanUnit(sid, seg.pks(), mask, vectors=vectors))
        if scope is not None and scope - served:
            raise StalePlanError(
                f"{self.node_id}: scoped segments {sorted(scope - served)} "
                f"of '{collection}' are not serveable at ts={ts}"
            )

        shard_scope = set(shards) if shards is not None else None
        for (coll, sid), seg in self.growing.items():
            if coll != collection:
                continue
            if shard_scope is not None and seg.shard not in shard_scope:
                continue
            if prune is not None and seg.partition not in prune:
                continue
            if seg.num_rows == 0 or seg.min_ts() > ts:
                continue
            mask, filtered = unit_mask(sid, seg)
            if filter is not None:
                fmask = self._as_mask(filter.evaluate(_scalar_columns(seg), seg.num_rows))
                n_vis = int(mask.sum())
                mask = mask & fmask
                plan.filter_info.append({
                    "segment_id": sid, "strategy": "pre",
                    "est": float(fmask.float().mean()),
                    "actual": (int(mask.sum()) / n_vis) if n_vis else 0.0,
                })
                self.metrics.inc("filter_strategy_total", labels={"strategy": "pre"})
            vectors = brute_column(seg)
            if vectors is None:
                continue
            pks = seg.pks()
            covered = torch.zeros(seg.num_rows, dtype=torch.bool, device=self.device)
            n_covered = 0
            if column == PRIMARY_VECTOR_COLUMN:
                for s_idx, temp in seg.slice_indexes.items():
                    if metric is not None and temp.metric is not metric:
                        # metric-mismatched temp index (built L2 off the
                        # WAL): the slice stays in the brute tail, exact
                        continue
                    lo, hi = seg.slice_bounds(s_idx)
                    covered[lo:hi] = True
                    n_covered += hi - lo
                    plan.growing_slice.append(
                        ScanUnit(sid, pks[lo:hi], mask[lo:hi], index=temp)
                    )
            # tail = rows not covered by any temp index yet
            if n_covered == seg.num_rows:
                continue
            tail_mask = mask & ~covered
            if filtered and not bool(tail_mask.any()):
                continue
            plan.brute_tail.append(ScanUnit(sid, pks, tail_mask, vectors=vectors))
        return plan

    def _plan_filtered_unit(
        self, plan: SearchPlan, sid: int, seg: Segment, attr_indexes: dict,
        mask: torch.Tensor, index: VectorIndex | None, fexpr, override: str | None,
        k: int, brute_column,
    ) -> None:
        """Resolve the filter bitmap for one sealed unit and place it in the
        strategy class its selectivity calls for."""
        n = seg.num_rows
        try:
            fmask_np = fexpr.bitmap(attr_indexes, n)
            est = fexpr.estimate_selectivity(attr_indexes, n)
        except KeyError:
            fmask_np = np.asarray(fexpr.evaluate(_scalar_columns(seg), n), bool)
            est = float(fmask_np.mean()) if n else 0.0
        fmask = self._as_mask(fmask_np)
        n_vis = int(mask.sum())
        combined = ops.mask_intersect(mask, fmask)
        n_comb = int(combined.sum())
        actual = (n_comb / n_vis) if n_vis else 0.0
        strategy = choose_filter_strategy(override, n_vis, n_comb, k, index is not None)
        plan.filter_info.append({
            "segment_id": sid, "strategy": strategy,
            "est": est, "actual": actual, "rows": n_comb,
        })
        self.metrics.inc("filter_strategy_total", labels={"strategy": strategy})
        labels = {"collection": seg.collection, "segment": str(sid)}
        self.metrics.set_gauge("filter_selectivity_est", est, labels=labels)
        self.metrics.set_gauge("filter_selectivity_actual", actual, labels=labels)
        if n_comb == 0:
            return
        pks = seg.pks()
        if strategy == "brute":
            vectors = brute_column(seg)
            if vectors is None:
                return
            rows = torch.nonzero(combined).squeeze(1)
            plan.brute_filtered.append(
                ScanUnit(
                    sid, pks[rows], torch.ones(len(rows), dtype=torch.bool, device=self.device),
                    vectors=vectors[rows].contiguous(),
                )
            )
        elif strategy == "post":
            unit = ScanUnit(sid, pks, mask, post_mask=fmask, k_extra=n_vis - n_comb)
            if index is not None:
                unit.index = index
                plan.post_indexed.append(unit)
            else:
                unit.vectors = brute_column(seg)
                if unit.vectors is None:
                    return
                plan.post_brute.append(unit)
        else:  # pre
            unit = ScanUnit(sid, pks, combined)
            if index is not None:
                unit.index = index
                plan.indexed.append(unit)
            else:
                unit.vectors = brute_column(seg)
                if unit.vectors is None:
                    return
                plan.brute_sealed.append(unit)

    def _execute_plan(
        self, plan: SearchPlan, queries: torch.Tensor, k: int, metric: Metric,
        trace: tuple | None = None,
    ) -> "tuple[list[torch.Tensor], list[torch.Tensor]]":
        """Run a plan's units and return per-unit top-k candidate pools."""
        metric_str = "l2" if metric is Metric.L2 else "ip"
        pool_s: list[torch.Tensor] = []
        pool_p: list[torch.Tensor] = []

        @contextlib.contextmanager
        def scanning(cls: str, units):
            """Around one class's launches: its ``scan_<cls>`` span (host and
            device time) when traced, then the rows its masks admit, counted
            on the device: nothing here waits for the card."""
            span = None
            if trace is None:
                yield
            else:
                ctx, parent = trace
                span = ctx.span(
                    f"scan_{cls}", parent=parent, node_id=self.node_id,
                    segment_ids=sorted({u.segment_id for u in units}),
                )
                with ctx.timed(span, self.device):
                    yield
            rows = torch.stack([u.mask.sum() for u in units]).sum()
            self.metrics.inc_device("query_node_rows_scanned_total", rows, labels={"class": cls})
            if span is not None:
                span.rows_scanned = rows

        def run_indexed(cls: str, units: list[ScanUnit], k_class: int, post: bool) -> None:
            groups: dict = {}
            for unit in units:
                groups.setdefault(unit.index.batch_spec(), []).append(unit)
            for group in groups.values():
                group_cls = "growing_slice" if id(group[0]) in slice_ids else cls
                with scanning(group_cls, group):
                    s, i, splits = type(group[0].index).search_batched(
                        [u.index for u in group], queries, k_class, valids=[u.mask for u in group]
                    )
                    for j, unit in enumerate(group):
                        cs, ci = s[:, splits[j] : splits[j + 1]], i[:, splits[j] : splits[j + 1]]
                        if post:
                            cs, ci = ops.post_filter_cut(cs, ci, unit.post_mask, metric=metric_str)
                        pool_s.append(cs)
                        pool_p.append(_map_pks(ci, unit.pks))

        def run_brute(cls: str, units: list[ScanUnit], k_class: int, post: bool) -> None:
            with scanning(cls, units):
                s, i = ops.topk_scan_segmented(
                    q_brute, [u.vectors for u in units], k_class, metric=metric_str,
                    valids=[u.mask for u in units],
                )
                for j, unit in enumerate(units):
                    cs, ci = s[:, j * k_class : (j + 1) * k_class], i[:, j * k_class : (j + 1) * k_class]
                    if post:
                        cs, ci = ops.post_filter_cut(cs, ci, unit.post_mask, metric=metric_str)
                    pool_s.append(cs)
                    pool_p.append(_map_pks(ci, unit.pks))

        # Sealed indexes and growing-slice temp indexes share the spec
        # grouping: every unit of one index spec runs as one dispatch.
        slice_ids = {id(u) for u in plan.growing_slice}
        if plan.indexed or plan.growing_slice:
            run_indexed("indexed", plan.indexed + plan.growing_slice, k, post=False)
        # Brute classes: one segmented scan per class.  Cosine scans take
        # the segments' unit columns; only the queries normalize here.
        q_brute = normalize_if_cosine(metric, queries)
        for cls, units in (("brute_sealed", plan.brute_sealed), ("brute_tail", plan.brute_tail)):
            if units:
                run_brute(cls, units, k, post=False)
        # Post-filter classes scan visibility-only masks at k + max(k_extra)
        # (a provable superset of the filtered top-k) and cut afterwards.
        if plan.post_indexed:
            run_indexed(
                "post_indexed", plan.post_indexed,
                k + max(u.k_extra for u in plan.post_indexed), post=True,
            )
        if plan.post_brute:
            run_brute(
                "post_brute", plan.post_brute,
                k + max(u.k_extra for u in plan.post_brute), post=True,
            )
        if plan.brute_filtered:
            with scanning("brute_filtered", plan.brute_filtered):
                for unit in plan.brute_filtered:
                    s, i = ops.topk_scan(q_brute, unit.vectors, k, metric=metric_str)
                    pool_s.append(s)
                    pool_p.append(_map_pks(i, unit.pks))
        return pool_s, pool_p

    def search_request(
        self, request: NodeSearchRequest
    ) -> "list[tuple[torch.Tensor, torch.Tensor]]":
        """Execute a node-level request: the node-wise top-k per
        sub-request as device tensors (scores [nq,k] float32, pks [nq,k]
        int64; -1 = empty)."""
        if not self.alive:
            raise RuntimeError(f"query node {self.node_id} is down")
        if request.trace is None:
            with self._serve_lock:
                return self._serve(request)
        # Traced: the wait for the lock (a pump step of this node, or
        # another dispatch) is the dispatch's first span.
        ctx, parent = request.trace
        with ctx.timed(ctx.span("serve_wait", parent=parent, node_id=self.node_id)):
            self._serve_lock.acquire()
        try:
            return self._serve(request)
        finally:
            self._serve_lock.release()

    def _serve(self, request: NodeSearchRequest):
        self.search_count += 1
        if request.hedged:
            self.searches_hedged += 1
        else:
            self.searches_primary += 1
            self.inflight_primary += 1
        self.inflight += 1
        t0 = time.perf_counter()
        try:
            return self._search_request(request)
        finally:
            self.inflight -= 1
            if not request.hedged:
                self.inflight_primary -= 1
            self.metrics.observe(
                "query_node_search_latency_us", (time.perf_counter() - t0) * 1e6,
                labels={"node": self.node_id},
            )

    def _search_request(self, request: NodeSearchRequest):
        metric = request.metric
        metric_str = "l2" if metric is Metric.L2 else "ip"
        ts = request.guarantee.query_ts
        fill = float("inf") if metric is Metric.L2 else float("-inf")
        trace = request.trace
        if trace is None:
            doomed, _outcome = self._request_doomed_pks(request.collection, ts)
        else:
            ctx, parent = trace
            dspan = ctx.span("doomed_pks", parent=parent, node_id=self.node_id)
            with ctx.timed(dspan):
                doomed, dspan.detail = self._request_doomed_pks(request.collection, ts)
        shards = (
            None
            if request.channels is None
            else tuple(sorted({shard_of_channel(c) for c in request.channels}))
        )
        results: list[tuple[torch.Tensor, torch.Tensor]] = []
        for a in request.anns:
            queries = a.queries.to(self.device).contiguous()
            nq = len(queries)
            plan_kw = dict(
                column=a.field, metric=metric, doomed=doomed,
                partitions=request.partitions, segments=request.segments, shards=shards,
                filter=request.filter, filter_strategy=request.filter_strategy, k=request.k,
            )
            if trace is not None:
                ctx, parent = trace
                pspan = ctx.span(
                    "plan_search", parent=parent, node_id=self.node_id, detail=f"column={a.field}"
                )
                with ctx.timed(pspan):
                    plan = self.plan_search(request.collection, ts, request.filter_masks, **plan_kw)
                pspan.segment_ids = tuple(sorted({u.segment_id for u in plan.units()}))
                if request.filter is not None and plan.filter_info:
                    fspan = ctx.span(
                        "filter_plan", parent=parent, node_id=self.node_id,
                        detail=",".join(
                            f"{fi['segment_id']}:{fi['strategy']}@{fi['actual']:.3f}"
                            for fi in plan.filter_info
                        ),
                    )
                    fspan.segment_ids = tuple(fi["segment_id"] for fi in plan.filter_info)
            else:
                plan = self.plan_search(request.collection, ts, request.filter_masks, **plan_kw)
            pool_s, pool_p = self._execute_plan(plan, queries, request.k, metric, trace=trace)
            if not pool_s:
                out = (
                    torch.full((nq, request.k), fill, dtype=torch.float32, device=self.device),
                    torch.full((nq, request.k), -1, dtype=torch.int64, device=self.device),
                )
            elif trace is not None:
                ctx, parent = trace
                mspan = ctx.span("node_merge_topk", parent=parent, node_id=self.node_id)
                with ctx.timed(mspan, self.device):
                    out = ops.merge_topk(
                        torch.cat(pool_s, 1), torch.cat(pool_p, 1), request.k, metric=metric_str
                    )
            else:
                out = ops.merge_topk(
                    torch.cat(pool_s, 1), torch.cat(pool_p, 1), request.k, metric=metric_str
                )
            results.append(out)
        return results

    def search(
        self, collection: str, queries, k: int, metric: Metric, guarantee: GuaranteeTs,
        filter_masks=None,
    ) -> "tuple[torch.Tensor, torch.Tensor]":
        """Node-wise top-k over the primary vector column (a thin facade
        over :meth:`search_request`)."""
        request = NodeSearchRequest(
            collection=collection, k=k, metric=metric, guarantee=guarantee,
            anns=[AnnsQuery(PRIMARY_VECTOR_COLUMN, queries)], filter_masks=filter_masks,
        )
        return self.search_request(request)[0]

    # ----------------------------------------------------------- hydration
    def fetch_fields(
        self, collection: str, pks, columns: "list[str]", ts: int
    ) -> "dict[str, tuple[np.ndarray, np.ndarray]]":
        """Stored column values of the result ``pks`` visible at ``ts`` on
        this node (output-field hydration).  ``columns`` holds segment
        column names ("pk", the primary "vector" column or an extras
        column).  Returns column -> (found_pks [n], values [n, ...]) as host
        arrays; the proxy assembles the [nq, k] view."""
        want = np.unique(np.asarray(pks))
        want = torch.from_numpy(want[want >= 0].astype(np.int64)).to(self.device)
        out: dict[str, list] = {c: [] for c in columns}
        if want.numel():
            doomed, _outcome = self._request_doomed_pks(collection, ts)
            sources = [
                h.segment for (c, _sid), h in self.sealed.items()
                if c == collection and h.covers_ts(ts)
            ]
            sources += [seg for (c, _sid), seg in self.growing.items() if c == collection]
            for seg in sources:
                if seg.num_rows == 0:
                    continue
                hit = self._visible(collection, seg, ts, doomed)
                hit &= ops.isin_sorted(seg.pks(), want)
                if not bool(hit.any()):
                    continue
                hit_host = hit.cpu().numpy()
                hit_pks = seg.pks()[hit].cpu().numpy()
                for c in columns:
                    if c == "pk":
                        vals = hit_pks
                    elif c == PRIMARY_VECTOR_COLUMN:
                        vals = seg.vectors()[hit].cpu().numpy()
                    elif c in seg.extra_fields:
                        vals = np.asarray(seg.extra(c))[hit_host]
                    else:
                        continue  # segment predates the column
                    out[c].append((hit_pks, vals))
        return {
            c: (
                (np.concatenate([p for p, _v in out[c]]),
                 np.concatenate([v for _p, v in out[c]]))
                if out[c]
                else (np.empty(0, np.int64), np.empty(0))
            )
            for c in columns
        }
