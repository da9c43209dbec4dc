"""Access layer: stateless proxies (paper §3.2, §3.6); mirrors
``repro.core.proxy``.  Node partials arrive as device tensors and the
global reduce runs on their device through ``ops.merge_topk`` (the
``merge_topk`` kernel on a card); range cut and hybrid fusion are tensor
code there too.  Hydrated output fields are gathered into host numpy.

Proxies verify requests against cached metadata (early rejection), route
inserts/deletes to the owning loggers via the hash ring, and drive the
read path with **replica-aware dispatch**: each live sealed segment is
routed to the least-loaded live replica of its group (plus the DML
channel owners for growing rows), and the per-node partials reduce into
the global top-k with pk-dedup (a segment may briefly live on two nodes
during redistribution, and a row may exist both in a growing copy and
the sealed segment).

Straggler mitigation: ``search`` takes a ``hedge_timeout_s``; a plan
unit that does not answer in time is re-dispatched to a *different*
replica of the same segment (blocking fallback on the original node only
for units with no alternative copy).  If a node dies between planning
and scan, the proxy reports it to the coordinator's control loop and
re-dispatches the failed units to surviving replicas mid-request.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from .collection import CollectionInfo, FieldType, Metric
from .consistency import GuaranteeTs
from .coordinator import QueryCoordinator
from .log import shard_of_channel, shard_of_pk
from .logger_node import Logger
from .meta_store import MetaStore
from .query_node import QueryNode, StalePlanError
from .request import (
    DeleteRequest,
    InsertRequest,
    MutationRequest,
    MutationResult,
    NodeSearchRequest,
    SearchRequest,
    UpsertRequest,
    vector_column_of,
)
from .segment import DEFAULT_PARTITION
from .telemetry import MetricsRegistry, TraceContext
from .timestamp import TSO, INFINITE_STALENESS


@dataclass
class SearchResult:
    # Tensors on the query nodes' device (the reference returns numpy).
    scores: torch.Tensor  # [nq, k]; raw metric scores, or fused sims (hybrid)
    pks: torch.Tensor  # [nq, k] int64, -1 = empty slot
    query_ts: int
    waited_ms: float = 0.0
    # Output-field hydration: field name -> [nq, k] (or [nq, k, dim] for
    # vector fields) aligned with ``pks``; empty slots carry NaN/0 fills.
    fields: dict[str, np.ndarray] | None = None
    # Span tree (telemetry.RequestTrace) when SearchRequest(trace=True).
    trace: object | None = None


class Proxy:
    def __init__(
        self,
        proxy_id: str,
        meta: MetaStore,
        tso: TSO,
        loggers: list[Logger],
        query_coord: QueryCoordinator,
        query_nodes: dict[str, QueryNode],
        metrics: MetricsRegistry | None = None,
    ):
        self.proxy_id = proxy_id
        self.meta = meta
        self.tso = tso
        self.loggers = loggers
        self.query_coord = query_coord
        self.query_nodes = query_nodes
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # BOUNDED staleness window (ms) for named-level resolution; the
        # system facade threads ``ManuConfig.bounded_staleness_ms`` here.
        self.bounded_staleness_ms = 2_000.0
        # How to advance message delivery while waiting on a placement
        # change mid-request (failover / slow load).  None = step the live
        # query nodes directly (cooperative default); the threaded runtime
        # installs a short sleep so its pump thread does the stepping.
        self.pump_fn = None
        # Taken around the control calls a request makes (failover reports,
        # reconciles): the system's step lock, so they do not interleave
        # with a pump thread's round.
        self.control_lock = threading.RLock()
        # Metadata cache, refreshed via meta-store watch (paper: proxies
        # cache a copy of the metadata for verifying legitimacy).
        self._meta_cache: dict[str, dict] = {}
        self._cancel_watch = meta.watch("collection/", self._on_meta)
        for key, value in meta.scan("collection/").items():
            self._meta_cache[key.split("/", 1)[1]] = value
        # Partition cache: collection -> live partition names, kept fresh
        # the same way so placement/pruning verify without a meta round-trip.
        self._partition_cache: dict[str, set[str]] = {}
        self._cancel_partition_watch = meta.watch("partition/", self._on_partition)
        for key in meta.scan("partition/"):
            self._on_partition(key, True)
        # Compiled-filter LRU: (collection, expr string) -> FilterExpr.
        # Filters repeat heavily across requests (dashboards, paginated
        # clients), so parse+validate once and ship the compiled tree.
        self._filter_cache: "OrderedDict[tuple[str, str], object]" = OrderedDict()

    def _on_meta(self, key: str, value) -> None:
        name = key.split("/", 1)[1]
        if value is None:
            self._meta_cache.pop(name, None)
        else:
            self._meta_cache[name] = value

    def _on_partition(self, key: str, value) -> None:
        _, coll, name = key.split("/", 2)
        parts = self._partition_cache.setdefault(coll, set())
        if value is None:
            parts.discard(name)
        else:
            parts.add(name)

    # ------------------------------------------------------------- routing
    def _verify(self, collection: str) -> dict:
        info = self._meta_cache.get(collection)
        if info is None:
            raise KeyError(f"collection '{collection}' does not exist")
        return info

    def _logger_for(self, shard: int) -> Logger:
        live = [lg for lg in self.loggers if lg.alive]
        if not live:
            raise RuntimeError("no live loggers")
        return live[shard % len(live)]

    def partitions_of(self, collection: str) -> set[str]:
        parts = self._partition_cache.get(collection)
        # A collection created before any partition watch fired still owns
        # the implicit default partition.
        return parts if parts else {DEFAULT_PARTITION}

    def _verify_partition(self, collection: str, partition: str) -> None:
        if partition not in self.partitions_of(collection):
            raise KeyError(
                f"no partition '{partition}' in collection '{collection}'"
            )

    def mutate(self, info: CollectionInfo, request: MutationRequest) -> MutationResult:
        """Execute one typed mutation: verify against cached metadata
        (early rejection, paper §3.2), then route to the owning logger on
        the hash ring (the logger owning the batch's first shard handles
        the request; batches span shards and each shard gets its own WAL
        record)."""
        trace_ctx = (
            TraceContext("mutation") if getattr(request, "trace", False) else None
        )
        t0 = time.perf_counter()
        self._verify(info.name)
        request.validate(info.schema)
        shard0 = 0
        if isinstance(request, (InsertRequest, UpsertRequest)):
            self._verify_partition(info.name, request.partition)
            pk_field = info.schema.primary()
            if pk_field is not None and pk_field.name in request.rows:
                first = np.asarray(request.rows[pk_field.name])[:1]
                if first.size:
                    shard0 = shard_of_pk(first.tolist()[0], info.num_shards)
        elif isinstance(request, DeleteRequest) and len(request.pks):
            shard0 = shard_of_pk(request.pks.tolist()[0], info.num_shards)
        logger = self._logger_for(shard0)
        if trace_ctx is not None:
            span = trace_ctx.span(
                "logger_dispatch", node_id=logger.logger_id,
                detail=f"op={request.op};shard0={shard0}",
            )
            with trace_ctx.timed(span):
                res = logger.mutate(info, request, trace=(trace_ctx, span))
        else:
            res = logger.mutate(info, request)
        elapsed_us = (time.perf_counter() - t0) * 1e6
        self.metrics.inc("proxy_mutations_total", labels={"op": request.op})
        self.metrics.observe("proxy_mutation_latency_us", elapsed_us)
        if trace_ctx is not None:
            res.trace = trace_ctx.finish(elapsed_us)
        return res

    def mutate_batch(
        self,
        info: CollectionInfo,
        requests: "list[MutationRequest]",
        shard: int = 0,
        traces: "list[tuple | None] | None" = None,
        prevalidated: bool = False,
    ) -> "list[MutationResult | Exception]":
        """Scheduler flush path: one logger crossing for a micro-batch of
        already-admitted requests sharing a routing shard.  Verification
        happened at admission; ``prevalidated`` additionally skips the
        logger's per-request schema validation (admission already ran it).
        Each slot answers with its own result (or its own exception)."""
        self._verify(info.name)
        logger = self._logger_for(shard)
        results = logger.mutate_batch(
            info, requests, traces=traces, prevalidated=prevalidated
        )
        for request, res in zip(requests, results):
            if isinstance(res, MutationResult):
                self.metrics.inc(
                    "proxy_mutations_total", labels={"op": request.op}
                )
        return results

    def resolve_guarantee(self, request: SearchRequest) -> GuaranteeTs:
        """Pin the request's consistency fields to a :class:`GuaranteeTs`.

        Standalone-proxy rules: named levels resolve against this proxy's
        ``bounded_staleness_ms``; unset consistency falls back to INFINITE
        staleness (eventual — any watermark satisfies, session_ts still
        honored).  The system facade substitutes its own configured
        default instead."""
        if request.time_travel_ts is not None:
            return GuaranteeTs(
                query_ts=request.time_travel_ts,
                staleness_ms=INFINITE_STALENESS,
            )
        return GuaranteeTs(
            query_ts=self.tso.next(),
            staleness_ms=request.resolve_staleness_ms(
                INFINITE_STALENESS, bounded_ms=self.bounded_staleness_ms
            ),
            session_ts=request.session_ts,
        )

    # ------------------------------------------------------ legacy facades
    def insert(self, info: CollectionInfo, rows: dict[str, np.ndarray]) -> tuple[int, int]:
        """Legacy surface: (lsn, row_count) via the typed pipeline."""
        res = self.mutate(info, InsertRequest(rows))
        return res.watermark_ts, res.row_count

    def delete(self, info: CollectionInfo, pks: np.ndarray) -> int:
        """Legacy surface: bare LSN via the typed pipeline."""
        return self.mutate(info, DeleteRequest(np.asarray(pks))).watermark_ts

    # -------------------------------------------------------------- search
    def search(
        self,
        info: CollectionInfo,
        queries,
        k: int | None = None,
        guarantee: GuaranteeTs | None = None,
        wait_fn=None,
        hedge_timeout_s: float | None = None,
        filter_expr=None,
    ) -> SearchResult:
        """Execute one declarative :class:`SearchRequest` (or the legacy
        positional ``(queries, k)`` form, which is packed into a
        single-field request) with a two-phase reduce over the query nodes
        holding the collection.

        Per sub-request: node-wise top-k partials -> global ``merge_topk``
        reduce with pk-dedup (a segment may surface from two nodes during
        redistribution) — vectorized in the merge_topk kernel.  Hybrid
        requests then fuse the per-field global lists with the request's
        ranker; ``output_fields`` hydrate from node-held segment columns.

        ``wait_fn(node, guarantee) -> None`` implements the consistency
        wait (cooperative runtimes pump the system; threaded runtimes
        block).
        """
        if isinstance(queries, SearchRequest):
            request = queries
        else:
            request = SearchRequest.single(
                queries,
                field=info.schema.vector_fields()[0].name,
                k=k if k is not None else 10,
                filter=filter_expr,
            )
        # The root span covers the whole call: validation, planning, the
        # dispatches, the global merge and the hydration.
        trace_ctx = TraceContext("search") if request.trace else None
        pk_field = info.schema.primary()
        if pk_field is not None and pk_field.dtype is FieldType.STRING:
            # Rows hold int64 surrogates of string keys (``IdAllocator.
            # string_ids``); answers would name those, not the user's keys.
            # The reference fails here too, deep in its merge.
            raise TypeError(
                f"collection '{info.name}' has string primary keys: it ingests, "
                "deletes and counts them, but search over it is not supported"
            )
        # Never mutate the caller's request object — it may be reused.
        active_filter = request.filter if request.filter is not None else filter_expr
        active_fexpr = self._compile_filter(info.name, active_filter)
        self._verify(info.name)
        request.validate(info.schema)
        if request.partition_names:
            known = self.partitions_of(info.name)
            unknown = sorted(set(request.partition_names) - known)
            if unknown:
                raise ValueError(
                    f"unknown partition(s) {unknown} in collection '{info.name}'"
                )
        self._check_range_bounds(info.metric, request)
        if guarantee is None:
            # Standalone proxy use: honor the request's own consistency
            # fields (the system facade resolves these with its configured
            # default staleness and wait machinery instead).
            guarantee = self.resolve_guarantee(request)
        metric = info.metric
        n_fields = len(request.anns)
        t0 = time.perf_counter()

        def dispatch(
            node: QueryNode, sids: "frozenset[int] | None", hedged: bool = False
        ):
            node_trace = None
            if trace_ctx is not None:
                span = trace_ctx.span(
                    "hedge_dispatch" if hedged else "dispatch",
                    node_id=node.node_id,
                    segment_ids=sorted(sids) if sids is not None else (),
                    detail="" if sids is not None else "full-fanout",
                )
                node_trace = (trace_ctx, span)
            node_req = NodeSearchRequest.from_request(
                info.schema, info.name, request, metric, guarantee,
                filter=active_fexpr,
                segments=tuple(sorted(sids)) if sids is not None else None,
                channels=growing_scopes.get(node.node_id, None),
                trace=node_trace,
                hedged=hedged,
            )
            if node_trace is not None:
                with trace_ctx.timed(node_trace[1]):
                    return node.search_request(node_req)
            return node.search_request(node_req)

        # Replica-aware plan: (node_id, sealed plan units) per dispatch;
        # channel servers join with an empty unit set for growing rows —
        # per channel, the freshest replica whose consumed watermark
        # already covers the guarantee when one exists (zero-wait routing,
        # paper §4.2), else the freshest available (waited).
        chosen, orphans, waits, routed = self._dispatch_plan(info.name, guarantee)
        pending: "list[tuple[str, frozenset[int]]]" = [
            (n, frozenset(s)) for n, s in sorted(chosen.items())
        ]
        # Consistency-wait scope per dispatched node: a sorted channel
        # tuple = wait only on those channels (empty = routed, no wait);
        # None = legacy full wait over every channel the node serves
        # (failover additions below stay conservative with None).
        wait_scopes: "dict[str, tuple | None]" = {
            n: tuple(sorted(waits.get(n, ()))) for n, _ in pending
        }
        # Growing-scan scope per dispatched node: each node serves growing
        # rows only for the channels routed TO IT (() = sealed units only).
        # Without this, a node picked for sealed segments that also
        # subscribes a channel routed to a fresher covering replica would
        # scan its lagging growing copy without a wait — tombstones are
        # per-node, so rows deleted before the wait target would resurface
        # in the merged top-k.  Failover/hedge additions below are absent
        # from the map: scope None = full growing scan, paired with the
        # conservative full wait above.
        growing_scopes: "dict[str, tuple | None]" = {
            n: tuple(sorted(routed.get(n, ()))) for n, _ in pending
        }
        if orphans:
            pending.extend(self._recover_orphans(info.name, orphans))
        # partials[f] collects every node's candidate list for sub-request f
        partials: list[list[tuple[torch.Tensor, torch.Tensor]]] = [
            [] for _ in range(n_fields)
        ]
        done_ids: set[str] = set()
        covered: set[int] = set()  # sealed units already answered
        hedged_units: set[tuple[str, frozenset]] = set()
        wait_scoped: bool | None = None  # does wait_fn accept a channel scope?
        late_rounds = 0
        while True:
            if not pending:
                # Under a pump thread (``pump_fn``), a growing segment can be
                # handed over to its sealed copy between planning and the
                # scan: the plan has no sealed unit for it and the growing
                # copy is gone (the reference loses its rows; ROADMAP Queue
                # 3).  Dispatch every sealed segment placed since and not yet
                # answered; pk-dedup at the merge absorbs overlap.
                if self.pump_fn is None or late_rounds == self._LATE_LOAD_ROUNDS:
                    break
                pending.extend(self._late_loads(info.name, covered))
                if not pending:
                    break
                late_rounds += 1
                self.metrics.inc("proxy_late_load_dispatches_total")
            node_id, sids = pending.pop(0)
            is_hedge = (node_id, sids) in hedged_units
            node = self.query_nodes.get(node_id)
            res = None
            failed = node is None or not node.alive
            if not failed:
                if wait_fn is not None:
                    scope = wait_scopes.get(node_id, None)
                    if scope is None:
                        wait_args = (node, guarantee)
                    elif scope:
                        if wait_scoped is None:
                            wait_scoped = _accepts_channel_scope(wait_fn)
                        # a legacy wait_fn takes no scope: conservative full wait
                        wait_args = (node, guarantee, scope) if wait_scoped else (node, guarantee)
                    else:
                        # empty scope: every channel this node serves is
                        # already covered by a routed pick — zero-wait path
                        wait_args = None
                    if wait_args is not None and trace_ctx is None:
                        wait_fn(*wait_args)
                    elif wait_args is not None:
                        with trace_ctx.timed(trace_ctx.span("consistency_wait", node_id=node_id)):
                            wait_fn(*wait_args)
                try:
                    # A hedge is not hedged again: its unit would bounce
                    # between the replicas for as long as each dispatch
                    # missed the timeout.
                    if hedge_timeout_s is not None and not is_hedge:
                        res = _run_with_timeout(
                            lambda: dispatch(node, sids, is_hedge),
                            hedge_timeout_s,
                        )
                        if res is None:  # straggler: hedge to other replicas
                            self.metrics.inc("proxy_hedges_total")
                            if trace_ctx is not None:
                                trace_ctx.span(
                                    "hedge", node_id=node_id,
                                    segment_ids=sorted(sids or ()),
                                    detail="timeout",
                                )
                            res, extra = self._hedge(
                                info, node, sids, dispatch,
                                channels=growing_scopes.get(node_id, None),
                            )
                            hedged_units.update(extra)
                            pending.extend(extra)
                    else:
                        res = dispatch(node, sids, is_hedge)
                except StalePlanError:
                    # A compaction swap landed between planning and scan:
                    # the scoped segments were retired and their rewrites
                    # are live.  Re-plan the uncovered remainder from
                    # fresh placement (pk-dedup at merge absorbs overlap
                    # with units already scanned).
                    self.metrics.inc("proxy_stale_replans_total")
                    if trace_ctx is not None:
                        trace_ctx.span(
                            "stale_replan", node_id=node_id,
                            segment_ids=sorted(sids or ()),
                        )
                    pending.extend(
                        self._replan_stale(info.name, covered, pending)
                    )
                    pending.extend(
                        self._channel_dispatches(info.name, done_ids, pending)
                    )
                    continue
                except RuntimeError:
                    failed = True
            if failed:
                # Mid-request failover: the node died between planning and
                # scan.  Report it so the control loop reassigns now, then
                # re-dispatch the failed units to surviving replicas; the
                # dead node's growing rows replay onto the takeover channel
                # owner, which joins the plan below.
                self.metrics.inc("proxy_failovers_total")
                if trace_ctx is not None:
                    trace_ctx.span(
                        "failover_replan", node_id=node_id,
                        segment_ids=sorted(sids or ()),
                        detail="node-dead-mid-request",
                    )
                if node_id in self.query_coord.nodes:
                    with self.control_lock:
                        self.query_coord.on_node_down(node_id)
                if sids:
                    pending.extend(self._recover_orphans(info.name, sids))
                pending.extend(
                    self._channel_dispatches(info.name, done_ids, pending)
                )
                continue
            done_ids.add(node_id)
            if sids:
                covered.update(sids)
            if res is not None:
                for f in range(n_fields):
                    partials[f].append(res[f])
        waited_ms = (time.perf_counter() - t0) * 1e3
        target_nodes = [qn for qn in self.query_nodes.values() if qn.alive]

        nq = request.nq
        kk = request.k
        metric_str = "l2" if metric is Metric.L2 else "ip"
        fill = float("inf") if metric is Metric.L2 else float("-inf")
        device = next(
            (p[0][0].device for p in partials if p), request.anns[0].queries.device
        )
        merge_timer = (
            trace_ctx.timed(trace_ctx.span("merge_topk", node_id=self.proxy_id), device)
            if trace_ctx is not None else contextlib.nullcontext()
        )
        with merge_timer:
            merged: list[tuple[torch.Tensor, torch.Tensor]] = []
            for f in range(n_fields):
                if not partials[f]:
                    merged.append(
                        (
                            torch.full((nq, kk), fill, dtype=torch.float32, device=device),
                            torch.full((nq, kk), -1, dtype=torch.int64, device=device),
                        )
                    )
                    continue
                out_f = ops.merge_topk(
                    torch.cat([p[0] for p in partials[f]], 1),
                    torch.cat([p[1] for p in partials[f]], 1),
                    kk,
                    metric=metric_str,
                )
                # Range search: one post-scan radius cut on the GLOBAL per-field
                # list, so results are placement-independent ("the in-range
                # subset of the global top-k"); per-field params override the
                # request-level bounds.
                radius = request.anns[f].radius(request.radius)
                range_filter = request.anns[f].range_filter(request.range_filter)
                if radius is not None or range_filter is not None:
                    out_f = ops.range_cut(
                        out_f[0], out_f[1], metric_str, radius, range_filter
                    )
                merged.append(out_f)
            if request.is_hybrid:
                # Hybrid fusion over the per-field GLOBAL lists (RRF ranks are
                # only meaningful after the global reduce, hence proxy-side).
                out_s, out_p = ops.hybrid_fuse(
                    [m[0] for m in merged],
                    [m[1] for m in merged],
                    kk,
                    metrics=[metric.value] * n_fields,
                    weights=[a.weight for a in request.anns],
                    kind=request.ranker.kind,
                    rrf_k=request.ranker.rrf_k,
                )
            else:
                out_s, out_p = merged[0]
        fields = None
        if request.output_fields:
            hydrate_span = None
            if trace_ctx is not None:
                hydrate_span = trace_ctx.span("fetch_fields", node_id=self.proxy_id)
            if hydrate_span is not None:
                with trace_ctx.timed(hydrate_span):
                    fields = self._hydrate(
                        target_nodes, info, out_p, request.output_fields,
                        guarantee.query_ts, trace=(trace_ctx, hydrate_span),
                    )
            else:
                fields = self._hydrate(
                    target_nodes, info, out_p, request.output_fields,
                    guarantee.query_ts,
                )
        self.metrics.inc("proxy_searches_total")
        self.metrics.observe("proxy_search_latency_us", waited_ms * 1e3)
        trace = trace_ctx.finish() if trace_ctx is not None else None
        return SearchResult(
            out_s, out_p, guarantee.query_ts, waited_ms, fields, trace
        )

    # ------------------------------------------------- replica-aware dispatch
    _FAILOVER_ROUNDS = 200  # pump iterations before giving up on a unit
    _LATE_LOAD_ROUNDS = 4  # late-load dispatch rounds per request

    def _alive(self, node_id: str) -> bool:
        qn = self.query_nodes.get(node_id)
        return qn is not None and qn.alive

    def _node_load(self, node_id: str) -> tuple[int, int]:
        """(primary inflight requests, held replicas): the least-loaded
        key.  Hedged duplicates are deliberately excluded — counting them
        would double-book a straggler's work onto the replica that bailed
        it out and skew subsequent picks away from it."""
        qn = self.query_nodes.get(node_id)
        st = self.query_coord.nodes.get(node_id)
        return (
            qn.inflight_primary if qn is not None else 0,
            len(st.segments) if st is not None else 0,
        )

    def _pick_replica(
        self,
        collection: str,
        sid: int,
        exclude: "set[str] | frozenset[str]" = frozenset(),
        chosen: "dict[str, set[int]] | None" = None,
    ) -> str | None:
        """Least-loaded live replica of one segment that has the copy
        actually loaded (a committed-but-unloaded replica would silently
        scan nothing); ``chosen`` biases toward spreading this request's
        units evenly across its candidate nodes."""
        reps = self.query_coord.replica_sets.get((collection, sid), ())
        cands = [
            n for n in reps
            if n not in exclude
            and self._alive(n)
            and (collection, sid) in self.query_nodes[n].sealed
        ]
        if not cands:
            return None
        chosen = chosen or {}
        return min(
            cands,
            key=lambda n: (len(chosen.get(n, ())), *self._node_load(n), n),
        )

    def _channel_watermark(self, node_id: str, channel: str) -> int:
        """The node's consumed watermark on one DML channel (-1 = not
        actually subscribed yet — the coordinator committed the assignment
        but the subscribe message hasn't been applied)."""
        qn = self.query_nodes.get(node_id)
        if qn is None:
            return -1
        sub = qn.subscriptions.get(channel)
        return sub.last_tick_seen if sub is not None else -1

    def _dispatch_plan(
        self, collection: str, guarantee: GuaranteeTs | None = None
    ) -> (
        "tuple[dict[str, set[int]], list[int], dict[str, set[str]],"
        " dict[str, set[str]]]"
    ):
        """Build the replica-aware dispatch plan: per DML channel one
        serving replica for growing rows, plus per live sealed segment one
        replica chosen by load.  Segments with no dispatchable replica
        right now are returned as orphans for the failover path.

        Watermark-aware routing (paper §4.2 delta consistency): with a
        ``guarantee``, each channel prefers the *freshest candidate whose
        consumed watermark already covers* ``guarantee.wait_target_ts()``
        — that read waits 0 ms.  When nobody covers yet (e.g. STRONG: the
        query_ts postdates every tick by construction), the freshest
        candidate minimizes the wait, and the returned ``waits`` map marks
        the channel so the dispatch loop runs the consistency wait scoped
        to exactly the channels that still need it.

        The returned ``routed`` map records which channels each node serves
        growing rows for; the dispatch scopes every node's growing scan to
        its routed channels (a node picked only for sealed units, or whose
        channel went to a fresher covering replica, must not serve its own
        lagging growing copy — per-node tombstones would resurrect rows
        deleted before the wait target)."""
        coord = self.query_coord
        chosen: dict[str, set[int]] = {}
        waits: dict[str, set[str]] = {}
        routed: dict[str, set[str]] = {}
        prefix = f"dml/{collection}/"
        followers = getattr(coord, "channel_followers", {})
        cands_by_ch: dict[str, list[str]] = {}
        for n, st in coord.nodes.items():
            if not self._alive(n):
                continue
            for ch in st.channels:
                if ch.startswith(prefix):
                    cands_by_ch.setdefault(ch, []).append(n)
        for ch, fset in followers.items():
            if ch.startswith(prefix):
                for n in fset:
                    if self._alive(n) and n not in cands_by_ch.get(ch, ()):
                        cands_by_ch.setdefault(ch, []).append(n)
        for ch, cands in sorted(cands_by_ch.items()):
            covering = [] if guarantee is None else [
                n for n in cands
                if guarantee.satisfied_by(self._channel_watermark(n, ch))
            ]
            if covering:
                # Freshest covering candidate (owner or standby follower):
                # the delta-consistency zero-wait path.
                pick = min(
                    covering,
                    key=lambda n: (
                        -self._channel_watermark(n, ch),
                        *self._node_load(n),
                        n,
                    ),
                )
                chosen.setdefault(pick, set())
                routed.setdefault(pick, set()).add(ch)
                self.metrics.inc(
                    "consistency_routes_total", labels={"outcome": "covered"}
                )
                continue
            # Nobody covers (STRONG reads never can at plan time — their
            # query_ts postdates every consumed tick): legacy behavior,
            # the committed owner serves and runs the consistency wait.
            owners = [n for n in cands if ch in coord.nodes[n].channels]
            pick = min(
                owners or cands, key=lambda n: (*self._node_load(n), n)
            )
            chosen.setdefault(pick, set())
            routed.setdefault(pick, set()).add(ch)
            waits.setdefault(pick, set()).add(ch)
            if guarantee is not None:
                self.metrics.inc(
                    "consistency_routes_total", labels={"outcome": "waited"}
                )
        orphans: list[int] = []
        for sid in sorted(coord.placement_for(collection)):
            pick = self._pick_replica(collection, sid, chosen=chosen)
            if pick is None:
                orphans.append(sid)
            else:
                chosen.setdefault(pick, set()).add(sid)
        return chosen, orphans, waits, routed

    def _pump(self) -> None:
        """Advance coordination-message delivery while waiting on a
        placement change (failover reassignment, slow segment load)."""
        if self.pump_fn is not None:
            self.pump_fn()
        else:
            for qn in list(self.query_nodes.values()):
                if qn.alive:
                    qn.step()

    def _recover_orphans(
        self, collection: str, sids
    ) -> "list[tuple[str, frozenset[int]]]":
        """Re-plan segments that currently have no dispatchable replica:
        report observed-dead holders to the control loop, then reconcile
        and pump until a surviving replica has each copy loaded."""
        coord = self.query_coord
        missing = set(sids)
        with self.control_lock:
            for sid in sorted(missing):
                for n in list(coord.replica_sets.get((collection, sid), ())):
                    if not self._alive(n) and n in coord.nodes:
                        coord.on_node_down(n)
        out: dict[str, set[int]] = {}
        for _ in range(self._FAILOVER_ROUNDS):
            for sid in sorted(missing):
                pick = self._pick_replica(collection, sid, chosen=out)
                if pick is not None:
                    out.setdefault(pick, set()).add(sid)
            missing -= {s for units in out.values() for s in units}
            if not missing:
                break
            with self.control_lock:
                coord.reconciler.reconcile()
            self._pump()
        if missing:
            raise RuntimeError(
                f"no live replica for segments {sorted(missing)} "
                f"of '{collection}'"
            )
        return [(n, frozenset(s)) for n, s in sorted(out.items())]

    def _replan_stale(
        self, collection: str, covered: set[int], pending
    ) -> "list[tuple[str, frozenset[int]]]":
        """After a stale-plan signal: dispatch every currently-live sealed
        segment that is neither answered nor still pending (the rewrites a
        compaction swapped in mid-request)."""
        pending_sids = {s for _n, ss in pending for s in (ss or ())}
        out: dict[str, set[int]] = {}
        orphans: list[int] = []
        for sid in sorted(self.query_coord.placement_for(collection)):
            if sid in covered or sid in pending_sids:
                continue
            pick = self._pick_replica(collection, sid, chosen=out)
            if pick is None:
                orphans.append(sid)
            else:
                out.setdefault(pick, set()).add(sid)
        units = [(n, frozenset(s)) for n, s in sorted(out.items())]
        if orphans:
            units.extend(self._recover_orphans(collection, orphans))
        return units

    def _late_loads(self, collection: str, covered: set[int]) -> "list[tuple[str, frozenset[int]]]":
        """The sealed segments placed and loaded since the request was
        planned, not yet answered.  One placed but loaded nowhere still has
        its growing copy on the channel's node, which the request scanned."""
        out: dict[str, set[int]] = {}
        for sid in sorted(self.query_coord.placement_for(collection)):
            if sid not in covered:
                pick = self._pick_replica(collection, sid, chosen=out)
                if pick is not None:
                    out.setdefault(pick, set()).add(sid)
        return [(n, frozenset(s)) for n, s in sorted(out.items())]

    def _channel_dispatches(
        self, collection: str, done_ids: set[str], pending
    ) -> "list[tuple[str, frozenset[int]]]":
        """Channel owners not yet part of the plan (a failover re-homed the
        dead node's DML channels) join with an empty sealed-unit set so
        their replayed growing rows are scanned."""
        pending_ids = {n for n, _ in pending}
        out = []
        for n, st in self.query_coord.nodes.items():
            if not self._alive(n) or n in done_ids or n in pending_ids:
                continue
            if any(ch.startswith(f"dml/{collection}/") for ch in st.channels):
                out.append((n, frozenset()))
        return out

    def _hedge(
        self, info: CollectionInfo, node: QueryNode, sids, dispatch,
        channels=None,
    ):
        """Straggler mitigation: re-dispatch each timed-out sealed unit to
        a *different* live replica of the same segment.  Units with no
        alternative copy — and the straggler's growing rows, which exist
        nowhere else — fall back to a blocking dispatch on the original
        node (scoped to just those, so the hedged work is not repeated).
        ``channels`` is the straggler's growing-scan scope: only growing
        rows it would actually have served count toward the fallback."""
        extra: dict[str, set[int]] = {}
        uncovered: set[int] = set()
        for sid in sids or ():
            alt = self._pick_replica(
                info.name, sid, exclude={node.node_id}, chosen=extra
            )
            if alt is None:
                uncovered.add(sid)
            else:
                extra.setdefault(alt, set()).add(sid)
        shard_scope = (
            None if channels is None
            else {shard_of_channel(c) for c in channels}
        )
        has_growing = any(
            c == info.name and seg.num_rows
            and (shard_scope is None or seg.shard in shard_scope)
            for (c, _sid), seg in node.growing.items()
        )
        res = None
        if uncovered or has_growing:
            res = dispatch(node, frozenset(uncovered))
        return res, [(n, frozenset(s)) for n, s in sorted(extra.items())]

    @staticmethod
    def _check_range_bounds(metric: Metric, request: SearchRequest) -> None:
        """Reject always-empty range windows early (the bounds follow the
        Milvus convention: L2 keeps ``range_filter <= d < radius``,
        IP/cosine keeps ``radius < s <= range_filter``)."""
        for a in request.anns:
            radius = a.radius(request.radius)
            range_filter = a.range_filter(request.range_filter)
            if radius is None or range_filter is None:
                continue
            if metric is Metric.L2 and range_filter >= radius:
                raise ValueError(
                    f"L2 range window is empty: requires range_filter < radius, "
                    f"got range_filter={range_filter} >= radius={radius}"
                )
            if metric is not Metric.L2 and radius >= range_filter:
                raise ValueError(
                    f"{metric.value} range window is empty: requires "
                    f"radius < range_filter, got radius={radius} >= "
                    f"range_filter={range_filter}"
                )

    # ----------------------------------------------------------- hydration
    def _hydrate(
        self,
        target_nodes: "list[QueryNode]",
        info: CollectionInfo,
        pks: torch.Tensor,
        output_fields: "tuple[str, ...]",
        ts: int,
        trace: tuple | None = None,
    ) -> dict[str, np.ndarray]:
        """Gather ``output_fields`` columns for the result pks from the
        nodes' segment copies (binlog columns / growing rows), as host
        numpy arrays."""
        pks = pks.cpu().numpy()
        col_of = {
            f: ("pk" if f == "pk" else vector_column_of(info.schema, f)
                if info.schema.field(f).dtype is FieldType.VECTOR else f)
            for f in output_fields
        }
        columns = sorted(set(col_of.values()))
        found: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {
            c: [] for c in columns
        }
        for node in target_nodes:
            if not node.alive:
                continue
            try:
                if trace is not None:
                    ctx, parent = trace
                    nspan = ctx.span(
                        "fetch_fields_node", parent=parent, node_id=node.node_id,
                        detail=",".join(columns),
                    )
                    with ctx.timed(nspan):
                        got = node.fetch_fields(info.name, pks, columns, ts)
                else:
                    got = node.fetch_fields(info.name, pks, columns, ts)
            except RuntimeError:
                continue
            for c, (fpks, vals) in got.items():
                if len(fpks):
                    found[c].append((fpks, vals))
        out: dict[str, np.ndarray] = {}
        flat = np.where(pks >= 0, pks, 0)
        live = pks >= 0
        for f in output_fields:
            c = col_of[f]
            if found[c]:
                fp = np.concatenate([x[0] for x in found[c]])
                fv = np.concatenate([x[1] for x in found[c]])
                order = np.argsort(fp, kind="stable")
                fp, fv = fp[order], fv[order]
                idx = np.minimum(np.searchsorted(fp, flat), len(fp) - 1)
                hit = live & (fp[idx] == flat)
                vals = fv[idx]
            else:
                hit = np.zeros_like(live)
                if f != "pk" and info.schema.field(f).dtype is FieldType.VECTOR:
                    # keep the documented [nq, k, dim] shape even when no
                    # candidate hydrated (empty result / range cut all)
                    dim = info.schema.field(f).dim
                    vals = np.zeros(pks.shape + (dim,), np.float32)
                else:
                    vals = np.zeros(pks.shape, np.float32)
            out[f] = _mask_fill(vals, hit)
        return out

    _FILTER_CACHE_CAP = 256

    def _compile_filter(self, collection: str, filter_expr):
        """Compile an attribute filter once per (collection, expr string).

        The LRU holds the parsed+validated :class:`FilterExpr`; repeated
        requests with the same filter skip the ``ast.parse`` entirely.
        Already-compiled expressions pass through untouched."""
        if filter_expr is None:
            return None
        from ..index.attribute import FilterExpr

        if isinstance(filter_expr, FilterExpr):
            return filter_expr
        key = (collection, str(filter_expr))
        cached = self._filter_cache.get(key)
        if cached is not None:
            self._filter_cache.move_to_end(key)
            self.metrics.inc("filter_parse_cache_hit_total")
            return cached
        expr = FilterExpr(str(filter_expr))
        self.metrics.inc("filter_parse_cache_miss_total")
        self._filter_cache[key] = expr
        while len(self._filter_cache) > self._FILTER_CACHE_CAP:
            self._filter_cache.popitem(last=False)
        return expr


def _mask_fill(vals: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """Fill non-hydrated slots with a dtype-appropriate empty value
    (NaN for floats, 0/False for ints and bools, "" for strings)."""
    vals = np.asarray(vals)
    if hit.all():
        return vals
    if vals.ndim > hit.ndim:  # vector columns: [nq, k, dim]
        hit = hit[..., None]
    if np.issubdtype(vals.dtype, np.floating):
        return np.where(hit, vals, np.nan)
    if vals.dtype.kind in ("U", "S", "O"):
        return np.where(hit, vals, np.asarray("", vals.dtype))
    return np.where(hit, vals, np.zeros((), vals.dtype))


def _accepts_channel_scope(wait_fn) -> bool:
    """Can ``wait_fn`` take the optional third ``channels`` argument?
    Checked once per search so scoped waits degrade gracefully for legacy
    two-argument wait callables."""
    import inspect

    try:
        sig = inspect.signature(wait_fn)
    except (TypeError, ValueError):  # builtins / C callables: assume legacy
        return False
    params = list(sig.parameters.values())
    if any(p.kind is inspect.Parameter.VAR_POSITIONAL for p in params):
        return True
    positional = [
        p for p in params
        if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        )
    ]
    return len(positional) >= 3


def _run_with_timeout(fn, timeout_s: float):
    """Run fn in a worker thread; its answer, or None unless it answered
    within ``timeout_s`` (hedged-request helper).  The answer's own time
    decides, not whether the thread got to run before ``join`` returned, so
    a zero timeout makes every dispatch a straggler under any load."""
    result: list = []
    t0 = time.perf_counter()

    def target():
        out = fn()
        result.append((out, time.perf_counter() - t0))

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout_s)
    if result and result[0][1] <= timeout_s:
        return result[0][0]
    return None


# BatchingProxy is the scheduler's read micro-batching facade; the import
# lives at the bottom because scheduler.py imports SearchResult from here.
from .scheduler import BatchingProxy, RequestScheduler  # noqa: E402,F401
