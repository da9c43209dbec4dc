"""Request scheduler: the serving tier between clients and the proxy
(paper §3.6 request batching, §4.2 delta consistency); mirrors
``repro.core.scheduler`` (host logic; batched query vectors are
concatenated as tensors).

Writes no longer cross the WAL entry point one client request at a time.
``submit_mutation`` admits a typed mutation into a bounded per-(collection,
shard) queue under **credit-based backpressure** — a queue out of row
credits rejects at admission time with the typed :class:`AdmissionRejected`
(overload surfaces as an error the client can act on, never as silent
queueing collapse) — and hands back a :class:`MutationTicket`.  Queues
flush on three triggers:

* **depth** — the queue accumulated ``flush_rows`` rows;
* **age** — the oldest ticket waited ``flush_interval_ms`` (checked by
  ``step()``, which both runtimes drive: the cooperative ``pump()`` and the
  threaded pump loop);
* **explicit** — ``flush_writes()`` / ``MutationTicket.result()``.

A flushed batch crosses the proxy/logger boundary ONCE
(``Proxy.mutate_batch`` -> ``Logger.mutate_batch``): requests from
different clients are micro-batched cross-user, but each original request
keeps its own LSN and its own :class:`MutationResult` — batching is a
transport optimization, never a semantic merge.

Reads generalize the old ``BatchingProxy``: ``submit_search`` queues typed
:class:`SearchRequest`\\ s, ``flush_reads`` groups them by **compatible
plan shape** (collection, k, anns fields/weights, filter, partitions,
output fields, ranker, ...), concatenates the query vectors of each group,
executes ONE ``Proxy.search`` under the group's *strictest* guarantee
(max ``wait_target_ts``), and splits the result rows back per ticket.
``BatchingProxy`` survives as a thin facade over this stage.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .consistency import GuaranteeTs
from .log import shard_of_pk
from .request import (
    DeleteRequest,
    InsertRequest,
    MutationRequest,
    MutationResult,
    SearchRequest,
    UpsertRequest,
)
from .telemetry import MetricsRegistry, TraceContext
from .timestamp import Clock


class AdmissionRejected(RuntimeError):
    """Typed admission-control rejection: the target write queue is out of
    row credits.  Carries enough structure for a client to back off or
    route elsewhere instead of parsing a message string."""

    def __init__(
        self,
        collection: str,
        shard: int,
        pending_rows: int,
        capacity_rows: int,
        request_rows: int,
    ):
        self.collection = collection
        self.shard = shard
        self.pending_rows = pending_rows
        self.capacity_rows = capacity_rows
        self.request_rows = request_rows
        super().__init__(
            f"ingest queue for '{collection}' shard {shard} is full: "
            f"{pending_rows}/{capacity_rows} rows pending, "
            f"request needs {request_rows}"
        )


class MutationTicket:
    """Handle for one admitted async mutation.  ``result()`` force-flushes
    the owning queue if the batch has not gone out yet (so cooperative
    callers never deadlock on their own unflushed write), then blocks until
    the scheduler resolves it with the request's own :class:`MutationResult`
    — or re-raises the request's own failure."""

    __slots__ = (
        "request", "collection", "shard", "rows", "enqueued_ms",
        "trace_ctx", "_done", "_event", "_result", "_error", "_scheduler",
        "_callbacks",
    )

    def __init__(
        self,
        scheduler: "RequestScheduler",
        collection: str,
        shard: int,
        request: MutationRequest,
        rows: int,
        enqueued_ms: float,
    ):
        self.request = request
        self.collection = collection
        self.shard = shard
        self.rows = rows
        self.enqueued_ms = enqueued_ms
        self.trace_ctx = (
            TraceContext("mutation") if getattr(request, "trace", False) else None
        )
        # The Event is created lazily on the first wait: most tickets
        # resolve before anyone blocks on them, and an Event allocation
        # per admission is measurable on the ingest hot path.
        self._done = False
        self._event: threading.Event | None = None
        self._result: MutationResult | None = None
        self._error: BaseException | None = None
        self._scheduler = scheduler
        self._callbacks: list | None = None

    @property
    def done(self) -> bool:
        return self._done

    def _wait(self, timeout_s: float) -> bool:
        if self._done:
            return True
        ev = self._event
        if ev is None:
            # Publish the event BEFORE re-checking ``_done``: a resolver
            # that flips ``_done`` after our check is then guaranteed to
            # see (and set) the event, so the wait below cannot hang.
            ev = self._event = threading.Event()
            if self._done:
                return True
        return ev.wait(timeout_s)

    def on_resolve(self, fn) -> None:
        """Run ``fn(result)`` when the mutation lands (immediately if it
        already has).  Used by the system facade to advance session
        watermarks without polling.

        Registration synchronizes with the resolver through the scheduler
        lock: without it, a threaded pump resolving concurrently could run
        the callback list just before this append lands, leaving ``fn``
        registered but never invoked (a silently lost session-watermark
        advance)."""
        with self._scheduler._lock:
            if not self._done:
                if self._callbacks is None:
                    self._callbacks = []
                self._callbacks.append(fn)
                return
        if self._result is not None:
            fn(self._result)

    def wait(self, timeout_s: float) -> bool:
        """Block for a scheduler-triggered flush (depth/age) WITHOUT
        forcing one — the age-trigger test surface and the pattern for
        clients that want purely async acks."""
        return self._wait(timeout_s)

    def result(self, timeout_s: float = 30.0) -> MutationResult:
        if not self._done:
            self._scheduler.flush_writes(collection=self.collection)
        if not self._wait(timeout_s):
            raise TimeoutError(
                f"mutation ticket for '{self.collection}' shard {self.shard} "
                f"did not resolve within {timeout_s}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    # scheduler-side
    def _resolve(self, result: MutationResult) -> None:
        # ``_result`` is published before ``_done`` so any reader that
        # observes the done flag sees the result; the callback list is
        # detached and the flag flipped under the scheduler lock (see
        # ``on_resolve``), but the callbacks themselves run outside it.
        self._result = result
        with self._scheduler._lock:
            callbacks, self._callbacks = self._callbacks, None
            self._done = True
        if callbacks is not None:
            for fn in callbacks:
                fn(result)
        ev = self._event
        if ev is not None:
            ev.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        with self._scheduler._lock:
            self._callbacks = None
            self._done = True
        ev = self._event
        if ev is not None:
            ev.set()


class SearchTicket:
    """Handle for one queued read; resolved by ``flush_reads`` with this
    request's slice of its group's batched result."""

    __slots__ = ("info", "request", "guarantee", "_event", "_result", "_error")

    def __init__(self, info, request: SearchRequest, guarantee: GuaranteeTs | None):
        self.info = info
        self.request = request
        self.guarantee = guarantee  # None = resolve at flush time
        self._event = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout_s: float = 30.0):
        if not self._event.wait(timeout_s):
            raise TimeoutError("search ticket did not resolve (flush_reads not run?)")
        if self._error is not None:
            raise self._error
        return self._result


@dataclass
class _WriteQueue:
    info: object
    collection: str
    shard: int
    tickets: "list[MutationTicket]" = dc_field(default_factory=list)
    pending_rows: int = 0
    oldest_ms: float = 0.0
    # Precomposed series key for the depth gauge: label formatting per
    # admission is measurable on the ingest hot path.
    gauge_key: str = ""

    def __post_init__(self):
        self.gauge_key = MetricsRegistry._key(
            "sched_queue_rows",
            {"collection": self.collection, "shard": str(self.shard)},
        )


class RequestScheduler:
    """Per-system serving-tier scheduler (see module docstring)."""

    def __init__(
        self,
        proxy,
        clock: Clock | None = None,
        queue_rows: int = 8_192,
        flush_rows: int = 1_024,
        flush_interval_ms: float = 20.0,
        metrics: MetricsRegistry | None = None,
        guarantee_fn=None,
        on_flush=None,
    ):
        self.proxy = proxy
        self.clock = clock if clock is not None else Clock()
        self.queue_rows = int(queue_rows)
        self.flush_rows = int(flush_rows)
        self.flush_interval_ms = float(flush_interval_ms)
        self.metrics = metrics if metrics is not None else proxy.metrics
        # guarantee_fn(info, request) -> GuaranteeTs for read tickets whose
        # submitter pinned nothing; default = the proxy's standalone rules.
        self._guarantee_fn = guarantee_fn or (
            lambda _info, request: proxy.resolve_guarantee(request)
        )
        # Called after every write flush (the system facade pumps the
        # cooperative runtime here so subscribers observe the WAL entries).
        self.on_flush = on_flush
        self._queues: dict[tuple[str, int], _WriteQueue] = {}
        self._searches: list[SearchTicket] = []
        self._lock = threading.RLock()
        self._flushing = False  # re-entrancy guard: on_flush may pump us
        # Precomposed per-op admission-counter keys (see _WriteQueue.gauge_key)
        self._admit_keys = {
            op: MetricsRegistry._key("sched_admitted_total", {"op": op})
            for op in ("insert", "upsert", "delete")
        }

    # -------------------------------------------------------------- writes
    @staticmethod
    def _rows_of(request: MutationRequest) -> int:
        if isinstance(request, DeleteRequest):
            return len(request.pks)  # __post_init__ made them 1-D
        return len(next(iter(request.rows.values())))

    def _route(self, info, request: MutationRequest) -> int:
        """Routing shard — same rule as ``Proxy.mutate``: the batch's first
        primary key picks the owning logger."""
        if isinstance(request, (InsertRequest, UpsertRequest)):
            self.proxy._verify_partition(info.name, request.partition)
            pk_field = info.schema.primary()
            if pk_field is not None and pk_field.name in request.rows:
                first = np.asarray(request.rows[pk_field.name])[:1]
                if first.size:
                    return shard_of_pk(first.tolist()[0], info.num_shards)
        elif isinstance(request, DeleteRequest) and len(request.pks):
            return shard_of_pk(request.pks.tolist()[0], info.num_shards)
        return 0

    def submit_mutation(self, info, request: MutationRequest) -> MutationTicket:
        """Admit one typed mutation: verify against cached metadata NOW
        (admission-time early rejection — a queued request must never fail
        validation later, when the client is gone), charge the queue's row
        credits, enqueue.  Raises :class:`AdmissionRejected` when the queue
        is out of credits; an oversize request (larger than the whole
        queue) is admitted only when the queue is empty."""
        self.proxy._verify(info.name)
        request.validate(info.schema)
        shard = self._route(info, request)
        rows = self._rows_of(request)
        depth_flush = None
        with self._lock:
            key = (info.name, shard)
            q = self._queues.get(key)
            if q is None:  # get-then-insert: setdefault would construct
                q = self._queues[key] = _WriteQueue(info, info.name, shard)
                # (and discard) a fresh queue on every admission
            if q.pending_rows and q.pending_rows + rows > self.queue_rows:
                self.metrics.inc("sched_rejected_total")
                raise AdmissionRejected(
                    info.name, shard, q.pending_rows, self.queue_rows, rows
                )
            now = self.clock.now_ms()
            ticket = MutationTicket(self, info.name, shard, request, rows, now)
            if ticket.trace_ctx is not None:
                ticket.trace_ctx.span(
                    "sched_enqueue",
                    detail=f"shard={shard};queue_rows={q.pending_rows + rows}",
                )
            if not q.tickets:
                q.oldest_ms = now
            q.tickets.append(ticket)
            q.pending_rows += rows
            self.metrics.inc(
                self._admit_keys.get(request.op, "sched_admitted_total"))
            self._set_depth_gauge(q)
            if q.pending_rows >= min(self.flush_rows, self.queue_rows):
                depth_flush = self._take(q)
        if depth_flush is not None:
            self._execute(depth_flush, trigger="depth")
        return ticket

    def step(self) -> bool:
        """Age-trigger pass, driven by both runtimes' pumps: flush every
        queue whose oldest ticket has waited ``flush_interval_ms``."""
        if self._flushing:
            return False
        now = self.clock.now_ms()
        aged = []
        with self._lock:
            for q in self._queues.values():
                if q.tickets and now - q.oldest_ms >= self.flush_interval_ms:
                    aged.append(self._take(q))
        for batch in aged:
            self._execute(batch, trigger="age")
        return bool(aged)

    def flush_writes(self, collection: str | None = None) -> int:
        """Flush every (matching) queue now; returns requests flushed."""
        with self._lock:
            batches = [
                self._take(q)
                for q in self._queues.values()
                if q.tickets and (collection is None or q.collection == collection)
            ]
        n = 0
        for batch in batches:
            n += len(batch[1])
            self._execute(batch, trigger="explicit")
        return n

    def pending_write_rows(self, collection: str | None = None) -> int:
        with self._lock:
            return sum(
                q.pending_rows
                for q in self._queues.values()
                if collection is None or q.collection == collection
            )

    def _take(self, q: _WriteQueue):
        """Detach the queue's current contents (call under the lock)."""
        tickets, q.tickets = q.tickets, []
        q.pending_rows = 0
        self._set_depth_gauge(q)
        return (q, tickets)

    def _set_depth_gauge(self, q: _WriteQueue) -> None:
        self.metrics.set_gauge(q.gauge_key, q.pending_rows)

    def _execute(self, batch, trigger: str) -> None:
        """One proxy/logger crossing for the whole batch; each ticket is
        resolved with its request's own result (or its own failure — one
        request's fatal error never poisons its queue-mates)."""
        q, tickets = batch
        if not tickets:
            return
        now = self.clock.now_ms()
        rows = sum(t.rows for t in tickets)
        self.metrics.inc("sched_flushes_total", labels={"trigger": trigger})
        self.metrics.observe("sched_batch_requests", len(tickets))
        self.metrics.observe("sched_batch_rows", rows)
        for t in tickets:
            self.metrics.observe("sched_queue_wait_ms", max(0.0, now - t.enqueued_ms))
        traces = []
        for t in tickets:
            if t.trace_ctx is None:
                traces.append(None)
            else:
                span = t.trace_ctx.span(
                    "sched_flush",
                    detail=(
                        f"trigger={trigger};batch_requests={len(tickets)};"
                        f"batch_rows={rows}"
                    ),
                )
                traces.append((t.trace_ctx, span))
        t0 = time.perf_counter()
        was_flushing, self._flushing = self._flushing, True
        try:
            try:
                results = self.proxy.mutate_batch(
                    q.info, [t.request for t in tickets], shard=q.shard,
                    traces=traces, prevalidated=True,
                )
            except Exception as exc:
                # Whole-batch failure (e.g. no live logger): every ticket
                # reports it — a queued mutation never vanishes silently.
                for t in tickets:
                    t._fail(exc)
                return
            elapsed_us = (time.perf_counter() - t0) * 1e6
            for t, res in zip(tickets, results):
                if isinstance(res, MutationResult):
                    if t.trace_ctx is not None:
                        res.trace = t.trace_ctx.finish(elapsed_us)
                    t._resolve(res)
                else:
                    t._fail(res)
        finally:
            self._flushing = was_flushing
        if self.on_flush is not None:
            self.on_flush()

    # --------------------------------------------------------------- reads
    def submit_search(
        self, info, request: SearchRequest, guarantee: GuaranteeTs | None = None
    ) -> SearchTicket:
        self.proxy._verify(info.name)
        request.validate(info.schema)
        ticket = SearchTicket(info, request, guarantee)
        with self._lock:
            self._searches.append(ticket)
        return ticket

    @staticmethod
    def _plan_shape(info, request: SearchRequest) -> tuple:
        """Two requests with the same shape can run as one plan: same
        collection, k, anns signature, filter, scope and post-processing.
        Traced requests group only with traced ones (they share the batch's
        span tree)."""
        return (
            info.name,
            request.k,
            tuple(
                (a.field, a.weight, tuple(sorted(a.params.items())))
                for a in request.anns
            ),
            None if request.filter is None else str(request.filter),
            request.filter_strategy,
            request.radius,
            request.range_filter,
            request.output_fields,
            request.partition_names,
            request.time_travel_ts,
            (request.ranker.kind, request.ranker.rrf_k),
            request.trace,
        )

    def flush_reads(self, wait_fn=None, hedge_timeout_s: float | None = None) -> list:
        """Group queued reads by plan shape, run one ``Proxy.search`` per
        group under its strictest guarantee, split rows back per ticket.
        Returns the results in submit order (also delivered through each
        ticket)."""
        from .proxy import SearchResult  # local: proxy imports this module

        with self._lock:
            tickets, self._searches = self._searches, []
        if not tickets:
            return []
        groups: dict[tuple, list[int]] = {}
        for i, t in enumerate(tickets):
            groups.setdefault(self._plan_shape(t.info, t.request), []).append(i)
        results: list = [None] * len(tickets)
        self.metrics.inc("sched_search_requests_total", len(tickets))
        for idxs in groups.values():
            head = tickets[idxs[0]]
            guarantees = [
                t.guarantee
                if t.guarantee is not None
                else self._guarantee_fn(t.info, t.request)
                for t in (tickets[i] for i in idxs)
            ]
            # The batch executes under the *strictest* guarantee in the
            # group: every member's wait target is covered.
            guarantee = max(guarantees, key=lambda g: g.wait_target_ts())
            combined = SearchRequest(
                anns=[
                    type(a)(
                        a.field,
                        torch.cat(
                            [tickets[i].request.anns[f].queries for i in idxs], 0
                        ),
                        a.weight,
                        dict(a.params),
                    )
                    for f, a in enumerate(head.request.anns)
                ],
                k=head.request.k,
                filter=head.request.filter,
                filter_strategy=head.request.filter_strategy,
                radius=head.request.radius,
                range_filter=head.request.range_filter,
                output_fields=head.request.output_fields,
                partition_names=head.request.partition_names,
                time_travel_ts=head.request.time_travel_ts,
                ranker=head.request.ranker,
                trace=head.request.trace,
            )
            self.metrics.inc("sched_search_batches_total")
            self.metrics.observe("sched_search_batch_nq", combined.nq)
            try:
                batch_res = self.proxy.search(
                    head.info, combined, guarantee=guarantee,
                    wait_fn=wait_fn, hedge_timeout_s=hedge_timeout_s,
                )
            except Exception as exc:
                for i in idxs:
                    tickets[i]._error = exc
                    tickets[i]._event.set()
                continue
            row = 0
            for i in idxs:
                n_i = tickets[i].request.nq
                sliced = SearchResult(
                    batch_res.scores[row : row + n_i],
                    batch_res.pks[row : row + n_i],
                    batch_res.query_ts,
                    batch_res.waited_ms,
                    fields=(
                        None
                        if batch_res.fields is None
                        else {
                            f: v[row : row + n_i]
                            for f, v in batch_res.fields.items()
                        }
                    ),
                    trace=batch_res.trace,
                )
                results[i] = sliced
                tickets[i]._result = sliced
                tickets[i]._event.set()
                row += n_i
        for t in tickets:
            if not t._event.is_set():  # unreachable guard: never hang a caller
                t._error = RuntimeError("search ticket dropped by flush_reads")
                t._event.set()
        return results


class BatchingProxy:
    """Request batching (paper §3.6) — a thin facade over the scheduler's
    read micro-batching stage.  The legacy ``submit(info, query, k,
    guarantee)`` tuple surface survives unchanged; ``submit_request`` is
    the typed surface (filters / output_fields / hybrid all batch)."""

    def __init__(self, proxy, max_batch: int = 64, scheduler=None):
        self.proxy = proxy
        self.max_batch = max_batch
        self.scheduler = scheduler if scheduler is not None else RequestScheduler(proxy)
        self._tickets: list[SearchTicket] = []

    def submit(self, info, query, k: int, guarantee: GuaranteeTs) -> int:
        request = SearchRequest.single(query, field=None, k=k)
        return self.submit_request(info, request, guarantee=guarantee)

    def submit_request(
        self, info, request: SearchRequest, guarantee: GuaranteeTs | None = None
    ) -> int:
        self._tickets.append(
            self.scheduler.submit_search(info, request, guarantee=guarantee)
        )
        return len(self._tickets) - 1

    def flush(self, wait_fn=None, hedge_timeout_s: float | None = None) -> list:
        self.scheduler.flush_reads(wait_fn=wait_fn, hedge_timeout_s=hedge_timeout_s)
        out = [t.result() for t in self._tickets]
        self._tickets.clear()
        return out
