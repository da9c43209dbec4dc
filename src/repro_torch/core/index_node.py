"""Index nodes: asynchronous index builders (mirrors
``repro.core.index_node``).

An index node takes ``index_build_task`` messages from the coordination
channel, claims each with a meta-store CAS (so concurrent index nodes never
duplicate work), reads **only the vector column** of the binlog, builds the
index on its device, writes ``index.save()`` (the reference's ``.npz``
layout) to the object store and announces ``index_built`` with the
reference's payload.  A threaded ``ManuSystem`` steps its index nodes on a
thread of their own, so a build never holds up a pump round; the
announcement then takes the system's step lock (``publish_lock``), which
orders it against the coordinators' own messages.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .._device import resolve_device
from ..index.base import IndexSpec
from ..index.registry import create_index
from .binlog import index_key, read_binlog_column
from .collection import Metric
from .log import COORD_CHANNEL, EntryType, LogBroker, LogEntry, Subscription
from .meta_store import MetaStore
from .object_store import ObjectStore
from .telemetry import MetricsRegistry
from .timestamp import TSO


class IndexNode:
    def __init__(
        self,
        node_id: str,
        broker: LogBroker,
        store: ObjectStore,
        meta: MetaStore,
        tso: TSO,
        metrics: MetricsRegistry | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.node_id = node_id
        self.broker = broker
        self.store = store
        self.meta = meta
        self.tso = tso
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.sub = Subscription(broker, COORD_CHANNEL)
        self.alive = True
        self.builds_completed = 0
        # Held for the announcement: the coordination channel takes its
        # entries in timestamp order.
        self.publish_lock = contextlib.nullcontext()

    def step(self) -> bool:
        if not self.alive:
            return False
        progress = False
        for entry in self.sub.poll():
            if entry.type is not EntryType.COORD:
                continue
            p = entry.payload
            if p.get("msg") != "index_build_task":
                continue
            progress |= self._try_build(p)
        return progress

    def _try_build(self, task: dict) -> bool:
        coll = task["collection"]
        sid = task["segment_id"]
        kind = task["index_kind"]
        # Per-field builds: the task names the schema field and the binlog
        # column backing it (the first vector field is stored as "vector").
        field = task.get("field", "vector")
        column = task.get("column", field)
        # Replay safety: a task re-read after a crash may name a segment GC
        # already reclaimed -- nothing to build.
        if not self.store.exists(f"binlog/{coll}/{sid}/meta"):
            return False
        claim_key = f"index_claim/{coll}/{sid}/{field}/{kind}"
        if not self.meta.cas(claim_key, None, {"owner": self.node_id}):
            return False

        t0 = time.perf_counter()
        try:
            vectors = torch.from_numpy(read_binlog_column(self.store, coll, sid, column))
            spec = IndexSpec(
                kind=kind,
                metric=Metric(task.get("metric", "l2")),
                params=task.get("params") or {},
                field=field,
            )
            index = create_index(spec, device=self.device)
            index.build(vectors.to(self.device))
            key = index_key(coll, sid, field, kind)
            self.store.put(key, index.save())
        except Exception:
            # Release the claim so the task stays takeable.
            self.meta.delete(claim_key)
            raise
        self.builds_completed += 1
        self.metrics.observe(
            "index_build_us", (time.perf_counter() - t0) * 1e6, labels={"kind": kind}
        )
        self.metrics.inc("index_builds_total", labels={"kind": kind})
        if not self.alive:
            # Killed mid-build (threaded mode): like a crashed process it
            # announces nothing, and its claim waits for restart_index_node.
            return True

        with self.publish_lock:
            self.broker.publish(
                COORD_CHANNEL,
                LogEntry(
                    ts=self.tso.next(),
                    type=EntryType.COORD,
                    payload={
                        "msg": "index_built",
                        "collection": coll,
                        "segment_id": sid,
                        "field": field,
                        "column": column,
                        "index_kind": kind,
                        "index_key": key,
                        "built_by": self.node_id,
                    },
                ),
            )
        return True
