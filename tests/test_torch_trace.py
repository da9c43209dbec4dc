"""The port's request tracing and its device counters.

Spans sit on ``torch.profiler``'s host clock and nest inside their parents
(the root covers the whole ``Proxy.search``, the global merge included);
``serve_wait`` shows the time a dispatch waited for its node's serve lock;
``query_node_rows_scanned_total`` is counted on the device and read back
only when the registry is read.  Once a node's tombstone set is cached,
nothing on an untraced, unfiltered request's path reads the card back:
on the CPU the planner runs with every readback refused, and the cases
marked ``cuda`` run the whole ``search_request`` on the card under
``torch.cuda.set_sync_debug_mode("error")`` (they skip without a GPU; on
the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_trace.py``).
"""

import contextlib
import threading
import time

import numpy as np
import pytest
from _index_families import FAMILIES

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402
from repro_torch.core import ConsistencyLevel, GuaranteeTs, SearchRequest  # noqa: E402
from repro_torch.core.query_node import QueryNode  # noqa: E402
from repro_torch.core.request import AnnsQuery, NodeSearchRequest  # noqa: E402
from repro_torch.core.telemetry import TraceContext  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

DIM, K = 32, 10
TOMBSTONE_SETS = "query_node_tombstone_set_total"
CONFIG = dict(num_query_nodes=2, num_index_nodes=1, seal_rows=400, slice_rows=4_096,
              ingest_queue_rows=512, ingest_flush_rows=1_024)


def _collection(manu, seed: int = 7):
    """Two sealed FLAT segments, a growing tail, 5% of pks deleted; COSINE."""
    coll = manu.create_collection("t", dim=DIM, metric=port.Metric.COSINE)
    coll.create_index("vector", "flat", {})
    rng = np.random.default_rng(seed)
    coll.insert({"vector": rng.standard_normal((800, DIM)).astype(np.float32)})
    coll.flush()
    coll.insert({"vector": rng.standard_normal((150, DIM)).astype(np.float32)})
    coll.delete(np.arange(0, 950, 20))
    return coll, rng.standard_normal((8, DIM)).astype(np.float32)


def _node_request(device, drop_segment: bool = False):
    """A cooperative system on ``device``, one of its query nodes (sealed
    and growing rows, tombstones) and an untraced request to it.  With
    ``drop_segment`` every row of one of the node's sealed segments is
    deleted too, so the node plans a unit with no visible row."""
    manu = port.ManuSystem(port.ManuConfig(**CONFIG), device=device)
    coll, q = _collection(manu)
    manu.run_until_idle()
    node = next(n for n in manu.query_nodes.values() if n.growing and n.sealed)
    if drop_segment:
        coll.delete(next(iter(node.sealed.values())).segment.pks().cpu().numpy())
        manu.run_until_idle()
    request = NodeSearchRequest(
        collection="t", k=K, metric=port.Metric.COSINE,
        guarantee=GuaranteeTs(query_ts=manu.tso.next(), staleness_ms=float("inf")),
        anns=[AnnsQuery("vector", torch.from_numpy(q).to(device))],
    )
    return manu, node, request


def _end(span) -> float:
    return span.start_ns + span.duration_us * 1e3


def test_span_lies_within_the_profiler_range_it_was_opened_in():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            ctx = TraceContext("search")
            time.sleep(0.002)
            with ctx.timed(ctx.span("inner")) as span:
                time.sleep(0.005)
            time.sleep(0.002)
    outer = next(e for e in prof.profiler.kineto_results.events() if e.name() == "outer")
    assert outer.start_ns() <= span.start_ns
    assert _end(span) <= outer.start_ns() + outer.duration_ns()
    assert span.device_us is None  # no card: host time only


def test_threaded_search_spans_nest_and_the_root_covers_the_merge():
    manu = port.ManuSystem(port.ManuConfig(**CONFIG, threaded=True, manual_clock=False), device="cpu")
    try:
        coll, q = _collection(manu)
        res = coll.search(SearchRequest.single(
            q, k=K, consistency=ConsistencyLevel.STRONG, trace=True, output_fields=("pk",)))
    finally:
        manu.stop_threads()
    root = res.trace.root

    def check(parent):
        for child in parent.children:
            assert parent.start_ns <= child.start_ns, (parent.name, child.name)
            assert _end(child) <= _end(parent) + 1, (parent.name, child.name)
            check(child)

    check(root)
    names = {s.name for s in res.trace.walk()}
    assert {"consistency_wait", "dispatch", "serve_wait", "doomed_pks", "plan_search",
            "node_merge_topk", "merge_topk", "fetch_fields"} <= names
    assert any(n.startswith("scan_") for n in names)
    for d in res.trace.spans_named("dispatch"):
        assert d.children[0].name == "serve_wait"
    merge = res.trace.spans_named("merge_topk")[0]
    assert merge in root.children and _end(merge) <= _end(root)
    assert res.waited_ms * 1e3 < root.duration_us
    assert res.trace.to_dict()["root"]["start_ns"] == root.start_ns
    assert "serve_wait" in res.trace.format()


def test_serve_wait_reads_the_time_another_thread_held_the_lock():
    manu, node, request = _node_request("cpu")
    ctx = TraceContext("search")
    request.trace = (ctx, ctx.root)
    held, released = threading.Event(), {}

    def hold():
        with node._serve_lock:
            held.set()
            time.sleep(0.05)
            released["t"] = time.perf_counter()

    holder = threading.Thread(target=hold)
    holder.start()
    assert held.wait(10)
    t_call = time.perf_counter()
    node.search_request(request)
    holder.join(10)
    assert not holder.is_alive()
    (wait,) = [s for s in ctx.root.children if s.name == "serve_wait"]
    assert wait.duration_us >= (released["t"] - t_call) * 1e6
    assert wait.node_id == node.node_id


def test_rows_scanned_counter_reads_the_masks_sum():
    manu, node, request = _node_request("cpu")
    plan = node.plan_search("t", request.guarantee.query_ts, metric=port.Metric.COSINE, k=K)
    want = {
        "indexed": sum(int(u.mask.sum()) for u in plan.indexed),
        "brute_tail": sum(int(u.mask.sum()) for u in plan.brute_tail),
    }
    assert all(want.values())
    name = "query_node_rows_scanned_total"
    before = {c: node.metrics.counter_value(name, {"class": c}) for c in want}
    for _ in range(2):
        node.search_request(request)
    for c, rows in want.items():
        assert node.metrics.counter_value(name, {"class": c}) == before[c] + 2 * rows
        # Read once, folded once: a second read adds nothing.
        assert node.metrics.counter_value(name, {"class": c}) == before[c] + 2 * rows
    assert f'{name}{{class="indexed"}} {before["indexed"] + 2 * want["indexed"]:g}' in manu.export_metrics()


def test_pump_round_and_step_phases_are_exported():
    manu = port.ManuSystem(port.ManuConfig(**CONFIG, threaded=True, manual_clock=False), device="cpu")
    try:
        _collection(manu)
        manu.wait_idle()
    finally:
        manu.stop_threads()
    text = manu.export_metrics()
    for series in ("pump_round_us_count", 'query_node_step_us{phase="drain"}_count',
                   'query_node_step_us{phase="slice_index"}_count'):
        assert series in text
    assert "query_node_scan_us" not in text


class _NoReadback(TorchDispatchMode):
    """Refuses every operator that reads a device value back to the host
    (on the card each waits for the stream), also where C++ calls it, and
    an index by a boolean mask (on the card it counts the mask first)."""

    REFUSED = {"_local_scalar_dense", "nonzero", "masked_select", "equal", "is_nonzero",
               "_unique2", "unique_consecutive", "unique_dim", "repeat_interleave"}
    INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.REFUSED or (name in self.INDEXING and any(
            torch.is_tensor(i) and i.dtype == torch.bool for i in args[1] if i is not None
        )):
            raise AssertionError(f"read back: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_readback(monkeypatch):
    def refuse(*_args, **_kwargs):
        raise AssertionError("read back")

    with monkeypatch.context() as patch:
        for name in ("__bool__", "item", "nonzero", "tolist", "__int__", "__float__"):
            patch.setattr(torch.Tensor, name, refuse)
        with _NoReadback():
            yield


def _plan_view(plan):
    return {
        cls: [(u.segment_id, u.pks, u.mask, u.index, u.vectors) for u in getattr(plan, cls)]
        for cls in ("indexed", "brute_sealed", "growing_slice", "brute_tail")
    }


@pytest.mark.parametrize("drop_segment", [False, True], ids=["tombstones", "dead_unit"])
def test_unfiltered_planner_reads_nothing_back(monkeypatch, drop_segment):
    manu, node, request = _node_request("cpu", drop_segment)
    ts = request.guarantee.query_ts
    plan_kw = dict(metric=port.Metric.COSINE, k=K)
    want_doomed, _ = node._request_doomed_pks("t", ts)  # fills the tombstone cache
    want_plan = _plan_view(node.plan_search("t", ts, doomed=want_doomed, **plan_kw))
    hits = node.metrics.counter_value(TOMBSTONE_SETS, {"outcome": "hit"})
    with _no_readback(monkeypatch):
        doomed, outcome = node._request_doomed_pks("t", ts)
        plan = _plan_view(node.plan_search("t", ts, doomed=doomed, **plan_kw))
    assert outcome == "hit"
    assert node.metrics.counter_value(TOMBSTONE_SETS, {"outcome": "hit"}) == hits + 1
    assert all(torch.equal(a, b) for a, b in zip(doomed, want_doomed))
    assert plan.keys() == want_plan.keys()
    for cls, units in plan.items():
        assert len(units) == len(want_plan[cls]), cls
        for got, want in zip(units, want_plan[cls]):
            assert got[0] == want[0] and got[3] is want[3]
            for a, b in ((got[1], want[1]), (got[2], want[2]), (got[4], want[4])):
                assert (a is None and b is None) or torch.equal(a, b)
    assert plan["indexed"] and plan["brute_tail"]
    if drop_segment:
        assert any(not bool(m.any()) for _sid, _p, m, _i, _v in plan["indexed"])


def test_refused_readbacks_are_refused(monkeypatch):
    x = torch.arange(4)
    with _no_readback(monkeypatch):
        for read in (lambda: bool(x.any()), lambda: x[x > 1], lambda: int(x.sum()),
                     lambda: x.max().item()):
            with pytest.raises(AssertionError, match="read back"):
                read()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("metric", [port.Metric.L2, port.Metric.IP], ids=["l2", "ip"])
def test_unit_with_every_row_masked_adds_only_empty_slots(device, family, metric):
    """What the planner relies on when it scans a unit it cannot know is
    empty: every index family's scan, on the device's own kernels, gives
    ``(fill, -1)`` in each slot of a unit whose mask is all false."""
    from repro_torch.core.log import LogBroker
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.core.query_node import ScanUnit, SearchPlan
    from repro_torch.index.base import IndexSpec
    from repro_torch.index.registry import create_index

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    rows = torch.from_numpy(rng.standard_normal((256, DIM)).astype(np.float32)).to(device)
    queries = torch.from_numpy(rng.standard_normal((5, DIM)).astype(np.float32)).to(device)
    cls, spec = FAMILIES[family]
    unit = ScanUnit(3, torch.arange(256, device=device),
                    torch.zeros(256, dtype=torch.bool, device=device), vectors=rows)
    if spec is not None:
        unit.index = create_index(IndexSpec(spec[0], metric, spec[1]), device=device)
        unit.index.build(rows)
    node = QueryNode("qn", LogBroker(), MemoryObjectStore(), device=device)
    pool_s, pool_p = node._execute_plan(SearchPlan(**{cls: [unit]}), queries, K, metric)
    fill = float("inf") if metric is port.Metric.L2 else float("-inf")
    assert len(pool_s) == 1 and pool_s[0].shape[0] == 5
    assert bool((pool_p[0] == -1).all()) and bool((pool_s[0] == fill).all())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("drop_segment", [False, True], ids=["tombstones", "dead_unit"])
def test_untraced_search_never_waits_for_the_card(dev, drop_segment):
    manu, node, request = _node_request(dev, drop_segment)
    dead = next(iter(node.sealed.values())).segment.segment_id if drop_segment else None
    assert node.delta_deletes["t"]
    want = node.search_request(request)  # builds the kernels, fills the caches
    torch.cuda.synchronize()
    hits = node.metrics.counter_value(TOMBSTONE_SETS, {"outcome": "hit"})
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = node.search_request(request)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0][1], want[0][1]) and torch.equal(got[0][0], want[0][0])
    assert node.metrics.counter_value(TOMBSTONE_SETS, {"outcome": "hit"}) == hits + 1
    ctx = TraceContext("search")
    request.trace = (ctx, ctx.root)
    node.search_request(request)
    (doomed,) = [s for s in ctx.root.children if s.name == "doomed_pks"]
    assert doomed.detail == "hit"
    scans = [s for s in ctx.root.children if s.name.startswith("scan_")]
    assert scans and all(s.device_us is not None and s.device_us > 0 for s in scans)
    # Every class scans rows, except the one whose only unit is the dead one.
    dead_scans = [s for s in scans if tuple(s.segment_ids) == (dead,)]
    live_scans = [s for s in scans if tuple(s.segment_ids) != (dead,)]
    assert len(dead_scans) == int(drop_segment) and live_scans
    assert all(s.rows_scanned == 0 for s in dead_scans)
    assert all(s.rows_scanned > 0 for s in live_scans)
