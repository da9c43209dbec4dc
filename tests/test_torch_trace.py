"""The port's request tracing and its device counters.

Spans sit on ``torch.profiler``'s host clock and nest inside their parents
(the root covers the whole ``Proxy.search``, the global merge included);
``serve_wait`` shows the time a dispatch waited for its node's serve lock;
``query_node_rows_scanned_total`` is counted on the device and read back
only when the registry is read.  The case marked ``cuda`` runs an untraced
FLAT ``search_request`` on the card under
``torch.cuda.set_sync_debug_mode("error")``: outside the planner (its
visibility readbacks decide which units to scan) nothing on the request's
path waits for the card.  It skips without a GPU; on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py``.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402
from repro_torch.core import ConsistencyLevel, GuaranteeTs, SearchRequest  # noqa: E402
from repro_torch.core.query_node import QueryNode  # noqa: E402
from repro_torch.core.request import AnnsQuery, NodeSearchRequest  # noqa: E402
from repro_torch.core.telemetry import TraceContext  # noqa: E402

DIM, K = 32, 10
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


def _node_request(device):
    """A cooperative system on ``device``, one of its query nodes (sealed
    and growing rows, tombstones) and an untraced request to it."""
    manu = port.ManuSystem(port.ManuConfig(**CONFIG), device=device)
    coll, q = _collection(manu)
    manu.run_until_idle()
    node = next(n for n in manu.query_nodes.values() if n.growing and n.sealed)
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


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_untraced_flat_search_waits_for_the_card_only_in_the_planner(dev, monkeypatch):
    manu, node, request = _node_request(dev)
    want = node.search_request(request)  # builds the kernels, fills the caches
    torch.cuda.synchronize()

    def unchecked(fn):
        def run(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return run

    # The planner reads the tombstone set's and each unit's visibility back
    # to decide what to scan; everything else must only enqueue.
    for name in ("plan_search", "_request_doomed_pks"):
        monkeypatch.setattr(QueryNode, name, unchecked(getattr(QueryNode, name)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = node.search_request(request)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0][1], want[0][1]) and torch.equal(got[0][0], want[0][0])
    ctx = TraceContext("search")
    request.trace = (ctx, ctx.root)
    node.search_request(request)
    scans = [s for s in ctx.root.children if s.name.startswith("scan_")]
    assert scans and all(s.device_us is not None and s.device_us > 0 for s in scans)
    assert all(s.rows_scanned > 0 for s in scans)
