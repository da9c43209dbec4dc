"""The slice as a whole, on the CPU: two query nodes built in both packages
from the same seeded LogEntry stream plus binlog-loaded sealed segments
(one FLAT-indexed), answering the same requests.  Node results and the
two-node global reduce are compared for L2, IP and cosine, pinned before
and after deletes and an upsert, with and without a filter.

Tolerance: scores rtol=1e-5, atol=1e-4; pks exact except at near-ties,
where the port's pk must score within the tolerance of the reference's
score at that slot."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.binlog as ref_binlog  # noqa: E402
import repro.core.log as ref_log  # noqa: E402
from repro.core.collection import Metric as RefMetric  # noqa: E402
from repro.core.consistency import GuaranteeTs as RefGuarantee  # noqa: E402
from repro.core.object_store import MemoryObjectStore as RefStore  # noqa: E402
from repro.core.query_node import QueryNode as RefNode  # noqa: E402
from repro.core.request import AnnsQuery as RefAnns  # noqa: E402
from repro.core.request import NodeSearchRequest as RefRequest  # noqa: E402
from repro.core.segment import Segment as RefSegment  # noqa: E402
from repro.index.attribute import FilterExpr as RefFilter  # noqa: E402
from repro.index.flat import FlatIndex as RefFlat  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import log  # noqa: E402
from repro_torch.core.collection import Metric  # noqa: E402
from repro_torch.core.consistency import GuaranteeTs  # noqa: E402
from repro_torch.core.object_store import MemoryObjectStore  # noqa: E402
from repro_torch.core.query_node import QueryNode  # noqa: E402
from repro_torch.core.request import AnnsQuery, NodeSearchRequest  # noqa: E402
from repro_torch.index.attribute import FilterExpr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DIM, K, NQ = 16, 10, 5
SEALED = {1: 70, 2: 45, 3: 60}  # segment id -> rows; segment 1 is FLAT-indexed
GROWING_SID, GROWING_ROWS = 4, 90
METRICS = ("l2", "ip", "cosine")
DELETED = np.array([1003, 1010, 2001, 3004, 4002, 4050])
UPSERTED = np.array([2005, 4007])
TS_SEALED, TS_GROW, TS_DEL, TS_UPS = 100, 200, 300, 310
PINS = (150, 250, 305, 400)


def _data():
    rng = np.random.default_rng(21)
    sealed = {
        sid: {
            "pk": np.arange(sid * 1000, sid * 1000 + n),
            "vector": rng.standard_normal((n, DIM)).astype(np.float32),
            "ts": np.full(n, TS_SEALED, np.int64),
            "price": rng.integers(0, 100, n),
        }
        for sid, n in SEALED.items()
    }
    grow_pk = np.arange(GROWING_SID * 1000, GROWING_SID * 1000 + GROWING_ROWS)
    grow_vec = rng.standard_normal((GROWING_ROWS, DIM)).astype(np.float32)
    grow_price = rng.integers(0, 100, GROWING_ROWS)
    ups_vec = rng.standard_normal((len(UPSERTED), DIM)).astype(np.float32)
    queries = rng.standard_normal((NQ, DIM)).astype(np.float32)
    return sealed, (grow_pk, grow_vec, grow_price), ups_vec, queries


def _publish(log_mod, broker, colls, grow, ups_vec):
    """The seeded WAL: growing inserts in three entries, a delete and an
    upsert, each mirrored as a coord tombstone broadcast."""
    pk, vec, price = grow
    for coll in colls:
        ch = log_mod.dml_channel(coll, 0)
        broker.create_channel(ch)
        for j, lo in enumerate((0, 30, 60)):
            sl = slice(lo, lo + 30)
            broker.publish(ch, log_mod.LogEntry(
                TS_GROW + j, log_mod.EntryType.INSERT,
                {"collection": coll, "segment_id": GROWING_SID, "shard": 0, "pk": pk[sl],
                 "vector": vec[sl], "extras": {"price": price[sl]}},
            ))
    for ts, etype in ((TS_DEL, log_mod.EntryType.DELETE), (TS_UPS, log_mod.EntryType.UPSERT)):
        for coll in colls:
            if etype is log_mod.EntryType.DELETE:
                payload = {"collection": coll, "pk": DELETED}
            else:
                payload = {"collection": coll, "segment_id": GROWING_SID, "shard": 0,
                           "pk": UPSERTED, "vector": ups_vec, "extras": {"price": np.array([1, 2])}}
            broker.publish(log_mod.dml_channel(coll, 0), log_mod.LogEntry(ts, etype, payload))
            broker.publish("coord", log_mod.LogEntry(
                ts, log_mod.EntryType.COORD,
                {"msg": "tombstones", "collection": coll, "pk": payload["pk"]},
            ))


def _ref_store():
    """Reference-written binlogs, FLAT index and one attr satellite."""
    sealed, grow, ups_vec, queries = _data()
    store = RefStore()
    for metric in METRICS:
        coll = f"c_{metric}"
        for sid, cols in sealed.items():
            seg = RefSegment(sid, coll, 0, DIM, extra_fields=("price",))
            seg.append(cols["pk"], cols["vector"], cols["ts"], {"price": cols["price"]})
            seg.seal()
            ref_binlog.write_segment_binlog(store, seg)
            if sid == 1:
                ref_binlog.write_attr_satellites(store, seg)
        idx = RefFlat(metric=RefMetric(metric))
        idx.build(sealed[1]["vector"])
        store.put(ref_binlog.index_key(coll, 1, "vector", "flat"), idx.save())
    return store, grow, ups_vec, queries


@pytest.fixture(scope="module")
def clusters():
    """(reference nodes, port nodes, queries): node a holds sealed 1-2,
    node b holds sealed 3 and the growing segment fed from the WAL."""
    ref_store, grow, ups_vec, queries = _ref_store()
    port_store = MemoryObjectStore()
    for meta in ref_store.list():
        port_store.put(meta.key, ref_store.get(meta.key))
    built = {}
    for name, log_mod, store, node_cls, kw in (
        ("ref", ref_log, ref_store, RefNode, {}),
        ("port", log, port_store, QueryNode, {"device": "cpu"}),
    ):
        broker = log_mod.LogBroker()
        broker.create_channel("coord")
        nodes = {
            n: node_cls(f"qn-{n}", broker, store, slice_rows=10_000, **kw) for n in ("a", "b")
        }
        for metric in METRICS:
            coll = f"c_{metric}"
            for sid in (1, 2):
                nodes["a"].load_sealed(coll, sid)
            nodes["a"].load_index(coll, 1, "flat", f"index/{coll}/1/vector/flat")
            nodes["b"].load_sealed(coll, 3)
        _publish(log_mod, broker, [f"c_{m}" for m in METRICS], grow, ups_vec)
        for metric in METRICS:
            nodes["b"].subscribe(log_mod.dml_channel(f"c_{metric}", 0))
        for node in nodes.values():
            node.step()
        built[name] = nodes
    return built["ref"], built["port"], queries


def _assert_close(got_s, got_p, want_s, want_p, pk_score):
    got_s, got_p = got_s.numpy(), got_p.numpy()
    np.testing.assert_array_equal(got_p < 0, want_p < 0)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=1e-5, atol=1e-4)
    for qi, j in zip(*np.nonzero(got_p != want_p)):
        np.testing.assert_allclose(pk_score(qi, got_p[qi, j]), want_s[qi, j], rtol=1e-5, atol=1e-4)


def _pk_scorer(queries, metric, upserted_vec):
    sealed, grow, _, _ = _data()
    vec = {int(p): v for c in sealed.values() for p, v in zip(c["pk"], c["vector"])}
    vec.update({int(p): v for p, v in zip(grow[0], grow[1])})
    if upserted_vec is not None:
        vec.update({int(p): v for p, v in zip(UPSERTED, upserted_vec)})

    def score(qi, pk):
        q, x = queries[qi].astype(np.float64), vec[int(pk)].astype(np.float64)
        if metric == "l2":
            return float(((q - x) ** 2).sum())
        if metric == "cosine":
            q, x = q / np.linalg.norm(q), x / np.linalg.norm(x)
        return float(q @ x)

    return score


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("ts", PINS)
@pytest.mark.parametrize("filt,strategy", [(None, None), ("price < 40", None),
                                           ("price >= 30", "post"), ("price < 60", "brute")])
def test_two_node_search_matches_reference(clusters, metric, ts, filt, strategy):
    ref_nodes, port_nodes, queries = clusters
    coll = f"c_{metric}"
    ups_vec = _data()[2]
    score = _pk_scorer(queries, metric, ups_vec if ts >= TS_UPS else None)
    mstr = "l2" if metric == "l2" else "ip"
    ref_parts, port_parts = [], []
    for n in ("a", "b"):
        want = ref_nodes[n].search_request(RefRequest(
            collection=coll, k=K, metric=RefMetric(metric),
            guarantee=RefGuarantee(query_ts=ts, staleness_ms=float("inf")),
            anns=[RefAnns("vector", queries)],
            filter=RefFilter(filt) if filt else None, filter_strategy=strategy,
        ))[0]
        got = port_nodes[n].search_request(NodeSearchRequest(
            collection=coll, k=K, metric=Metric(metric),
            guarantee=GuaranteeTs(query_ts=ts, staleness_ms=float("inf")),
            anns=[AnnsQuery("vector", queries)],
            filter=FilterExpr(filt) if filt else None, filter_strategy=strategy,
        ))[0]
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
        _assert_close(*got, *want, score)
        ref_parts.append(want)
        port_parts.append(got)
    want = ref_ops.merge_topk(
        np.concatenate([p[0] for p in ref_parts], 1), np.concatenate([p[1] for p in ref_parts], 1),
        K, metric=mstr,
    )
    got = ops.merge_topk(
        torch.cat([p[0] for p in port_parts], 1), torch.cat([p[1] for p in port_parts], 1),
        K, metric=mstr,
    )
    _assert_close(*got, *want, score)
    live = got[1].numpy()
    if ts >= TS_DEL:
        assert not np.isin(live, DELETED).any()
    if ts < TS_GROW:
        assert not (live // 1000 == GROWING_SID).any()


def test_node_state_matches_reference(clusters):
    ref_nodes, port_nodes, _ = clusters
    for n in ("a", "b"):
        assert port_nodes[n].delta_deletes == ref_nodes[n].delta_deletes
        assert sorted(port_nodes[n].growing) == sorted(ref_nodes[n].growing)
        for key, gs in ref_nodes[n].growing.items():
            seg = port_nodes[n].growing[key]
            for ts in PINS:
                np.testing.assert_array_equal(
                    seg.visible_mask(ts).numpy(), gs.segment.visible_mask(ts)
                )
    plan = port_nodes["a"].plan_search("c_l2", 400)
    assert [len(plan.indexed), len(plan.brute_sealed), len(plan.brute_tail)] == [1, 1, 0]
    plan = port_nodes["b"].plan_search("c_l2", 400)
    assert [len(plan.indexed), len(plan.brute_sealed), len(plan.brute_tail)] == [0, 1, 1]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("rows", [2048, 4096])
def test_post_filter_beyond_scan_k_limit_matches_reference(metric, rows):
    """A FLAT unit at ~70% filter selectivity: the reference post-filters at
    k + 30% of the rows.  Up to the scan kernel's k limit the port does the
    same; above it (4096 rows) it pre-filters and gives the same answer."""
    rng = np.random.default_rng(rows)
    cols = {
        "pk": np.arange(rows) + 50_000, "vector": rng.standard_normal((rows, DIM)).astype(np.float32),
        "ts": np.full(rows, TS_SEALED, np.int64), "price": rng.integers(0, 100, rows),
    }
    queries = rng.standard_normal((NQ, DIM)).astype(np.float32)
    ref_store = RefStore()
    seg = RefSegment(7, "big", 0, DIM, extra_fields=("price",))
    seg.append(cols["pk"], cols["vector"], cols["ts"], {"price": cols["price"]})
    seg.seal()
    ref_binlog.write_segment_binlog(ref_store, seg)
    idx = RefFlat(metric=RefMetric(metric))
    idx.build(cols["vector"])
    ref_store.put(ref_binlog.index_key("big", 7, "vector", "flat"), idx.save())
    port_store = MemoryObjectStore()
    for meta in ref_store.list():
        port_store.put(meta.key, ref_store.get(meta.key))
    ref_node = RefNode("qn", ref_log.LogBroker(), ref_store)
    node = QueryNode("qn", log.LogBroker(), port_store, device="cpu")
    for n in (ref_node, node):
        n.load_sealed("big", 7)
        n.load_index("big", 7, "flat", "index/big/7/vector/flat")
    filt = "price < 70"
    want = ref_node.search_request(RefRequest(
        collection="big", k=K, metric=RefMetric(metric),
        guarantee=RefGuarantee(query_ts=400, staleness_ms=float("inf")),
        anns=[RefAnns("vector", queries)], filter=RefFilter(filt),
    ))[0]
    got = node.search_request(NodeSearchRequest(
        collection="big", k=K, metric=Metric(metric),
        guarantee=GuaranteeTs(query_ts=400, staleness_ms=float("inf")),
        anns=[AnnsQuery("vector", queries)], filter=FilterExpr(filt),
    ))[0]
    vec = dict(zip(cols["pk"].tolist(), cols["vector"].astype(np.float64)))

    def score(qi, pk):
        q, x = queries[qi].astype(np.float64), vec[int(pk)]
        if metric == "l2":
            return float(((q - x) ** 2).sum())
        return float(q @ x / (np.linalg.norm(q) * np.linalg.norm(x)))

    _assert_close(*got, *want, score)
    assert (cols["price"][got[1].numpy() - 50_000] < 70).all()
    n_comb = int((cols["price"] < 70).sum())
    strategies = [
        n.plan_search("big", 400, metric=mt, filter=fx(filt), k=K).filter_info[0]["strategy"]
        for n, mt, fx in ((ref_node, RefMetric(metric), RefFilter), (node, Metric(metric), FilterExpr))
    ]
    assert strategies == ["post", "post" if K + rows - n_comb <= ops.MAX_SCAN_K else "pre"]
    assert (rows == 4096) == (strategies[1] == "pre")


def test_full_growing_slice_raises():
    """A full slice now gets its interim IVF-FLAT index, as in the
    reference.  What still raises is what raises there too: a slice whose
    rows are all equal leaves k-means++ seeding no row to draw (ValueError
    from numpy in both packages)."""
    for vectors, raises in ((np.random.default_rng(0).standard_normal((8, 4)), False),
                            (np.zeros((8, 4)), True)):
        nodes = []
        for log_mod, node_cls, kw in ((ref_log, RefNode, {}), (log, QueryNode, {"device": "cpu"})):
            broker = log_mod.LogBroker()
            node = node_cls("qn", broker, RefStore() if node_cls is RefNode else MemoryObjectStore(),
                            slice_rows=8, **kw)
            ch = log_mod.dml_channel("c", 0)
            broker.create_channel(ch)
            node.subscribe(ch)
            broker.publish(ch, log_mod.LogEntry(1, log_mod.EntryType.INSERT, {
                "collection": "c", "segment_id": 1, "shard": 0, "pk": np.arange(8),
                "vector": vectors.astype(np.float32),
            }))
            if raises:
                with pytest.raises(ValueError, match="Probabilities"):
                    node.step()
            else:
                assert node.step()
                nodes.append(node)
        if not raises:
            ref_idx = nodes[0].growing[("c", 1)].slice_index_built[0]
            port_idx = nodes[1].growing[("c", 1)].slice_indexes[0]
            assert port_idx.KIND == "ivf_flat" and port_idx.metric is Metric.L2
            np.testing.assert_array_equal(port_idx._state()["row_ids"], ref_idx.row_ids)


def test_traced_request_spans_match_reference(clusters):
    from repro.core.telemetry import TraceContext as RefTrace
    from repro_torch.core.telemetry import TraceContext

    ref_nodes, port_nodes, queries = clusters
    names = {}
    for name, nodes, trace_cls, req_cls, anns_cls, metric, guarantee, filt in (
        ("ref", ref_nodes, RefTrace, RefRequest, RefAnns, RefMetric.L2, RefGuarantee, RefFilter),
        ("port", port_nodes, TraceContext, NodeSearchRequest, AnnsQuery, Metric.L2, GuaranteeTs,
         FilterExpr),
    ):
        ctx = trace_cls("search")
        nodes["b"].search_request(req_cls(
            collection="c_l2", k=K, metric=metric,
            guarantee=guarantee(query_ts=400, staleness_ms=float("inf")),
            anns=[anns_cls("vector", queries)], filter=filt("price < 40"),
            trace=(ctx, ctx.root),
        ))
        names[name] = [(s.name, s.segment_ids, s.rows_scanned) for s in ctx.root.children]
    # The port's own spans, which the reference has not: the wait for the
    # node's serve lock and the tombstone set's materialization, first.
    port_only = ("serve_wait", "doomed_pks")
    assert [n for n, _, _ in names["port"][:2]] == list(port_only)
    assert [s for s in names["port"] if s[0] not in port_only] == names["ref"]
    assert [n for n, _, _ in names["port"]][-1] == "node_merge_topk"
