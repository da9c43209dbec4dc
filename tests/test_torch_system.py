"""The system facade end to end on the CPU: the seeded
``examples/quickstart.py`` workload, cut to 2,000 rows at dims 32 / 16,
through ``repro``'s and the port's ``ManuSystem``.  Every request must
return the same pks under STRONG, BOUNDED and EVENTUAL, after deletes and
an upsert, under time travel, for weighted and RRF hybrid search, for a
filtered range search under each ``filter_strategy``, after partition
pruning and node scale-up / scale-down, with equal hydrated fields.  Scores
within rtol=1e-5, atol=1e-4 (two float32 expansions of one distance).

Also: async ingest rejects at the same request in both packages, batched
reads give the per-request answers, an IVF-SQ collection equals the port's
float64 oracle over what its query nodes hold, and threaded mode needs the
wall clock."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch import testing  # noqa: E402

ROWS, DIM, IMG_DIM = 2_000, 32, 16
CONFIG = dict(num_query_nodes=2, num_index_nodes=1, seal_rows=500, slice_rows=256,
              ingest_queue_rows=512, ingest_flush_rows=1_024)
RTOL, ATOL = 1e-5, 1e-4


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _system(pkg, **config):
    kw = {"device": "cpu"} if pkg is port else {}
    return pkg.ManuSystem(pkg.ManuConfig(**{**CONFIG, **config}), **kw)


def _quickstart(pkg) -> dict:
    """The quickstart's scenes in order; returns every SearchResult."""
    manu = _system(pkg)
    coll = manu.create_collection(
        "products", dim=DIM, metric=pkg.Metric.L2,
        extra_fields=[pkg.FieldSchema("img_vec", pkg.FieldType.VECTOR, dim=IMG_DIM),
                      pkg.FieldSchema("price", pkg.FieldType.FLOAT)],
    )
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 8, "nprobe": 8})
    coll.create_index("img_vec", kind="ivf_flat", params={"nlist": 4, "nprobe": 4})
    rng = np.random.default_rng(0)
    text = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    img = rng.standard_normal((ROWS, IMG_DIM)).astype(np.float32)
    prices = rng.uniform(1, 500, ROWS)
    for lo in range(0, ROWS, 400):
        coll.insert({"vector": text[lo:lo + 400], "img_vec": img[lo:lo + 400],
                     "price": prices[lo:lo + 400]})
    tq = rng.standard_normal((3, DIM)).astype(np.float32)
    iq = rng.standard_normal((3, IMG_DIM)).astype(np.float32)
    out = {}
    out["strong"] = coll.search(pkg.SearchRequest.single(tq, k=5, consistency=pkg.ConsistencyLevel.STRONG))
    out["bounded"] = coll.search(pkg.SearchRequest.single(tq, k=5, consistency=pkg.ConsistencyLevel.BOUNDED))
    out["staleness_100ms"] = coll.search(pkg.SearchRequest.single(tq, k=5, staleness_ms=100.0))
    out["eventual"] = coll.search(pkg.SearchRequest.single(tq, k=5))
    out["hybrid_weighted"] = coll.search(pkg.SearchRequest(
        anns=[pkg.AnnsQuery("vector", tq, weight=0.7), pkg.AnnsQuery("img_vec", iq, weight=0.3)],
        k=5, staleness_ms=0.0, output_fields=("price", "img_vec"),
    ))
    out["hybrid_rrf"] = coll.hybrid_search(
        [pkg.AnnsQuery("vector", tq), pkg.AnnsQuery("img_vec", iq)],
        limit=5, ranker=pkg.Ranker.rrf(), staleness_ms=0.0,
    )
    radius = float(np.sort(_np(out["strong"].scores)[0])[-1]) * 1.2
    for strategy in (None, "pre", "post", "brute"):
        out[f"filtered_range_{strategy}"] = coll.search(pkg.SearchRequest.single(
            tq, k=10, staleness_ms=0.0, filter="price < 50", radius=radius,
            filter_strategy=strategy, output_fields=("price",),
        ))
    victims = _np(out["strong"].pks)[0][:2]
    coll.delete(victims)
    out["after_delete"] = coll.search(tq, limit=5, staleness_ms=0.0)
    out["time_travel"] = coll.search(tq, limit=5, time_travel_ts=out["strong"].query_ts)
    target = int(_np(out["after_delete"].pks)[0][0])
    res = coll.upsert({
        "pk": np.array([target]),
        "vector": rng.standard_normal((1, DIM)).astype(np.float32),
        "img_vec": rng.standard_normal((1, IMG_DIM)).astype(np.float32),
        "price": np.array([9.99]),
    })
    out["session_after_upsert"] = coll.search(res.session_request(tq, k=5, output_fields=("pk", "price")))
    out["before_upsert"] = coll.search(tq, limit=5, time_travel_ts=res.watermark_ts - 1)
    coll.flush()
    out["after_flush"] = coll.search(tq, limit=5, staleness_ms=0.0)
    manu.add_query_node()
    out["three_nodes"] = coll.search(tq, limit=5, staleness_ms=0.0, output_fields=("price",))
    manu.remove_query_node()
    out["scaled_back"] = coll.search(tq, limit=5, staleness_ms=0.0)

    catalog = manu.create_collection("catalog", dim=16, seal_rows=500)
    for season in ("summer", "winter"):
        catalog.create_partition(season)
    catalog.insert(pkg.InsertRequest({"vector": rng.standard_normal((600, 16)).astype(np.float32)},
                                     partition="summer"))
    catalog.insert(pkg.InsertRequest({"vector": rng.standard_normal((600, 16)).astype(np.float32)},
                                     partition="winter"))
    catalog.flush()
    cq = rng.standard_normal((2, 16)).astype(np.float32)
    out["partitions_all"] = catalog.search(cq, limit=5, staleness_ms=0.0)
    out["partition_summer"] = catalog.search(pkg.SearchRequest.single(
        cq, k=5, staleness_ms=0.0, partition_names=("summer",)))
    catalog.drop_partition("winter")
    out["winter_dropped"] = catalog.search(cq, limit=5, staleness_ms=0.0)
    info = {
        "sealed": manu.data_coord.sealed_segments("products"),
        "num_entities": coll.num_entities(),
        "catalog_entities": catalog.num_entities(),
        "partitions": catalog.partitions(),
        "placement": [(p.collection, p.segment_id, p.replicas) for p in manu.cluster_state().placement],
        "nodes": {n: (qn.held_segments("products"), qn.watermark("products"), qn.memory_rows(),
                      qn.alive) for n, qn in manu.query_nodes.items()},
        "describe": coll.describe(),
    }
    return {"results": out, "info": info, "manu": manu}


@pytest.fixture(scope="module")
def runs():
    return {"ref": _quickstart(ref), "port": _quickstart(port)}


RESULTS = (
    "strong", "bounded", "staleness_100ms", "eventual", "hybrid_weighted", "hybrid_rrf",
    "filtered_range_None", "filtered_range_pre", "filtered_range_post", "filtered_range_brute",
    "after_delete", "time_travel", "session_after_upsert", "before_upsert", "after_flush",
    "three_nodes", "scaled_back", "partitions_all", "partition_summer", "winter_dropped",
)


@pytest.mark.parametrize("name", RESULTS)
def test_quickstart_answers_match_reference(runs, name):
    got, want = runs["port"]["results"][name], runs["ref"]["results"][name]
    assert torch.is_tensor(got.pks) and got.pks.dtype == torch.int64
    np.testing.assert_array_equal(_np(got.pks), _np(want.pks))
    gs, ws = _np(got.scores), _np(want.scores)
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    assert got.query_ts == want.query_ts
    assert (got.fields is None) == (want.fields is None)
    for f, vals in (want.fields or {}).items():
        np.testing.assert_array_equal(got.fields[f], vals)


def test_quickstart_state_matches_reference(runs):
    got, want = runs["port"]["info"], runs["ref"]["info"]
    for key in ("sealed", "num_entities", "catalog_entities", "partitions", "placement", "nodes"):
        assert got[key] == want[key], key
    gd, wd = got["describe"], want["describe"]
    assert (gd.num_entities, gd.num_shards, gd.partitions) == (wd.num_entities, wd.num_shards, wd.partitions)
    assert [(ix.field, ix.kind, ix.params) for ix in gd.indexes] == [
        (ix.field, ix.kind, ix.params) for ix in wd.indexes
    ]


def test_quickstart_deletes_and_time_travel(runs):
    out = runs["port"]["results"]
    victims = out["strong"].pks[0][:2]
    assert not torch.isin(victims, out["after_delete"].pks[0]).any()
    assert torch.isin(victims, out["time_travel"].pks[0]).all()


def test_metrics_events_and_stats_surfaces(runs):
    manu = runs["port"]["manu"]
    snap = manu.metrics()
    assert snap.counter('proxy_searches_total') > 0
    assert snap.to_dict()["histograms"]
    assert "proxy_searches_total" in manu.export_metrics()
    assert manu.events(kind="index_built")
    stats = manu.stats()
    assert stats["index_builds"] > 0 and set(stats["query_nodes"]) == set(manu.query_nodes)
    assert manu.cluster_state().under_replicated == 0


def _async_ingest(pkg):
    manu = _system(pkg)
    jobs = manu.create_collection("jobs", dim=16, extra_fields=[pkg.FieldSchema("price", pkg.FieldType.FLOAT)])
    rng = np.random.default_rng(7)
    tickets, rejected = [], []
    for i in range(6):
        chunk = {"vector": rng.standard_normal((200, 16)).astype(np.float32),
                 "price": rng.uniform(1, 100, 200)}
        try:
            tickets.append(jobs.insert_async(chunk))
        except pkg.AdmissionRejected as e:
            rejected.append((i, e.pending_rows, e.capacity_rows, e.shard))
            manu.flush_ingest()
            tickets.append(jobs.insert_async(chunk))
    manu.flush_ingest()
    lsns = [t.result().watermark_ts for t in tickets]
    q = rng.standard_normal((3, 16)).astype(np.float32)
    batched = [manu.batcher.submit_request(jobs.info, pkg.SearchRequest.single(
        q[i:i + 1], field="vector", k=3, staleness_ms=0.0, filter="price < 50",
        output_fields=("price",))) for i in range(3)]
    bounded = manu.batcher.submit_request(jobs.info, pkg.SearchRequest.single(
        q[:1], field="vector", k=3, consistency=pkg.ConsistencyLevel.BOUNDED))
    res = manu.batcher.flush(wait_fn=manu._cooperative_wait)
    single = [jobs.search(pkg.SearchRequest.single(
        q[i:i + 1], field="vector", k=3, staleness_ms=0.0, filter="price < 50",
        output_fields=("price",))) for i in range(3)]
    return {"rejected": rejected, "lsns": lsns, "batched": [res[i] for i in batched],
            "bounded": res[bounded], "single": single,
            "batches": manu.metrics().counter("logger_batches_total")}


def test_async_ingest_and_batched_reads_match_reference():
    got, want = _async_ingest(port), _async_ingest(ref)
    assert got["rejected"] and got["rejected"] == want["rejected"]
    assert got["lsns"] == want["lsns"] and len(set(got["lsns"])) == len(got["lsns"])
    assert got["batches"] == want["batches"]
    for g, w, s in zip(got["batched"], want["batched"], got["single"]):
        np.testing.assert_array_equal(_np(g.pks), _np(w.pks))
        np.testing.assert_array_equal(_np(g.pks), _np(s.pks))  # a batch answers per request
        np.testing.assert_array_equal(g.fields["price"], s.fields["price"])
    np.testing.assert_array_equal(_np(got["bounded"].pks), _np(want["bounded"].pks))


def _passes_at_least(lo):
    return lambda seg: torch.from_numpy(np.asarray(seg.extra("ordinal")) >= lo)


def test_ivf_sq_collection_matches_port_oracle():
    """An IVF-SQ collection (sealed through flush, streamed growing rows
    with interim slice indexes, deletes), held to the float64 oracle over
    what its two query nodes hold, at every consistency level, filtered,
    and under time travel."""
    manu = _system(port, seal_rows=600, slice_rows=128)
    coll = manu.create_collection("vdb", dim=DIM, extra_fields=[port.FieldSchema("ordinal", port.FieldType.INT)])
    coll.create_index("vector", "ivf_sq", {"nlist": 8, "nprobe": 3})
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((16, DIM)).astype(np.float32)
    n = 2_600
    x = (centers[rng.integers(0, 16, n)] + 0.5 * rng.standard_normal((n, DIM))).astype(np.float32)
    for lo in range(0, 2_000, 500):
        res = coll.insert(port.InsertRequest({"vector": x[lo:lo + 500], "ordinal": np.arange(lo, lo + 500)}))
        assert np.array_equal(res.pks, np.arange(lo, lo + 500))
    coll.flush()
    for lo in range(2_000, n, 300):
        stream = coll.insert(port.InsertRequest({"vector": x[lo:lo + 300], "ordinal": np.arange(lo, lo + 300)}))
    doomed = rng.choice(n, 60, replace=False)
    coll.delete(doomed)
    assert coll.num_entities() == n
    q = torch.from_numpy((centers[rng.integers(0, 16, 5)] + 0.5 * rng.standard_normal((5, DIM))).astype(np.float32))
    nodes = list(manu.query_nodes.values())
    rtol, atol = testing.SCORE_TOL["l2"]
    cases = {
        "strong": (dict(consistency=port.ConsistencyLevel.STRONG), None),
        "bounded": (dict(consistency=port.ConsistencyLevel.BOUNDED), None),
        "eventual": (dict(consistency=port.ConsistencyLevel.EVENTUAL), None),
        "filter_99": (dict(staleness_ms=0.0, filter="ordinal >= 26"), 26),
        "filter_1": (dict(staleness_ms=0.0, filter="ordinal >= 2574"), 2574),
        "time_travel": (dict(time_travel_ts=stream.watermark_ts, output_fields=("ordinal",)), None),
    }
    sq_before = sum(1 for node in nodes for h in node.sealed.values() if h.index.KIND == "ivf_sq")
    assert sq_before == 4
    for label, (kw, lo) in cases.items():
        got = coll.search(port.SearchRequest.single(q, k=20, **kw))
        deleted = None if label == "time_travel" else torch.from_numpy(doomed)
        oracle = testing.system_oracle(nodes, "vdb", q, 20, got.query_ts, deleted,
                                       None if lo is None else _passes_at_least(lo))
        testing.assert_oracle_answer(label, (got.scores, got.pks), oracle, rtol, atol)
        if label == "time_travel":
            assert torch.isin(got.pks, torch.from_numpy(doomed)).any()
            live = got.pks >= 0
            np.testing.assert_array_equal(got.fields["ordinal"][live.numpy()], got.pks[live].numpy())
        else:
            assert not torch.isin(got.pks, torch.from_numpy(doomed)).any()
    assert any(seg.slice_indexes for node in nodes for seg in node.growing.values())


@pytest.mark.parametrize("kwargs", [{"config": "threaded"}])
def test_unported_modes_raise(kwargs):
    """Threaded mode is ported; it runs on the wall clock only, and a
    manual clock (the default) raises instead of hanging every wait."""
    threaded = kwargs.pop("config", None) == "threaded"
    with pytest.raises(ValueError, match="wall clock"):
        port.ManuSystem(port.ManuConfig(threaded=threaded), device="cpu", **kwargs)
    manu = port.ManuSystem(port.ManuConfig(threaded=threaded, manual_clock=False),
                           device="cpu", **kwargs)
    assert [t.name for t in manu._threads] == ["manu-pump", "manu-build", "manu-watchdog"]
    manu.stop_threads()
    assert not manu._threads


def _hedged(pkg):
    manu = _system(pkg, replication_factor=2)
    coll = manu.create_collection("h", dim=16)
    rng = np.random.default_rng(13)
    coll.insert({"vector": rng.standard_normal((1_200, 16)).astype(np.float32)})
    coll.flush()
    coll.insert({"vector": rng.standard_normal((100, 16)).astype(np.float32)})
    q = rng.standard_normal((4, 16)).astype(np.float32)
    plain = coll.search(q, limit=10, staleness_ms=0.0)
    # A zero timeout makes every dispatch a straggler: each sealed unit is
    # re-dispatched to its other replica (the dispatch runs on a thread).
    hedged = coll.search(q, limit=10, staleness_ms=0.0, hedge_timeout_s=0.0)
    return plain, hedged, manu.metrics().counter("proxy_hedges_total")


def test_hedged_search_matches_unhedged_and_reference():
    plain, hedged, hedges = _hedged(port)
    ref_plain, ref_hedged, _ = _hedged(ref)
    assert hedges > 0
    np.testing.assert_array_equal(_np(hedged.pks), _np(plain.pks))
    np.testing.assert_array_equal(_np(plain.pks), _np(ref_plain.pks))
    np.testing.assert_array_equal(_np(hedged.pks), _np(ref_hedged.pks))
