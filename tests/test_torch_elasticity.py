"""The elasticity control plane through the port's ``ManuSystem`` on the
CPU: the cases of ``tests/test_elasticity.py`` that kill a node or need
compaction -- a node dying between planning and scan, lease expiry with a
CAS race, a drain that keeps the MVCC pins of compacted segments -- and a
killed node recovered with ``recover_failures`` under replication, held to
``repro``'s answer (scores within ``SCORE_TOL["l2"]``, pks exact except at
near-ties)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch import testing  # noqa: E402

RTOL, ATOL = testing.SCORE_TOL["l2"]


def _system(pkg=port, **config):
    kw = {"device": "cpu"} if pkg is port else {}
    return pkg.ManuSystem(pkg.ManuConfig(**config), **kw)


def ingest(coll, rng, n, dim, batches=4):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    step = n // batches
    for i in range(batches):
        coll.insert({"vector": vecs[i * step : (i + 1) * step]})
    return vecs


def sorted_rows(res):
    pks, scores = np.asarray(res.pks), np.asarray(res.scores)
    order = np.argsort(pks, axis=1)
    return np.take_along_axis(pks, order, 1), np.take_along_axis(scores, order, 1)


def test_kill_node_mid_search_bit_for_bit():
    dim, n = 8, 900
    oracle_sys = _system(num_query_nodes=1, seal_rows=200, num_shards=2)
    system = _system(num_query_nodes=3, replication_factor=2, seal_rows=200, num_shards=2)
    o_coll = oracle_sys.create_collection("c", dim=dim)
    o_coll.create_index("vector", kind="flat")
    coll = system.create_collection("c", dim=dim)
    coll.create_index("vector", kind="flat")
    ingest(o_coll, np.random.default_rng(7), n, dim, batches=3)
    ingest(coll, np.random.default_rng(7), n, dim, batches=3)
    o_coll.flush()
    coll.flush()
    q = np.random.default_rng(9).standard_normal((4, dim)).astype(np.float32)
    oracle = o_coll.search(q, limit=10, staleness_ms=0.0)

    victim_id = next(n for n, st in system.query_coord.nodes.items() if st.segments)
    victim = system.query_nodes[victim_id]

    def dying(request):
        victim.alive = False
        raise RuntimeError("injected crash mid-request")

    victim.search_request = dying
    res = coll.search(q, limit=10, staleness_ms=0.0)
    pk_a, sc_a = sorted_rows(oracle)
    pk_b, sc_b = sorted_rows(res)
    np.testing.assert_array_equal(pk_a, pk_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5)

    cs = system.cluster_state()
    assert victim_id not in cs.live_node_ids
    for p in cs.placement:
        assert victim_id not in p.replicas
        assert not p.under_replicated


def test_heartbeat_expiry_reassignment_cas_safe(rng):
    system = _system(num_query_nodes=3, replication_factor=1, seal_rows=200)
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 900, 8, batches=3)
    coll.flush()
    coord = system.query_coord
    victim_id = next(n for n, st in coord.nodes.items() if st.segments)
    survivors = sorted(set(coord.nodes) - {victim_id})
    system.query_nodes[victim_id].alive = False

    system.clock.advance(system.config.heartbeat_ttl_ms + 1)
    system.pump()
    statuses = coord.health.observe()
    assert statuses[victim_id] == "dead"
    assert all(statuses[n] == "healthy" for n in survivors)

    real_cas = system.meta.cas
    raced = {"hit": 0}

    def racing_cas(key, rev, value):
        if key.startswith("assignment/c/") and raced["hit"] == 0:
            raced["hit"] += 1
            competitor = dict(system.meta.get(key) or {})
            competitor["nodes"] = [survivors[0]]
            competitor["node"] = survivors[0]
            system.meta.put(key, competitor)
        return real_cas(key, rev, value)

    system.meta.cas = racing_cas
    try:
        report = system.query_coord.reconciler.reconcile()
    finally:
        system.meta.cas = real_cas
    system.run_until_idle()
    assert victim_id in report["dead"]
    assert raced["hit"] == 1
    for (c, sid), reps in coord.replica_sets.items():
        rec = system.meta.get(f"assignment/{c}/{sid}")
        assert rec["nodes"] == list(reps)
        assert victim_id not in reps
        assert len(reps) == 1
    res = coll.search(rng.standard_normal((2, 8)).astype(np.float32), limit=10, staleness_ms=0.0)
    assert (res.pks >= 0).all()


def test_drain_preserves_pinned_mvcc_reads(rng):
    system = _system(num_query_nodes=2, replication_factor=1, seal_rows=200,
                     compaction_delete_ratio=0.1)
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 800, 8, batches=4)
    coll.flush()
    coll.delete(rng.choice(800, 200, replace=False))
    coll.compact()
    q = rng.standard_normal((3, 8)).astype(np.float32)
    pinned = coll.search(q, limit=10, staleness_ms=0.0)
    pins_before = {p.segment_id: p.visible_from_ts for p in system.cluster_state().placement}
    assert any(ts > 0 for ts in pins_before.values())

    drained = system.remove_query_node()
    assert drained is not None
    for p in system.cluster_state().placement:
        assert drained not in p.replicas
        assert p.visible_from_ts == pins_before[p.segment_id]

    replay = coll.search(q, limit=10, time_travel_ts=pinned.query_ts)
    pk_a, sc_a = sorted_rows(pinned)
    pk_b, sc_b = sorted_rows(replay)
    np.testing.assert_array_equal(pk_a, pk_b)
    np.testing.assert_allclose(sc_a, sc_b, rtol=1e-5)


def _kill_and_recover(pkg):
    system = _system(pkg, num_query_nodes=3, replication_factor=2, seal_rows=200, num_shards=2)
    coll = system.create_collection("c", dim=8)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 4, "nprobe": 4})
    ingest(coll, np.random.default_rng(21), 900, 8, batches=3)
    coll.flush()
    coll.delete(np.arange(0, 90))
    q = np.random.default_rng(22).standard_normal((4, 8)).astype(np.float32)
    before = coll.search(q, limit=10, staleness_ms=0.0)
    system.kill_query_node("qn-1")
    dead = system.recover_failures()
    after = coll.search(q, limit=10, staleness_ms=0.0)
    return before, after, dead, system.cluster_state()


def test_parity_kill_and_recover_under_replication():
    want_before, want_after, want_dead, _ = _kill_and_recover(ref)
    before, after, dead, cs = _kill_and_recover(port)
    assert dead == want_dead == ["qn-1"]
    assert torch.equal(before.pks, after.pks) and torch.equal(before.scores, after.scores)
    testing.assert_topk_near_tie(
        (after.scores, after.pks),
        (torch.from_numpy(want_after.scores), torch.from_numpy(want_after.pks)), RTOL, ATOL,
    )
    assert "qn-1" not in cs.live_node_ids
    assert all("qn-1" not in p.replicas and not p.under_replicated for p in cs.placement)
