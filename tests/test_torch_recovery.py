"""Crash-restart recovery through the port's ``ManuSystem`` on the CPU.

The first part ports ``tests/test_recovery.py`` case for case: per-node-
class kill / restart, lost-seal reconciliation, the whole-system
``restart()`` against an uncrashed oracle (also on ``FileObjectStore``),
compaction crashed at every faultable step, the seeded chaos run (over the
six seeds of the CI chaos matrix, with zero wrong answers) and the
attribute-index satellites.  The second runs one seeded workload through
``repro``'s and the port's ``ManuSystem`` and compares the answers after
each ``restart_*`` and after ``restart()``: scores within
``SCORE_TOL["l2"]``, pks exactly except at near-ties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.core.faults as ref_faults  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import FieldSchema, FieldType  # noqa: E402
from repro_torch.core.binlog import attr_key  # noqa: E402
from repro_torch.core.faults import Crash, FaultInjector  # noqa: E402
from repro_torch.core.object_store import FileObjectStore  # noqa: E402

CFG = dict(num_query_nodes=2, seal_rows=100, slice_rows=64, num_shards=2)
#: The seeds of the CI chaos matrix (.github/workflows/ci.yml).
CHAOS_SEEDS = [1, 7, 42, 1234, 20260808, 99991]
RTOL, ATOL = testing.SCORE_TOL["l2"]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _system(pkg=port, injector=None, store=None, **config):
    kw = {"device": "cpu"} if pkg is port else {}
    return pkg.ManuSystem(pkg.ManuConfig(**{**CFG, **config}), store=store,
                          injector=injector, **kw)


@pytest.fixture
def system():
    return _system()


def ingest(coll, rng, n, dim=8, batch=100):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    for lo in range(0, n, batch):
        coll.insert({"vector": vecs[lo : lo + batch]})
    return vecs


def live_pks(res):
    return {int(pk) for pk in _np(res.pks).ravel().tolist() if pk >= 0}


def sorted_pks(res):
    return np.sort(_np(res.pks), 1)


# ------------------------------------------------- per-node-class restart


def test_logger_kill_restart(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 150)
    system.kill_logger("logger-0")
    ingest(coll, rng, 50)
    system.restart_logger("logger-0")
    ingest(coll, rng, 50)
    coll.flush()
    assert coll.num_entities() == 250
    assert system.meta.get("id_alloc/c")["next"] >= 250
    events = [e.kind for e in system.events()]
    assert "node_killed" in events and "node_restarted" in events


def test_data_node_kill_restart_replays_wal(system, rng):
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 250)
    coll.flush()
    ingest(coll, rng, 50)
    system.kill_data_node("dn-0")
    system.restart_data_node("dn-0")
    coll.flush()
    assert coll.num_entities() == 300
    res = coll.search(vecs[:4], limit=5, staleness_ms=0.0)
    assert np.array_equal(_np(res.pks)[:, 0], np.arange(4))


def test_data_node_crash_between_flush_and_seal_announce(rng):
    inj = FaultInjector(seed=0)
    system = _system(injector=inj)
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 250)
    sealed_before = len(system.data_coord.sealed_segments("c"))
    inj.crash_at("log.publish", 1, match="coord")
    system.data_coord.flush("c")
    system.run_until_idle()
    inj.disarm()
    assert [dn.node_id for dn in system.data_nodes if not dn.alive] == ["dn-0"]
    orphans = [m.key for m in system.store.list("binlog/c/") if m.key.endswith("/meta")]
    assert len(orphans) > len(system.data_coord.sealed_segments("c"))
    system.restart_data_node("dn-0")
    system.run_until_idle()
    assert len(system.data_coord.sealed_segments("c")) > sealed_before
    assert system.telemetry.counter_value("recovery_seals_reconciled_total") >= 1
    assert system.events(kind="seal_reconciled")
    assert coll.num_entities() == 250
    res = coll.search(vecs[:3], limit=5, staleness_ms=0.0)
    assert np.array_equal(_np(res.pks)[:, 0], np.arange(3))


def test_index_node_crash_leaks_claim_restart_clears_it(rng):
    inj = FaultInjector(seed=0)
    system = _system(injector=inj)
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 250)
    coll.flush()
    inj.crash_at("object_store.put", 1, match="index/")
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 4})
    inj.disarm()
    assert not system.index_nodes[0].alive
    leaked = {k: v for k, v in system.meta.scan("index_claim/").items() if v.get("owner") == "in-0"}
    assert leaked
    system.restart_index_node("in-0")
    system.run_until_idle()
    sealed = system.data_coord.sealed_segments("c")
    assert len(set(system.meta.scan("index/c/"))) == len(sealed)


def test_compaction_node_crash_restart_reexecutes(rng):
    inj = FaultInjector(seed=0)
    system = _system(injector=inj)
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 400)
    coll.flush()
    coll.delete(np.arange(0, 160))
    before = coll.search(vecs[160:163], limit=8, staleness_ms=0.0)
    inj.crash_at("object_store.put", 1, match="binlog/")
    coll.compact()
    inj.disarm()
    assert not system.compaction_nodes[0].alive
    assert system.compaction_coord.pending
    system.restart_compaction_node("cn-0")
    system.run_until_idle()
    assert not system.compaction_coord.pending
    after = coll.search(vecs[160:163], limit=8, staleness_ms=0.0)
    np.testing.assert_array_equal(sorted_pks(before), sorted_pks(after))
    assert not set(range(160)) & live_pks(after)


def test_query_node_crash_restart(system, rng):
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 300)
    coll.flush()
    before = coll.search(vecs[:4], limit=5, staleness_ms=0.0)
    system.kill_query_node("qn-0")
    system.restart_query_node("qn-0")
    after = coll.search(vecs[:4], limit=5, staleness_ms=0.0)
    assert torch.equal(before.pks, after.pks)
    assert system.query_nodes["qn-0"].alive


# ------------------------------------------------- whole-system restart


def _workload(system, rng):
    """Two collections, partitions, deletes, an index."""
    a = system.create_collection("a", dim=8)
    b = system.create_collection("b", dim=4)
    a.create_partition("hot")
    va = rng.standard_normal((260, 8)).astype(np.float32)
    a.insert({"vector": va[:200]})
    a.insert({"vector": va[200:]}, partition="hot")
    vb = ingest(b, rng, 150, dim=4)
    a.delete(np.arange(0, 40))
    a.flush()
    b.flush()
    a.create_index("vector", kind="ivf_flat", params={"nlist": 4})
    return a, b, va, vb


def _probe(system, va, vb):
    a, b = system.collections["a"], system.collections["b"]
    return (
        a.search(va[40:45], limit=8, staleness_ms=0.0),
        a.search(va[200:203], limit=8, staleness_ms=0.0, partition_names=("hot",)),
        b.search(vb[:5], limit=8, staleness_ms=0.0),
    )


def test_full_restart_bit_for_bit_vs_oracle(rng):
    subject, oracle = _system(), _system()
    seeds = rng.integers(0, 2**31, 2)
    _, _, va_s, vb_s = _workload(subject, np.random.default_rng(seeds[0]))
    _, _, va_o, vb_o = _workload(oracle, np.random.default_rng(seeds[0]))

    report = subject.restart()
    assert report["data"]["sealed"] >= 2
    assert subject.telemetry.counter_value("system_restarts_total") == 1
    assert subject.events(kind="system_restarted")
    for got, want in zip(_probe(subject, va_s, vb_s), _probe(oracle, va_o, vb_o)):
        assert torch.equal(got.pks, want.pks)

    rng2 = np.random.default_rng(seeds[1])
    a2 = subject.collections["a"]
    a2.insert({"vector": rng2.standard_normal((30, 8)).astype(np.float32)})
    a2.flush()
    assert a2.num_entities() == 290
    desc = a2.describe()
    assert set(desc.partitions) == {"_default", "hot"}
    assert desc.indexes and desc.indexes[0].kind == "ivf_flat"


def test_full_restart_on_file_object_store(tmp_path, rng):
    subject = _system(store=FileObjectStore(str(tmp_path)))
    oracle = _system()
    _, _, va_s, vb_s = _workload(subject, np.random.default_rng(123))
    _, _, va_o, vb_o = _workload(oracle, np.random.default_rng(123))
    before = _probe(subject, va_s, vb_s)
    subject.restart()
    after = _probe(subject, va_s, vb_s)
    want = _probe(oracle, va_o, vb_o)
    for got_b, got_a, w in zip(before, after, want):
        assert torch.equal(got_b.pks, got_a.pks)
        assert torch.equal(got_a.pks, w.pks)
    a = subject.collections["a"]
    a.insert({"vector": np.random.default_rng(9).standard_normal((20, 8)).astype(np.float32)})
    subject.restart()
    assert subject.collections["a"].num_entities() == 280


def test_restart_preserves_pinned_time_travel_reads(rng):
    system = _system()
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 400)
    coll.flush()
    pinned = coll.search(vecs[:4], limit=8, staleness_ms=0.0)
    assert set(range(4)) <= live_pks(pinned)
    coll.delete(np.arange(0, 160))
    coll.compact()
    system.restart()
    coll = system.collections["c"]
    replay = coll.search(vecs[:4], limit=8, time_travel_ts=pinned.query_ts)
    np.testing.assert_array_equal(sorted_pks(replay), sorted_pks(pinned))
    now = coll.search(vecs[:4], limit=8, staleness_ms=0.0)
    assert not set(range(160)) & live_pks(now)


def test_wait_timeout_raises_diagnostic_dump(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 50)
    system.compaction_coord.pending["wedge"] = {"collection": "c", "targets": [], "sources": []}
    with pytest.raises(TimeoutError) as ei:
        system.wait_idle(timeout_s=0.05)
    msg = str(ei.value)
    assert "wait_idle timed out" in msg
    assert "channel entries" in msg
    assert "compactions=1" in msg
    assert "event " in msg
    del system.compaction_coord.pending["wedge"]
    system.wait_idle(timeout_s=5.0)  # drained: returns without raising


# -------------------------------------- crash-at-every-step compaction


def _compaction_scenario(injector=None, pkg=port):
    # one query node: with one shard the channel owner is the only node
    # guaranteed to see tombstones, so placement must stay on it
    system = _system(pkg, injector, num_query_nodes=1, seal_rows=60, slice_rows=32,
                     num_shards=1, num_loggers=1)
    coll = system.create_collection("c", dim=4)
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((240, 4)).astype(np.float32)
    for lo in range(0, 240, 60):
        coll.insert({"vector": vecs[lo : lo + 60]})
    coll.flush()
    coll.delete(np.arange(0, 96))
    q = vecs[100:103]
    pin = coll.search(q, limit=8, staleness_ms=0.0)
    return system, coll, q, pin


def _recover(system, injector):
    """Restart whatever died (a coordinator-path crash needs ``restart()``)."""
    injector.disarm()
    for lg in system.loggers:
        if not lg.alive:
            system.restart_logger(lg.logger_id)
    for dn in system.data_nodes:
        if not dn.alive:
            system.restart_data_node(dn.node_id)
    for ix in system.index_nodes:
        if not ix.alive:
            system.restart_index_node(ix.node_id)
    for cn in system.compaction_nodes:
        if not cn.alive:
            system.restart_compaction_node(cn.node_id)
    for qn_id, qn in list(system.query_nodes.items()):
        if not qn.alive:
            system.restart_query_node(qn_id)


def test_compaction_crash_at_every_step():
    probe_inj = FaultInjector(seed=0)
    oracle, ocoll, q, opin = _compaction_scenario(probe_inj)
    window_start = probe_inj.ops
    ocoll.compact()
    window_len = probe_inj.ops - window_start
    oracle_post = ocoll.search(q, limit=8, staleness_ms=0.0)
    oracle_pin_replay = ocoll.search(q, limit=8, time_travel_ts=opin.query_ts)
    np.testing.assert_array_equal(sorted_pks(oracle_pin_replay), sorted_pks(opin))
    assert window_len > 20

    # The window is the reference's, op for op.
    ref_inj = ref_faults.FaultInjector(seed=0)
    _rs, rcoll, _rq, _rpin = _compaction_scenario(ref_inj, pkg=ref)
    ref_start = ref_inj.ops
    rcoll.compact()
    assert (window_start, window_len) == (ref_start, ref_inj.ops - ref_start)

    for op in range(window_start + 1, window_start + window_len + 1):
        inj = FaultInjector(seed=0)
        inj.crash_at_op(op)
        system, coll, q2, pin = _compaction_scenario(inj)
        assert torch.equal(pin.pks, opin.pks)
        coordinator_died = False
        try:
            coll.compact()
        except Crash:
            coordinator_died = True
        _recover(system, inj)
        if coordinator_died:
            system.restart()
            coll = system.collections["c"]
        coll.compact()  # drive the interrupted cycle to completion
        post = coll.search(q2, limit=8, staleness_ms=0.0)
        np.testing.assert_array_equal(sorted_pks(post), sorted_pks(oracle_post),
                                      err_msg=f"post-compaction divergence at crash op {op}")
        replay = coll.search(q2, limit=8, time_travel_ts=pin.query_ts)
        np.testing.assert_array_equal(sorted_pks(replay), sorted_pks(opin),
                                      err_msg=f"pinned-read divergence at crash op {op}")


# ------------------------------------------------------ chaos acceptance


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_seeded_kill_every_class_zero_wrong_answers(seed):
    """Kill one node of every class mid-workload while 10% transient store
    faults and duplicate log delivery fire: zero wrong answers against an
    uncrashed, fault-free oracle."""
    inj = FaultInjector(seed=seed)
    inj.transient("object_store.put", prob=0.1)
    inj.transient("object_store.get", prob=0.1)
    inj.duplicates(prob=0.05, rewind=2)
    chaos = _system(injector=inj)
    oracle = _system()

    wl = np.random.default_rng(99)
    vecs = wl.standard_normal((600, 8)).astype(np.float32)
    price = wl.uniform(0, 100, 600)
    queries = wl.standard_normal((5, 8)).astype(np.float32)

    def do(phase, system):
        coll = (
            system.create_collection("c", dim=8, extra_fields=[FieldSchema("price", FieldType.FLOAT)])
            if phase == 0 else system.collections["c"]
        )
        lo = phase * 120
        coll.insert({"vector": vecs[lo : lo + 120], "price": price[lo : lo + 120]})
        if phase == 2:
            coll.delete(np.arange(0, 60))
        if phase == 3:
            coll.flush()
            coll.create_index("vector", kind="flat")
        plain = coll.search(queries, limit=10, staleness_ms=0.0).pks
        filtered = coll.query(queries, limit=10, expr="price < 50", staleness_ms=0.0).pks
        return torch.cat([plain, filtered], 1)

    kills = {
        1: ("kill_logger", "restart_logger", "logger-0"),
        2: ("kill_data_node", "restart_data_node", "dn-0"),
        3: ("kill_query_node", "restart_query_node", "qn-1"),
        4: ("kill_index_node", "restart_index_node", "in-0"),
    }
    wrong = 0
    for phase in range(5):
        if phase in kills:
            kill, restart, node = kills[phase]
            getattr(chaos, kill)(node)
            getattr(chaos, restart)(node)
        wrong += int(not torch.equal(do(phase, chaos), do(phase, oracle)))
    assert wrong == 0

    counters = chaos.metrics().to_dict()["counters"]
    for name in ("faults_injected_total", "retry_recovered_total", "node_killed_total",
                 "node_restarted_total"):
        assert any(k.startswith(name) for k in counters), name
    assert {"fault_injected", "node_killed", "node_restarted"} <= {e.kind for e in chaos.events()}


# ------------------------------------------- attribute-index satellites


def _attr_workload(system, rng, n=250, pkg=port):
    coll = system.create_collection(
        "c", dim=8,
        extra_fields=[pkg.FieldSchema("price", pkg.FieldType.FLOAT),
                      pkg.FieldSchema("label", pkg.FieldType.STRING)],
    )
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    price = rng.uniform(0, 100, n)
    label = np.asarray(rng.choice(["a", "b", "c"], n))
    for lo in range(0, n, 100):
        coll.insert({"vector": vecs[lo : lo + 100], "price": price[lo : lo + 100],
                     "label": label[lo : lo + 100]})
    return coll, vecs, price, label


def _filtered_probe(coll, vecs, strategy=None, pkg=port):
    return coll.search(pkg.SearchRequest.single(
        vecs[:3], k=8, filter="price < 60 and label != 'b'",
        filter_strategy=strategy, staleness_ms=0.0,
    ))


def test_crash_between_seal_flush_and_attr_satellite_write(rng):
    inj = FaultInjector(seed=1234)
    system = _system(injector=inj)
    coll, vecs, price, label = _attr_workload(system, rng)

    oracle = _system()
    ocoll = oracle.create_collection(
        "c", dim=8, extra_fields=[FieldSchema("price", FieldType.FLOAT),
                                  FieldSchema("label", FieldType.STRING)],
    )
    for lo in range(0, len(vecs), 100):
        ocoll.insert({"vector": vecs[lo : lo + 100], "price": price[lo : lo + 100],
                      "label": label[lo : lo + 100]})
    ocoll.flush()

    inj.crash_at("object_store.put", 1, match="attr/")
    system.data_coord.flush("c")
    system.run_until_idle()
    inj.disarm()
    assert [dn.node_id for dn in system.data_nodes if not dn.alive] == ["dn-0"]
    orphans = [m.key for m in system.store.list("binlog/c/") if m.key.endswith("/meta")]
    assert len(orphans) > len(system.data_coord.sealed_segments("c"))

    system.restart_data_node("dn-0")
    system.run_until_idle()
    assert system.telemetry.counter_value("recovery_seals_reconciled_total") >= 1
    sealed = system.data_coord.sealed_segments("c")
    assert len(sealed) == len(oracle.data_coord.sealed_segments("c"))
    for sid in sealed:
        for f in ("price", "label"):
            assert system.store.exists(attr_key("c", sid, f))
        assert system.meta.scan(f"attr_index/c/{sid}/")

    want = _filtered_probe(ocoll, vecs)
    for strategy in (None, "pre", "post", "brute"):
        got = _filtered_probe(coll, vecs, strategy)
        assert torch.equal(got.pks, want.pks)
        assert torch.equal(got.scores, want.scores)


def test_restart_heals_vandalized_attr_satellites(rng):
    system = _system()
    coll, vecs, _price, _label = _attr_workload(system, rng)
    coll.flush()
    baseline = _filtered_probe(coll, vecs)
    sealed = system.data_coord.sealed_segments("c")
    assert sealed
    for sid in sealed:
        for f in ("price", "label"):
            assert system.store.delete(attr_key("c", sid, f))

    report = system.restart()
    assert report["attr_healed"] == len(sealed)
    assert system.telemetry.counter_value("recovery_attr_satellites_rebuilt_total") == len(sealed)
    assert system.events(kind="attr_satellites_healed")
    coll = system.collections["c"]
    for sid in sealed:
        for f in ("price", "label"):
            assert system.store.exists(attr_key("c", sid, f))
    after = _filtered_probe(coll, vecs)
    assert torch.equal(baseline.pks, after.pks)
    assert torch.equal(baseline.scores, after.scores)
    assert system.restart()["attr_healed"] == 0


def test_gc_reaps_attr_satellites_of_retired_segments(rng):
    system = _system()
    coll, _vecs, _price, _label = _attr_workload(system, rng, n=300)
    coll.flush()
    before = set(system.data_coord.sealed_segments("c"))
    coll.delete(np.arange(0, 120))
    coll.compact()
    coll.gc()
    live = set(system.data_coord.sealed_segments("c"))
    gone = before - live
    assert gone
    for sid in gone:
        assert not list(system.store.list(f"attr/c/{sid}/"))
        assert not system.meta.scan(f"attr_index/c/{sid}/")
    for sid in live:
        for f in ("price", "label"):
            assert system.store.exists(attr_key("c", sid, f))
        assert system.meta.scan(f"attr_index/c/{sid}/")


# ------------------------------------ one workload through both packages


def _restarts(pkg):
    """The seeded workload, then each ``restart_*`` and ``restart()``;
    returns the answer after each step."""
    system = _system(pkg)
    rng = np.random.default_rng(31)
    coll, vecs, _price, _label = _attr_workload(system, rng, n=300, pkg=pkg)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 4, "nprobe": 4})
    coll.flush()
    coll.insert({"vector": vecs[:40] + 0.01, "price": np.full(40, 10.0),
                 "label": np.asarray(["a"] * 40)})  # growing rows
    coll.delete(np.arange(0, 30))
    q = vecs[30:34]
    out = {}

    def probe(step):
        coll_now = system.collections["c"]
        out[step] = coll_now.search(q, limit=10, staleness_ms=0.0)
        out[step + " filtered"] = _filtered_probe(coll_now, vecs[30:], pkg=pkg)

    probe("start")
    for kill, restart, node in (
        ("kill_logger", "restart_logger", "logger-1"),
        ("kill_data_node", "restart_data_node", "dn-0"),
        ("kill_index_node", "restart_index_node", "in-0"),
        ("kill_compaction_node", "restart_compaction_node", "cn-0"),
        ("kill_query_node", "restart_query_node", "qn-0"),
    ):
        getattr(system, kill)(node)
        getattr(system, restart)(node)
        probe(restart)
    system.kill_query_node("qn-1")
    system.recover_failures()
    probe("recover_failures")
    system.restart()
    probe("restart")
    coll = system.collections["c"]
    coll.delete(np.arange(30, 60))
    coll.compact()
    probe("compact after restart")
    return out


@pytest.fixture(scope="module")
def restarted():
    return _restarts(ref), _restarts(port)


STEPS = [
    "start", "restart_logger", "restart_data_node", "restart_index_node",
    "restart_compaction_node", "restart_query_node", "recover_failures", "restart",
    "compact after restart",
]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("filtered", [False, True], ids=["plain", "filtered"])
def test_parity_answers_after_each_restart(restarted, step, filtered):
    """Each answer equals the reference's at the same step; the restarts
    change no answer.  At ``recover_failures`` the reference's answer lost
    the re-homed channel's growing rows (ROADMAP Queue 3; the next test),
    so the port is held to the reference's answer before the kill."""
    want, got = restarted
    suffix = " filtered" if filtered else ""
    w = want[("start" if step == "recover_failures" else step) + suffix]
    g = got[step + suffix]
    testing.assert_topk_near_tie(
        (g.scores, g.pks),
        (torch.from_numpy(np.asarray(w.scores)), torch.from_numpy(np.asarray(w.pks))),
        RTOL, ATOL,
    )
    if step != "compact after restart":  # the restarts change no answer
        assert torch.equal(g.pks, got["start" + suffix].pks)


def test_rehomed_channel_replays_the_next_segments_first_insert(restarted):
    """The fault the port repairs: the reference re-homes a dead node's DML
    channel from ``checkpoint_pos + 1`` of the last seal, one entry past the
    first insert of the segment growing after it, so that insert's rows are
    lost to search.  The port replays from the data node's ``replay_from``."""
    want, got = restarted
    growing = set(range(301, 340, 2))  # shard 1's growing rows
    assert growing & live_pks(want["start"])
    assert not growing & live_pks(want["recover_failures"])
    assert live_pks(got["recover_failures"]) == live_pks(want["start"])


def test_rehome_replays_every_partitions_growing_rows():
    """Two partitions grow on one shard while a third seals between their
    inserts: the channel's new owner must rebuild both growing segments."""
    system = _system(num_query_nodes=2, num_shards=1, seal_rows=100, num_loggers=1)
    coll = system.create_collection("c", dim=8)
    coll.create_partition("p1")
    coll.create_partition("p2")
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal((n, 8)).astype(np.float32) for n in (20, 100, 20))
    coll.insert({"vector": a}, partition="p1")  # grows
    coll.insert({"vector": b}, partition="p2")  # fills a seal
    coll.insert({"vector": c}, partition="p1")  # grows on
    system.run_until_idle()
    q = np.concatenate([a[:3], c[:3]])
    before = coll.search(q, limit=5, staleness_ms=0.0)
    owner = next(n for n, st in system.query_coord.nodes.items() if st.channels)
    system.kill_query_node(owner)
    system.recover_failures()
    after = coll.search(q, limit=5, staleness_ms=0.0)
    assert torch.equal(before.pks, after.pks)
    assert coll.num_entities() == 140


def test_restart_after_gc_keeps_reclaimed_segments_reclaimed(rng):
    """``restart()`` after ``gc()``: the WAL replay must not archive the
    reclaimed sources again (the data node skips segments the data
    coordinator recorded), and fresh query nodes replaying the coord
    channel neither load them nor rebuild them as growing rows; the answer
    equals the one before the restart bit for bit (ROADMAP Queue 3: the
    reference re-archives them, and raises where a load runs first)."""
    system = _system()
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 400)
    coll.flush()
    coll.delete(np.arange(0, 160))
    coll.compact()
    reaped = [sid for _c, sid in coll.gc()["segments"]]
    assert reaped
    before = coll.search(vecs[150:154], limit=8, staleness_ms=0.0)
    system.restart()
    coll = system.collections["c"]
    after = coll.search(vecs[150:154], limit=8, staleness_ms=0.0)
    assert torch.equal(before.pks, after.pks) and torch.equal(before.scores, after.scores)
    for sid in reaped:
        assert not system.store.exists(f"binlog/c/{sid}/meta")
        assert system.meta.get(f"segment/c/{sid}")["state"] == "reclaimed"
        for qn in system.query_nodes.values():
            assert ("c", sid) not in qn.sealed and ("c", sid) not in qn.growing
        assert all(("c", sid) not in dn.growing for dn in system.data_nodes)
    assert not set(range(160)) & live_pks(after)
    assert coll.num_entities() == 240


def test_restart_serves_only_what_the_coordinator_assigns(rng):
    """After ``restart()`` a fresh query node holds exactly the segments
    the coordinator assigns it plus the retired windows it serves, and no
    growing copy of a sealed segment: it skips the commands addressed to
    its predecessor instead of replaying them (ROADMAP Queue 3: the
    reference's fresh node reloads its predecessor's stale replicas and
    replays the whole WAL into growing copies)."""
    system = _system()
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, rng, 400)
    coll.flush()
    ingest(coll, rng, 30)  # growing rows
    q = vecs[:4]
    pinned = coll.search(q, limit=8, staleness_ms=0.0)
    coll.delete(np.arange(0, 160))
    coll.compact()
    system.kill_query_node("qn-1")
    system.recover_failures()
    before = coll.search(q, limit=8, staleness_ms=0.0)
    system.restart()
    coll = system.collections["c"]
    coord = system.query_coord
    sealed = set(system.data_coord.sealed_segments("c"))
    for node_id, qn in system.query_nodes.items():
        assigned = {sid for (c, sid), reps in coord.replica_sets.items() if node_id in reps}
        windows = {sid for (c, sid), w in coord.retired_windows.items() if node_id in w["nodes"]}
        held = {sid for (c, sid) in qn.sealed}
        assert held == assigned | windows, (node_id, held, assigned, windows)
        assert not {sid for (c, sid) in qn.growing} & sealed
    after = coll.search(q, limit=8, staleness_ms=0.0)
    assert torch.equal(before.pks, after.pks) and torch.equal(before.scores, after.scores)
    replay = coll.search(q, limit=8, time_travel_ts=pinned.query_ts)
    np.testing.assert_array_equal(sorted_pks(replay), sorted_pks(pinned))


@pytest.mark.parametrize("pkg", [port, ref], ids=["port", "reference"])
def test_failover_keeps_the_retired_windows_of_the_dead_node(pkg):
    """Reads pinned before a swap keep their rows when the node serving the
    retired sources dies: the port's coordinator serves the window again on
    a survivor.  The reference loses it (ROADMAP Queue 3)."""
    system = _system(pkg)
    coll = system.create_collection("c", dim=8)
    vecs = ingest(coll, np.random.default_rng(3), 400)
    coll.flush()
    q = vecs[:4]
    pinned = coll.search(q, limit=8, staleness_ms=0.0)
    coll.delete(np.arange(0, 160))
    coll.compact()
    holders = sorted(
        n for n, qn in system.query_nodes.items()
        if any(h.retired_at_ts is not None for h in qn.sealed.values())
    )
    system.kill_query_node(holders[0])
    system.recover_failures()
    replay = coll.search(q, limit=8, time_travel_ts=pinned.query_ts)
    kept = np.array_equal(sorted_pks(replay), sorted_pks(pinned))
    assert kept == (pkg is port)


def test_rehomed_channel_skips_reclaimed_segments_rows():
    """A channel's replay point can sit before a reclaimed segment's
    inserts (another partition grew on the shard since before them): the
    channel's new owner must not rebuild the reclaimed rows, whose folded
    tombstones are gone, as growing rows (query nodes note ``segment_gc``)."""
    system = _system(num_query_nodes=2, num_shards=1, seal_rows=100, num_loggers=1)
    coll = system.create_collection("c", dim=8)
    coll.create_partition("p1")
    coll.create_partition("p2")
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((20, 8)).astype(np.float32), rng.standard_normal((100, 8)).astype(np.float32)
    coll.insert({"vector": a}, partition="p1")  # grows on
    coll.insert({"vector": b}, partition="p2")  # seals: pks 20..119
    system.run_until_idle()
    coll.delete(np.arange(20, 80))  # 60% of the sealed segment
    assert coll.compact()["rows_purged"] == 60
    assert coll.gc()["segments"]
    owner = next(n for n, st in system.query_coord.nodes.items() if st.channels)
    system.kill_query_node(owner)
    system.recover_failures()
    res = coll.search(np.concatenate([a[:2], b[:4]]), limit=5, staleness_ms=0.0)
    assert not live_pks(res) & set(range(20, 80))
    assert coll.num_entities() == 20 + 40
