"""The port's fault-injection plane and typed retry/backoff on the CPU.

The first part ports ``tests/test_faults.py`` case for case: seeded
determinism, step/op addressing, the retryable-vs-fatal taxonomy, backoff
shape, duplicate delivery, CAS conflict storms, the atomic
``FileObjectStore.put`` (torn and interrupted writes) and whole systems
under transient store faults and duplicate log delivery.  The second holds
the port to ``repro``: one seed gives the same fault schedule and the same
``fault_injected`` events, and a faulty system answers as the reference's
does."""

import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.core.faults as ref_faults  # noqa: E402
import repro.core.retry as ref_retry  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    Crash,
    FaultInjector,
    FaultyLogBroker,
    FaultyMetaStore,
    FaultyObjectStore,
)
from repro_torch.core.log import EntryType, LogBroker, LogEntry, Subscription  # noqa: E402
from repro_torch.core.meta_store import MetaStore  # noqa: E402
from repro_torch.core.object_store import FileObjectStore, MemoryObjectStore  # noqa: E402
from repro_torch.core.retry import (  # noqa: E402
    RetryExhaustedError,
    RetryingMetaStore,
    RetryingObjectStore,
    RetryPolicy,
    TransientStoreError,
)
from repro_torch.core.telemetry import EventLog, MetricsRegistry  # noqa: E402
from repro_torch.core.timestamp import ManualClock  # noqa: E402

# ------------------------------------------------------------- injector


def _drive(injector, n=200):
    """Fixed call pattern; returns the op indices where faults fired."""
    fired = []
    for i in range(n):
        site = ("object_store.put", "meta.get", "log.read")[i % 3]
        if injector.check(site, f"key-{i}") is not None:
            fired.append(injector.ops)
    return fired


def _seeded(seed, cls=FaultInjector):
    inj = cls(seed=seed)
    inj.transient("", 0.2)
    return inj


def test_injector_same_seed_same_faults():
    a = _drive(_seeded(42))
    b = _drive(_seeded(42))
    c = _drive(_seeded(43))
    assert a == b
    assert a != c
    assert a


def test_injector_step_and_op_addressing():
    inj = FaultInjector()
    inj.crash_at("object_store.put", 3)
    assert inj.check("object_store.put", "a") is None
    assert inj.check("object_store.get", "b") is None
    assert inj.check("object_store.put", "b") is None
    rule = inj.check("object_store.put", "c")
    assert rule is not None and rule.kind == "crash"
    assert inj.check("object_store.put", "d") is None

    inj2 = FaultInjector()
    inj2.crash_at_op(5)
    for i in range(4):
        assert inj2.check(f"site-{i}", "k") is None
    assert inj2.check("anything", "k").kind == "crash"


def test_injector_burst_cap_lets_retries_converge():
    inj = FaultInjector()
    inj.transient("object_store.put", prob=1.0, burst=2)
    assert inj.check("object_store.put", "k") is not None
    assert inj.check("object_store.put", "k") is not None
    assert inj.check("object_store.put", "k") is None
    assert inj.check("object_store.put", "k") is not None


def test_injector_disarm_and_telemetry():
    metrics, events = MetricsRegistry(), EventLog(ManualClock())
    inj = FaultInjector(metrics=metrics, event_log=events)
    inj.transient("meta.put", prob=1.0, burst=100)
    assert inj.check("meta.put", "x") is not None
    inj.disarm()
    assert inj.check("meta.put", "x") is None
    inj.arm()
    assert inj.check("meta.put", "x") is not None
    assert metrics.counter_value(
        "faults_injected_total", labels={"site": "meta.put", "kind": "transient"}
    ) == 2
    assert len(events.query(kind="fault_injected")) == 2


# ------------------------------------------------------- retry + wrappers


def test_retrying_store_absorbs_transients():
    metrics = MetricsRegistry()
    inj = FaultInjector(seed=1, metrics=metrics)
    inj.transient("object_store.put", prob=1.0, burst=2)
    store = RetryingObjectStore(
        FaultyObjectStore(MemoryObjectStore(), inj), RetryPolicy(max_attempts=6), metrics=metrics,
    )
    assert store.put("k", b"v").size == 1
    assert store.get("k") == b"v"
    assert metrics.counter_value("retry_recovered_total", labels={"site": "object_store.put"}) >= 1
    assert metrics.counter_value("retry_attempts_total", labels={"site": "object_store.put"}) >= 2


def test_retry_budget_exhaustion_is_typed_and_logged():
    metrics, events = MetricsRegistry(), EventLog(ManualClock())
    inj = FaultInjector(seed=1)
    inj.transient("object_store.get", prob=1.0, burst=100)
    store = RetryingObjectStore(
        FaultyObjectStore(MemoryObjectStore(), inj), RetryPolicy(max_attempts=3),
        metrics=metrics, event_log=events,
    )
    with pytest.raises(RetryExhaustedError) as ei:
        store.get("missing")
    assert ei.value.site == "object_store.get"
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, TransientStoreError)
    assert metrics.counter_value("retry_exhausted_total", labels={"site": "object_store.get"}) == 1
    assert events.query(kind="retry_exhausted")


def test_fatal_errors_propagate_unretried():
    metrics = MetricsRegistry()
    store = RetryingObjectStore(MemoryObjectStore(), metrics=metrics)
    with pytest.raises(KeyError):
        store.get("nope")
    assert metrics.counter_value("retry_attempts_total", labels={"site": "object_store.get"}) == 0


def test_crash_is_never_absorbed_by_retry():
    inj = FaultInjector()
    inj.crash_at("object_store.put", 1)
    store = RetryingObjectStore(FaultyObjectStore(MemoryObjectStore(), inj))
    with pytest.raises(Crash):
        store.put("k", b"v")


def test_retry_policy_backoff_shape():
    policy = RetryPolicy(base_delay_ms=2.0, multiplier=2.0, max_delay_ms=10.0, jitter=0.5)
    rng = random.Random(0)
    for attempt, nominal in ((1, 2.0), (2, 4.0), (3, 8.0), (4, 10.0), (5, 10.0)):
        d = policy.delay_ms(attempt, rng)
        assert nominal * 0.5 <= d <= nominal * 1.5, (attempt, d)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=1.5)


def test_cas_conflict_storm_converges():
    inj = FaultInjector(seed=3)
    inj.cas_conflicts(prob=1.0, burst=2)
    meta = RetryingMetaStore(FaultyMetaStore(MetaStore(ManualClock()), inj))
    wins, rounds = 0, 0
    while wins < 3 and rounds < 50:
        rounds += 1
        rev = meta.get_rev("key")
        if meta.cas("key", rev, {"v": wins}):
            wins += 1
    assert wins == 3
    assert rounds > 3
    assert meta.get("key") == {"v": 2}


def test_duplicate_delivery_rewinds_reads():
    inj = FaultInjector()
    inj.duplicates(prob=1.0, rewind=2, max_fires=1)
    broker = FaultyLogBroker(LogBroker(), inj)
    broker.create_channel("ch")
    for i in range(5):
        broker.publish("ch", LogEntry(ts=i + 1, type=EntryType.TIME_TICK, payload={}))
    sub = Subscription(broker, "ch")
    assert [e.ts for e in sub.poll()] == [1, 2, 3, 4, 5]
    broker.publish("ch", LogEntry(ts=6, type=EntryType.TIME_TICK, payload={}))
    inj.duplicates(prob=1.0, rewind=2, max_fires=1)
    assert [e.ts for e in sub.poll()] == [4, 5, 6]
    assert sub.lag() == 0


# ------------------------------------------------------ atomic FileObjectStore


def test_file_store_torn_write_regression(tmp_path):
    store = FileObjectStore(str(tmp_path))
    store.put("seg/1/meta", b"old")
    real_replace = os.replace
    calls = {"n": 0}

    def dying_replace(src, dst):
        calls["n"] += 1
        raise Crash("object_store.put", 1, "seg/1/meta")

    os.replace = dying_replace
    try:
        with pytest.raises(Crash):
            store.put("seg/1/meta", b"NEW-BUT-NEVER-COMMITTED")
    finally:
        os.replace = real_replace
    assert calls["n"] == 1
    assert store.get("seg/1/meta") == b"old"
    assert [m.key for m in store.list("seg/")] == ["seg/1/meta"]
    store.put("seg/1/meta", b"new")
    assert store.get("seg/1/meta") == b"new"
    assert [f for f in os.listdir(tmp_path / "seg" / "1") if ".tmp" in f] == []


def test_file_store_interrupted_write_leaves_no_partial(tmp_path, monkeypatch):
    import builtins

    store = FileObjectStore(str(tmp_path))
    real_open = builtins.open

    class HalfThenDie:
        def __init__(self, f):
            self.f = f

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()
            return False

        def write(self, data):
            self.f.write(data[: len(data) // 2])
            raise Crash("object_store.put", 1, "a/b")

    def exploding_open(path, mode="r", *a, **kw):
        f = real_open(path, mode, *a, **kw)
        if str(path).endswith(".tmp") and "w" in mode:
            return HalfThenDie(f)
        return f

    monkeypatch.setattr(builtins, "open", exploding_open)
    with pytest.raises(Crash):
        store.put("a/b", b"0123456789")
    monkeypatch.undo()
    assert not store.exists("a/b")
    assert list(store.list("")) == []


# ------------------------------------------------- end-to-end with faults

SMALL = dict(num_query_nodes=2, seal_rows=100, num_shards=2)


def _system(pkg, injector=None, **config):
    kw = {"device": "cpu"} if pkg is port else {}
    return pkg.ManuSystem(pkg.ManuConfig(**{**SMALL, **config}), injector=injector, **kw)


def _transient_run(pkg, faults_mod, vecs):
    inj = faults_mod.FaultInjector(seed=11)
    inj.transient("object_store.put", prob=0.1)
    inj.transient("object_store.get", prob=0.1)
    system = _system(pkg, inj)
    coll = system.create_collection("c", dim=8)
    coll.insert({"vector": vecs})
    coll.flush()
    coll.create_index("vector", kind="flat")
    res = coll.search(vecs[:5], limit=10, staleness_ms=0.0)
    fired = [(e.detail["site"], e.detail["op"], e.detail["key"])
             for e in system.events(kind="fault_injected")]
    return system, res, fired


def test_system_absorbs_transient_store_faults(rng):
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    faulty, got, _ = _transient_run(port, port, vecs)
    oracle = _system(port)
    coll = oracle.create_collection("c", dim=8)
    coll.insert({"vector": vecs})
    coll.flush()
    coll.create_index("vector", kind="flat")
    want = coll.search(vecs[:5], limit=10, staleness_ms=0.0)
    assert torch.equal(got.pks, want.pks)
    counters = faulty.metrics().to_dict()["counters"]
    assert any(k.startswith("faults_injected_total") for k in counters)
    assert any(k.startswith("retry_recovered_total") for k in counters)


def _duplicate_run(pkg, faults_mod, vecs):
    inj = faults_mod.FaultInjector(seed=5)
    inj.duplicates(prob=0.2, rewind=3)
    system = _system(pkg, inj)
    coll = system.create_collection("c", dim=8)
    coll.insert({"vector": vecs})
    coll.delete(np.arange(0, 50))
    coll.flush()
    return system, coll


def test_system_dedups_duplicate_log_delivery(rng):
    vecs = rng.standard_normal((250, 8)).astype(np.float32)
    faulty, fcoll = _duplicate_run(port, port, vecs)
    oracle = _system(port)
    ocoll = oracle.create_collection("c", dim=8)
    ocoll.insert({"vector": vecs})
    ocoll.delete(np.arange(0, 50))
    ocoll.flush()
    assert fcoll.num_entities() == 250
    assert ocoll.num_entities() == 250
    got = fcoll.search(vecs[:4], limit=10, staleness_ms=0.0)
    want = ocoll.search(vecs[:4], limit=10, staleness_ms=0.0)
    assert torch.equal(got.pks, want.pks)
    assert not ({int(p) for p in got.pks.ravel() if p >= 0} & set(range(50)))


# --------------------------------------------- the reference, seed for seed


@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_parity_fault_schedule_same_seed(seed):
    """The same seed fires at the same ops in both packages, whatever mix
    of rules and sites drives them."""

    def build(mod):
        inj = mod.FaultInjector(seed=seed)
        inj.transient("object_store.put", 0.15)
        inj.latency("meta.get", 0.1, delay_ms=3.0)
        inj.duplicates(0.1, rewind=2)
        inj.cas_conflicts(0.2, burst=1)
        inj.crash_at("meta.cas", 7)
        return inj

    def drive(inj):
        out = []
        for i in range(300):
            site = ("object_store.put", "meta.get", "log.read", "meta.cas")[i % 4]
            rule = inj.check(site, f"k-{i % 7}")
            out.append(None if rule is None else (rule.kind, rule.seen, inj.ops))
        return out

    got, want = drive(build(port)), drive(build(ref_faults))
    assert got == want
    assert sum(x is not None for x in got) > 20


def test_parity_backoff_delays_same_seed():
    got = port.RetryPolicy(seed=9)
    want = ref_retry.RetryPolicy(seed=9)
    rg, rw = random.Random(9), random.Random(9)
    assert [got.delay_ms(a, rg) for a in range(1, 9)] == [want.delay_ms(a, rw) for a in range(1, 9)]


def test_parity_system_fault_events_and_answers(rng):
    """One seeded transient-fault run through each ``ManuSystem``: the same
    ``fault_injected`` events (site, op, key) and the same answer."""
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    _sys_p, got, fired_p = _transient_run(port, port, vecs)
    _sys_r, want, fired_r = _transient_run(ref, ref_faults, vecs)
    assert fired_p == fired_r and fired_p
    assert np.array_equal(got.pks.numpy(), want.pks)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-5, atol=1e-4)


def test_parity_duplicate_delivery_run(rng):
    vecs = rng.standard_normal((250, 8)).astype(np.float32)
    sys_p, coll_p = _duplicate_run(port, port, vecs)
    sys_r, coll_r = _duplicate_run(ref, ref_faults, vecs)
    fired_p = [(e.detail["op"], e.detail["key"]) for e in sys_p.events(kind="fault_injected")]
    fired_r = [(e.detail["op"], e.detail["key"]) for e in sys_r.events(kind="fault_injected")]
    assert fired_p == fired_r and fired_p
    got = coll_p.search(vecs[:4], limit=10, staleness_ms=0.0)
    want = coll_r.search(vecs[:4], limit=10, staleness_ms=0.0)
    assert np.array_equal(got.pks.numpy(), want.pks)
