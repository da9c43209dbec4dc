"""Threaded mode of the port's ``ManuSystem`` on the CPU.

``ManuConfig(threaded=True, manual_clock=False)``: a pump thread steps every
component and the loggers tick on the wall clock, a watchdog thread
heartbeats and reconciles.  Held to the reference: its threaded test (the
age trigger), STRONG answers on the quickstart workload equal to the
reference's cooperative answers (pks exact, scores within rtol=1e-5,
atol=1e-4 as in ``test_torch_system.py``), ``restart()``, and
``DataCoordinator.seal_idle`` under a manual clock.  Also: no thread
outlives ``stop_threads``, an exception in a thread reaches the caller,
two threads never build one kernel library at once, and a STRONG read
right after inserts sees every acknowledged row while the pump thread
seals segments and hands growing copies over to sealed ones (the
reference's threaded mode loses such rows three ways; ROADMAP Queue 3).

Every test runs under a time limit of its own (``bounded``), every wait is
bounded (at most 10 s) and the data is small.
"""

import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

DIM, IMG_DIM, ROWS = 16, 8, 1_200
CONFIG = dict(num_query_nodes=2, num_index_nodes=1, seal_rows=300, slice_rows=128,
              ingest_queue_rows=512, ingest_flush_rows=1_024)
RTOL, ATOL = 1e-5, 1e-4
WAIT_S = 10.0


def bounded(limit_s: float):
    """Fail the test if its body runs longer than ``limit_s`` seconds."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as exc:  # noqa: BLE001 - re-raised below
                    box["err"] = exc

            t = threading.Thread(target=body, name=f"test-{fn.__name__}", daemon=True)
            t.start()
            t.join(limit_s)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} did not finish within {limit_s} s")
            if "err" in box:
                raise box["err"]
        return run
    return wrap


def _manu_threads():
    return [t for t in threading.enumerate() if t.name.startswith("manu-") and t.is_alive()]


@pytest.fixture
def systems():
    """Threaded systems made by a test; each is stopped at teardown."""
    made = []

    def make(**config):
        manu = port.ManuSystem(
            port.ManuConfig(**{**CONFIG, "threaded": True, "manual_clock": False, **config}),
            device="cpu",
        )
        made.append(manu)
        return manu

    yield make
    for manu in made:
        if manu._threads:
            manu.stop_threads()
    assert not _manu_threads()


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@bounded(30)
def test_threaded_age_trigger_resolves_without_forcing(systems):
    """Port of ``tests/test_scheduler.py::test_threaded_age_trigger_resolves_without_forcing``."""
    rng = np.random.default_rng(0)
    system = systems(ingest_flush_ms=5.0, num_query_nodes=1, num_shards=1)
    coll = system.create_collection("c", dim=DIM)
    ticket = coll.insert_async({"vector": rng.standard_normal((8, DIM)).astype(np.float32)})
    # wait() never forces a flush: only the pump loop's age trigger can
    # resolve this ticket
    assert ticket.wait(5.0)
    assert ticket.result().row_count == 8
    system.wait_idle(timeout_s=WAIT_S)
    assert coll.num_entities() == 8


def _workload(pkg, manu):
    """The quickstart's shape, cut small: two vector fields and a price,
    IVF-FLAT probing every list (exact answers whatever the index state),
    inserts in 200-row batches, then STRONG reads: plain, hybrid, filtered,
    after deletes.  Returns every result."""
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
    for lo in range(0, ROWS, 200):
        coll.insert({"vector": text[lo:lo + 200], "img_vec": img[lo:lo + 200],
                     "price": prices[lo:lo + 200]})
    tq = rng.standard_normal((3, DIM)).astype(np.float32)
    iq = rng.standard_normal((3, IMG_DIM)).astype(np.float32)
    out = {"strong": coll.search(pkg.SearchRequest.single(
        tq, k=5, consistency=pkg.ConsistencyLevel.STRONG))}
    out["hybrid"] = coll.search(pkg.SearchRequest(
        anns=[pkg.AnnsQuery("vector", tq, weight=0.7), pkg.AnnsQuery("img_vec", iq, weight=0.3)],
        k=5, staleness_ms=0.0))
    out["filtered"] = coll.search(pkg.SearchRequest.single(
        tq, k=10, staleness_ms=0.0, filter="price < 50"))
    coll.delete(_np(out["strong"].pks)[0][:2])
    out["after_delete"] = coll.search(tq, limit=5, staleness_ms=0.0)
    coll.flush()
    out["after_flush"] = coll.search(tq, limit=5, staleness_ms=0.0)
    return out, coll


@pytest.fixture(scope="module")
def reference_answers():
    manu = ref.ManuSystem(ref.ManuConfig(**CONFIG))
    return _workload(ref, manu)[0]


@bounded(60)
def test_threaded_strong_reads_match_reference_cooperative(systems, reference_answers):
    manu = systems()
    got, coll = _workload(port, manu)
    for name, want in reference_answers.items():
        np.testing.assert_array_equal(_np(got[name].pks), _np(want.pks), err_msg=name)
        np.testing.assert_allclose(_np(got[name].scores), _np(want.scores), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    manu.wait_idle(timeout_s=WAIT_S)
    assert coll.num_entities() == ROWS  # rows held, deleted ones too, as the reference counts
    manu.stop_threads()
    assert not _manu_threads() and not manu._threads


@bounded(60)
def test_strong_read_after_inserts_sees_every_row_through_handoffs(systems):
    """Inserts cross the seal size again and again; after each, a STRONG
    read of every row must return each acknowledged pk, while the pump
    thread seals, loads and hands growing segments over."""
    manu = systems(seal_rows=100, slice_rows=10_000)
    coll = manu.create_collection("c", dim=8)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((600, 8)).astype(np.float32)
    q = rng.standard_normal((1, 8)).astype(np.float32)
    for hi in range(50, 601, 50):
        coll.insert({"vector": x[hi - 50:hi]})
        res = coll.search(q, limit=hi, staleness_ms=0.0)
        pks = _np(res.pks)[0]
        assert sorted(pks.tolist()) == list(range(hi)), f"after {hi} rows"
        want = np.sort(((x[:hi] - q) ** 2).sum(1))
        np.testing.assert_allclose(_np(res.scores)[0], want, rtol=RTOL, atol=ATOL)


@bounded(60)
def test_threaded_restart_restarts_the_threads_and_keeps_answers(systems):
    manu = systems()
    coll = manu.create_collection("c", dim=DIM)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((700, DIM)).astype(np.float32)
    coll.insert({"vector": x})
    coll.flush()
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    before = coll.search(q, limit=7, staleness_ms=0.0)
    old = list(manu._threads)
    report = manu.restart()
    assert report["tso_frontier"] > 0
    assert all(not t.is_alive() for t in old)
    assert len(_manu_threads()) == 3 and manu.proxy.pump_fn is not None
    manu.wait_idle(timeout_s=WAIT_S)
    coll = manu.collections["c"]
    after = coll.search(q, limit=7, staleness_ms=0.0)
    np.testing.assert_array_equal(_np(after.pks), _np(before.pks))
    np.testing.assert_allclose(_np(after.scores), _np(before.scores), rtol=RTOL, atol=ATOL)
    assert coll.num_entities() == 700
    manu.stop_threads()
    assert not _manu_threads()


@bounded(30)
def test_stop_threads_leaves_no_thread_and_mode_can_restart(systems):
    baseline = {t.ident for t in threading.enumerate()}
    manu = systems()
    assert [t.name for t in manu._threads] == ["manu-pump", "manu-build", "manu-watchdog"]
    assert all(t.is_alive() for t in manu._threads)
    manu.stop_threads()
    assert not manu._threads and manu.proxy.pump_fn is None
    assert {t.ident for t in threading.enumerate() if t.is_alive()} <= baseline
    manu.start_threads()
    assert len(_manu_threads()) == 3
    manu.stop_threads()
    assert not _manu_threads()


@bounded(30)
def test_a_thread_failure_reaches_the_caller(systems):
    manu = systems()
    coll = manu.create_collection("c", dim=DIM)

    def broken():
        raise ValueError("data node fault")

    manu.data_nodes[0].step = broken
    coll.insert({"vector": np.zeros((4, DIM), np.float32)})
    with pytest.raises(RuntimeError, match="ManuSystem thread failed") as info:
        manu.wait_idle(timeout_s=WAIT_S)
    assert isinstance(info.value.__cause__, ValueError)
    deadline = time.time() + WAIT_S
    while _manu_threads() and time.time() < deadline:
        time.sleep(0.01)
    assert not _manu_threads()
    manu.stop_threads()


def test_threaded_mode_needs_the_wall_clock():
    with pytest.raises(ValueError, match="wall clock"):
        port.ManuSystem(port.ManuConfig(threaded=True), device="cpu")


@pytest.mark.parametrize("idle_ms", [0.0, 40.0, 100.0])
def test_seal_idle_matches_reference_under_manual_clock(idle_ms):
    """Time-based sealing of growing allocations, cooperative and on the
    manual clock in both packages."""
    results = []
    for pkg, kw in ((ref, {}), (port, {"device": "cpu"})):
        manu = pkg.ManuSystem(pkg.ManuConfig(**CONFIG), **kw)
        coll = manu.create_collection("c", dim=DIM)
        rng = np.random.default_rng(3)
        coll.insert({"vector": rng.standard_normal((40, DIM)).astype(np.float32)})
        manu.clock.advance(60.0)
        coll.insert({"vector": rng.standard_normal((1, DIM)).astype(np.float32)})
        manu.clock.advance(50.0)
        sealed = manu.data_coord.seal_idle(idle_ms)
        manu.run_until_idle()
        results.append((sealed, manu.data_coord.sealed_segments("c"), coll.num_entities(),
                        manu.data_coord.seal_idle(0.0)))
    assert results[0] == results[1]


@bounded(30)
def test_kernel_builds_are_serialized_across_threads(monkeypatch):
    """Two threads loading one kernel library build it once and never at
    the same time (nvcc itself is stubbed: there is none here)."""
    active, calls, peak = [0], [], [0]

    def fake_build(names):
        active[0] += 1
        peak[0] = max(peak[0], active[0])
        calls.append(tuple(names))
        time.sleep(0.05)
        active[0] -= 1
        return {}

    monkeypatch.setattr(_build, "_build_all", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_loaded", {})
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(_build.load("l2_topk"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert calls == [("l2_topk",)] and peak[0] == 1
    assert len(libs) == 4 and len(set(libs)) == 1


@bounded(60)
def test_reads_answer_while_an_index_builds(systems):
    """The build thread steps the index nodes outside the pump round: while
    a (slowed) index build runs, the query nodes go on consuming ticks, so
    a STRONG read sees rows inserted after the seal and answers before the
    build ends."""
    manu = systems(seal_rows=200, num_shards=1)
    coll = manu.create_collection("c", dim=8)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 4, "nprobe": 4})
    building, release = threading.Event(), threading.Event()
    ix = manu.index_nodes[0]
    real_build = ix._try_build

    def slow_build(task):
        building.set()
        release.wait(WAIT_S)
        return real_build(task)

    ix._try_build = slow_build
    rng = np.random.default_rng(4)
    x = rng.standard_normal((260, 8)).astype(np.float32)
    coll.insert({"vector": x[:200]})  # seals: the build starts and blocks
    assert building.wait(WAIT_S)
    coll.insert({"vector": x[200:]})
    q = x[:1]
    res = coll.search(q, limit=260, staleness_ms=0.0)
    assert not release.is_set() and manu.index_coord.pending_tasks  # the build still runs
    assert sorted(_np(res.pks)[0].tolist()) == list(range(260))
    release.set()
    manu.wait_idle(timeout_s=WAIT_S)
    held = [h for qn in manu.query_nodes.values() for (c, _), h in qn.sealed.items() if c == "c"]
    assert held and all(h.index is not None for h in held)
    after = coll.search(q, limit=260, staleness_ms=0.0)
    np.testing.assert_array_equal(_np(after.pks), _np(res.pks))


@bounded(30)
def test_launch_counts_are_atomic_and_per_thread():
    """``_build.count_launch`` loses no launch when threads count at once,
    and each thread's own count (``thread_launches``) holds only its launches."""
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.path_launches = {"a": 0}
    per_thread = {}

    def run(i, n):
        for _ in range(n):
            _build.count_launch(wrapper, "a")
        per_thread[i] = (n, _build.thread_launches(wrapper))

    threads = [threading.Thread(target=run, args=(i, 2_000 + 100 * i)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    total = sum(2_000 + 100 * i for i in range(4))
    assert wrapper.launches == total and wrapper.path_launches == {"a": total}
    assert all(n == mine for n, mine in per_thread.values()) and len(per_thread) == 4
    assert _build.thread_launches(wrapper) == 0
