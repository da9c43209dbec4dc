"""Hedged search under load, on the CPU: the facade's hedged request
(``hedge_timeout_s=0.0``, every dispatch a straggler) repeated in one
process while other threads keep the interpreter and torch busy.  Each
repeat must hedge, return the unhedged request's pks and the reference's,
and no query node may serve two dispatches at once (the straggler's
thread and the hedge's fallback to the same node)."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.core.query_node import QueryNode  # noqa: E402

CONFIG = dict(num_query_nodes=2, num_index_nodes=1, seal_rows=500, slice_rows=256,
              ingest_queue_rows=512, ingest_flush_rows=1_024, replication_factor=2)
REPEATS = 5


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _hedged(pkg):
    kw = {"device": "cpu"} if pkg is port else {}
    manu = pkg.ManuSystem(pkg.ManuConfig(**CONFIG), **kw)
    coll = manu.create_collection("h", dim=16)
    rng = np.random.default_rng(13)
    coll.insert({"vector": rng.standard_normal((1_200, 16)).astype(np.float32)})
    coll.flush()
    coll.insert({"vector": rng.standard_normal((100, 16)).astype(np.float32)})
    q = rng.standard_normal((4, 16)).astype(np.float32)
    plain = coll.search(q, limit=10, staleness_ms=0.0)
    hedged = coll.search(q, limit=10, staleness_ms=0.0, hedge_timeout_s=0.0)
    return plain, hedged, manu.metrics().counter("proxy_hedges_total")


class _Busy:
    """Threads that keep torch's intra-op pool busy (small products) and
    one that competes for the interpreter (a Python loop), until stopped."""

    def __init__(self, n: int = 3):
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                        for i in range(n)]

    def _run(self, i: int) -> None:
        a = torch.randn(128, 128)
        while not self.stop.is_set():
            if i == 0:
                sum(j * j for j in range(2_000))
                time.sleep(0.002)
            else:
                (a @ a).sum()

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join()


@pytest.fixture
def serve_overlap(monkeypatch):
    """Wraps ``QueryNode._search_request`` (the scan of one dispatch): the
    most dispatches any one node scanned at once.  Nodes are told apart by
    identity: each repeat builds a new system whose nodes reuse the ids, and
    a hedge straggler of the last one may still be scanning its own node."""
    lock = threading.Lock()
    live: dict[int, int] = {}
    peak = {"max": 0}
    inner = QueryNode._search_request

    def counted(self, request):
        with lock:
            live[id(self)] = live.get(id(self), 0) + 1
            peak["max"] = max(peak["max"], live[id(self)])
        try:
            return inner(self, request)
        finally:
            with lock:
                live[id(self)] -= 1

    monkeypatch.setattr(QueryNode, "_search_request", counted)
    return peak


def test_hedged_search_under_load_matches_reference(serve_overlap):
    ref_plain, ref_hedged, _ = _hedged(ref)
    np.testing.assert_array_equal(_np(ref_hedged.pks), _np(ref_plain.pks))
    with _Busy():
        runs = [_hedged(port) for _ in range(REPEATS)]
    for plain, hedged, hedges in runs:
        assert hedges > 0
        np.testing.assert_array_equal(_np(hedged.pks), _np(plain.pks))
        np.testing.assert_array_equal(_np(hedged.pks), _np(ref_hedged.pks))
        np.testing.assert_allclose(_np(hedged.scores), _np(ref_hedged.scores), rtol=1e-5, atol=1e-4)
    assert serve_overlap["max"] == 1
