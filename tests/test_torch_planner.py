"""The query node's planner decides on what the host knows, on the CPU.

The tombstone set a node looks up once per request is cached by how many
of its tombstones apply at the query ts; each lookup is held to
``ops.eff_tombstones`` over the whole map and to the reference node's set,
before, between and after deletes, with a pk deleted twice, with a pk
inserted again after its delete, with a delete arriving between two
requests and after a retention prune, and counts its outcome in
``query_node_tombstone_set_total``.

A unit whose every row is deleted at the query ts is planned and scanned
(the host cannot know its mask is empty); for each index family the
planner can meet (``_index_families.FAMILIES``), the node answers as the
reference node does, which leaves the unit out.  That such a unit adds
only ``(fill, -1)`` slots is held on each device in
``test_torch_trace.py``.

Tolerance for searches: ``repro_torch.testing.SCORE_TOL`` (float32 scores
summed in another order); ids exact except at near-ties
(``repro_torch.testing.assert_topk_near_tie``)."""

import numpy as np
import pytest
from _index_families import FAMILIES, GROWING

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (the reference's index package imports its core first)
import repro.core.binlog as ref_binlog  # noqa: E402
import repro.core.log as ref_log  # noqa: E402
from repro.core.collection import Metric as RefMetric  # noqa: E402
from repro.core.consistency import GuaranteeTs as RefGuarantee  # noqa: E402
from repro.core.object_store import MemoryObjectStore as RefStore  # noqa: E402
from repro.core.query_node import QueryNode as RefNode  # noqa: E402
from repro.core.request import AnnsQuery as RefAnns  # noqa: E402
from repro.core.request import NodeSearchRequest as RefRequest  # noqa: E402
from repro.core.segment import Segment as RefSegment  # noqa: E402
from repro.index.base import IndexSpec as RefSpec  # noqa: E402
from repro.index.registry import create_index as ref_create  # noqa: E402
from repro_torch.core import log  # noqa: E402
from repro_torch.core.collection import Metric  # noqa: E402
from repro_torch.core.consistency import GuaranteeTs  # noqa: E402
from repro_torch.core.object_store import MemoryObjectStore  # noqa: E402
from repro_torch.core.query_node import QueryNode  # noqa: E402
from repro_torch.core.request import AnnsQuery, NodeSearchRequest  # noqa: E402
from repro_torch.core.segment import flatten_tombstones  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.testing import SCORE_TOL, assert_topk_near_tie  # noqa: E402

DIM, K, NQ = 16, 10, 4
TOMBSTONE_SETS = "query_node_tombstone_set_total"
OUTCOMES = ("hit", "miss", "none")


class _Pair:
    """A reference node and a port node fed the same log entries."""

    def __init__(self, store_pair=None, slice_rows: int = 10_000, channels=("c",)):
        ref_store, port_store = store_pair or (RefStore(), MemoryObjectStore())
        self.brokers = (ref_log.LogBroker(), log.LogBroker())
        for broker, log_mod in zip(self.brokers, (ref_log, log)):
            broker.create_channel("coord")
            for coll in channels:
                broker.create_channel(log_mod.dml_channel(coll, 0))
        self.ref = RefNode("qn", self.brokers[0], ref_store, slice_rows=slice_rows)
        self.port = QueryNode("qn", self.brokers[1], port_store, slice_rows=slice_rows,
                              device="cpu")
        for coll in channels:
            self.ref.subscribe(ref_log.dml_channel(coll, 0))
            self.port.subscribe(log.dml_channel(coll, 0))

    def publish(self, channel_of, ts: int, etype: str, payload: dict) -> None:
        for broker, log_mod in zip(self.brokers, (ref_log, log)):
            broker.publish(channel_of(log_mod), log_mod.LogEntry(
                ts, getattr(log_mod.EntryType, etype), dict(payload)))
        self.ref.step()
        self.port.step()

    def insert(self, coll: str, sid: int, pks, vectors, ts: int) -> None:
        self.publish(lambda m: m.dml_channel(coll, 0), ts, "INSERT", {
            "collection": coll, "segment_id": sid, "shard": 0,
            "pk": np.asarray(pks, np.int64), "vector": np.asarray(vectors, np.float32)})

    def delete(self, coll: str, pks, ts: int) -> None:
        self.publish(lambda m: m.dml_channel(coll, 0), ts, "DELETE",
                     {"collection": coll, "pk": np.asarray(pks, np.int64)})

    def coord(self, ts: int, **payload) -> None:
        self.publish(lambda m: "coord", ts, "COORD", payload)

    def counts(self) -> dict:
        metrics = self.port.metrics
        return {o: metrics.counter_value(TOMBSTONE_SETS, {"outcome": o}) for o in OUTCOMES}


def _same_set(got, want) -> None:
    if want is None:
        assert got is None
        return
    assert got is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# Each step: ("delete", pks, ts), ("insert", pks, ts), ("prune", folded pks,
# compact ts, horizon ts) or ("look", ts, outcome).
SCENARIOS = {
    "before_first_delete": [
        ("delete", [1, 2], 100), ("delete", [5], 200), ("look", 50, "none"), ("look", 99, "none"),
    ],
    "between_deletes": [
        ("delete", [1, 2], 100), ("delete", [5], 200),
        ("look", 150, "miss"), ("look", 199, "hit"), ("look", 100, "hit"),
    ],
    "after_last_delete": [
        ("delete", [1, 2], 100), ("delete", [5], 200),
        ("look", 250, "miss"), ("look", 10**12, "hit"), ("look", 150, "miss"),
    ],
    "deleted_twice": [
        ("delete", [1, 2], 100), ("delete", [1], 200),
        ("look", 150, "miss"), ("look", 160, "hit"), ("look", 250, "miss"), ("look", 260, "hit"),
        ("look", 160, "miss"),
    ],
    "reinserted": [
        ("delete", [3], 100), ("insert", [3], 150),
        ("look", 200, "miss"), ("look", 120, "hit"), ("look", 140, "hit"),
    ],
    "delete_between_requests": [
        ("delete", [1], 100), ("look", 300, "miss"), ("look", 310, "hit"),
        ("delete", [2], 320), ("look", 330, "miss"), ("look", 340, "hit"), ("look", 310, "miss"),
    ],
    "retention_prune": [
        ("delete", [1, 2], 100), ("delete", [5], 200), ("look", 300, "miss"), ("look", 300, "hit"),
        ("prune", [1, 2], 150, 250), ("look", 300, "miss"), ("look", 310, "hit"),
    ],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cached_tombstone_set_matches_eff_tombstones_and_reference(scenario):
    pair = _Pair()
    rng = np.random.default_rng(5)
    pair.insert("c", 1, np.arange(20), rng.standard_normal((20, DIM)), 10)
    expected = dict.fromkeys(OUTCOMES, 0.0)
    ts_next = 400
    for step in SCENARIOS[scenario]:
        kind = step[0]
        if kind == "delete":
            pair.delete("c", step[1], step[2])
        elif kind == "insert":
            pair.insert("c", 1, step[1], rng.standard_normal((len(step[1]), DIM)), step[2])
        elif kind == "prune":
            _, folded, compact_ts, horizon = step
            pair.coord(ts_next, msg="tombstones_folded", collection="c",
                       folded_pks=np.asarray(folded, np.int64), compact_ts=compact_ts)
            pair.coord(ts_next + 1, msg="retention_advance", collection="c", horizon_ts=horizon)
            ts_next += 2
            assert not set(folded) & set(pair.port.delta_deletes["c"])
        else:
            _, ts, outcome = step
            got, got_outcome = pair.port._request_doomed_pks("c", ts)
            assert got_outcome == outcome, step
            expected[outcome] += 1
            assert pair.counts() == expected, (step, pair.counts())
            flat = flatten_tombstones(pair.port.delta_deletes["c"], "cpu")
            _same_set(got, ops.eff_tombstones(*flat, ts))
            _same_set(got, pair.ref._request_doomed_pks("c", ts))
            seg, ref_seg = pair.port.growing[("c", 1)], pair.ref.growing[("c", 1)].segment
            np.testing.assert_array_equal(
                pair.port._visible("c", seg, ts, got).numpy(), pair.ref._visible("c", ref_seg, ts)
            )
    assert pair.port.delta_deletes == pair.ref.delta_deletes


def test_segment_visibility_shares_the_cached_set():
    """A segment's own tombstones go through the same cache: timestamps that
    admit the same tombstones share one reduction, dropped by the next
    delete."""
    pair = _Pair()
    pair.insert("c", 1, np.arange(20), np.ones((20, DIM)), 10)
    pair.delete("c", [1, 2], 100)
    seg, ref_seg = pair.port.growing[("c", 1)], pair.ref.growing[("c", 1)].segment
    for ts in (50, 150, 160, 10**12):
        np.testing.assert_array_equal(seg.visible_mask(ts).numpy(), ref_seg.visible_mask(ts))
    assert seg._tombstone_set().effective(170)[1] == "hit"
    pair.delete("c", [3], 200)
    assert seg._del_set is None
    np.testing.assert_array_equal(seg.visible_mask(300).numpy(), ref_seg.visible_mask(300))
    assert seg.min_ts() == ref_seg.min_ts() == 10 and seg.max_ts() == 10


# ------------------------------------------------------- a unit with no row

SEALED_ROWS, LIVE_ROWS, SLICE_ROWS, GROWING_ROWS = 256, 120, 64, 160
TS_SEALED, TS_GROW, TS_DEL, TS_QUERY = 100, 200, 300, 400


def _family_pair(family: str, rng):
    """Two nodes holding a live FLAT brute segment (2) and the family's
    unit, every row of which is deleted at ``TS_DEL``; returns the pair,
    the dead unit's pks and the queries."""
    cls, spec = FAMILIES[family]
    growing = cls in GROWING
    store = RefStore()
    sealed = {2: LIVE_ROWS} if growing else {1: SEALED_ROWS, 2: LIVE_ROWS}
    cols = {}
    for sid, n in sealed.items():
        cols[sid] = {"pk": np.arange(sid * 1000, sid * 1000 + n),
                     "vector": rng.standard_normal((n, DIM)).astype(np.float32)}
        seg = RefSegment(sid, "c", 0, DIM)
        seg.append(cols[sid]["pk"], cols[sid]["vector"], np.full(n, TS_SEALED, np.int64))
        seg.seal()
        ref_binlog.write_segment_binlog(store, seg)
    if cls == "indexed":
        kind, params = spec
        idx = ref_create(RefSpec(kind, RefMetric.L2, params))
        idx.build(cols[1]["vector"])
        store.put(ref_binlog.index_key("c", 1, "vector", kind), idx.save())
    port_store = MemoryObjectStore()
    for meta in store.list():
        port_store.put(meta.key, store.get(meta.key))
    pair = _Pair((store, port_store), slice_rows=SLICE_ROWS)
    for node in (pair.ref, pair.port):
        for sid in sealed:
            node.load_sealed("c", sid)
        if cls == "indexed":
            node.load_index("c", 1, kind, ref_binlog.index_key("c", 1, "vector", kind))
    if growing:
        pks = np.arange(4000, 4000 + GROWING_ROWS)
        vec = rng.standard_normal((GROWING_ROWS, DIM)).astype(np.float32)
        for lo in range(0, GROWING_ROWS, 40):
            pair.insert("c", 4, pks[lo : lo + 40], vec[lo : lo + 40], TS_GROW + lo // 40)
        dead = pks[:SLICE_ROWS] if family == "growing_slice" else pks[2 * SLICE_ROWS :]
    else:
        dead = cols[1]["pk"]
    pair.delete("c", dead, TS_DEL)
    return pair, dead, rng.standard_normal((NQ, DIM)).astype(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_unit_with_no_visible_row_adds_only_empty_slots(family):
    pair, dead, queries = _family_pair(family, np.random.default_rng(31))
    plan = pair.port.plan_search("c", TS_QUERY, metric=Metric.L2, k=K)
    dead_units = [u for u in getattr(plan, FAMILIES[family][0]) if not bool(u.mask.any())]
    assert len(dead_units) == 1 and np.isin(dead_units[0].pks.numpy(), dead).any()

    want = pair.ref.search_request(RefRequest(
        collection="c", k=K, metric=RefMetric.L2,
        guarantee=RefGuarantee(query_ts=TS_QUERY, staleness_ms=float("inf")),
        anns=[RefAnns("vector", queries)],
    ))[0]
    got = pair.port.search_request(NodeSearchRequest(
        collection="c", k=K, metric=Metric.L2,
        guarantee=GuaranteeTs(query_ts=TS_QUERY, staleness_ms=float("inf")),
        anns=[AnnsQuery("vector", torch.from_numpy(queries))],
    ))[0]
    assert_topk_near_tie(got, tuple(map(torch.from_numpy, want)), *SCORE_TOL["l2"])
    assert not np.isin(got[1].numpy(), dead).any() and bool((got[1] >= 0).all())
