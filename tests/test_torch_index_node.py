"""Index build on the index node and indexed search on the query nodes, in
both packages, on the CPU.

Each package gets the same reference-written binlogs, the same seeded
``index_build_task`` coord messages (IVF-FLAT, IVF-SQ, IVF-PQ, SQ, PQ and
OPQ segments) and the same WAL stream of growing inserts and deletes.  Its
``IndexNode`` builds every index (CAS claim, vector column only,
``index.save()`` to ``index_key``, ``index_built``), two ``QueryNode``s
load the indexes it built, and the node with the WAL subscription builds
interim IVF-FLAT indexes over the full slices of the growing segment
(``slice_rows`` = 64).  Node results and the two-node merge must match
for L2, IP and cosine, pinned before and after deletes.

Tolerance: scores rtol=1e-5, atol=1e-4; pks exact except at near-ties
(``repro_torch.testing.assert_topk_near_tie``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.binlog as ref_binlog  # noqa: E402
import repro.core.log as ref_log  # noqa: E402
from repro.core.collection import Metric as RefMetric  # noqa: E402
from repro.core.consistency import GuaranteeTs as RefGuarantee  # noqa: E402
from repro.core.index_node import IndexNode as RefIndexNode  # noqa: E402
from repro.core.meta_store import MetaStore as RefMetaStore  # noqa: E402
from repro.core.object_store import MemoryObjectStore as RefStore  # noqa: E402
from repro.core.query_node import QueryNode as RefNode  # noqa: E402
from repro.core.request import AnnsQuery as RefAnns  # noqa: E402
from repro.core.request import NodeSearchRequest as RefRequest  # noqa: E402
from repro.core.segment import Segment as RefSegment  # noqa: E402
from repro_torch.core import log  # noqa: E402
from repro_torch.core.collection import Metric  # noqa: E402
from repro_torch.core.consistency import GuaranteeTs  # noqa: E402
from repro_torch.core.index_node import IndexNode  # noqa: E402
from repro_torch.core.meta_store import MetaStore  # noqa: E402
from repro_torch.core.object_store import MemoryObjectStore  # noqa: E402
from repro_torch.core.query_node import QueryNode  # noqa: E402
from repro_torch.core.request import AnnsQuery, NodeSearchRequest  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.testing import assert_topk_near_tie  # noqa: E402

DIM, K, NQ = 16, 10, 6
SLICE_ROWS = 64
# segment id -> (rows, index kind, build params)
SEALED = {
    1: (160, "ivf_flat", {"nlist": 8, "nprobe": 3}),
    2: (150, "ivf_sq", {"nlist": 8, "nprobe": 3}),
    3: (140, "ivf_pq", {"nlist": 4, "nprobe": 2, "m": 4, "ksub": 16}),
    4: (130, "sq", {}),
    5: (120, "pq", {"m": 4, "ksub": 16}),
    6: (110, "opq", {"m": 4, "ksub": 16}),
}
NODE_A, NODE_B = (1, 2, 3), (4, 5, 6)
GROWING_SID, GROWING_ROWS = 9, 200  # three full slices and an 8-row tail
METRICS = ("l2", "ip", "cosine")
TS_SEALED, TS_GROW, TS_DEL = 100, 200, 300
PINS = (250, 400)


def _data():
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((10, DIM)).astype(np.float32) * 3

    def rows(n):
        return (centers[rng.integers(0, 10, n)] + rng.standard_normal((n, DIM))).astype(np.float32)

    sealed = {sid: rows(n) for sid, (n, _, _) in SEALED.items()}
    grow = rows(GROWING_ROWS)
    queries = rows(NQ)
    deleted = np.concatenate([
        np.arange(1000, 1010), np.arange(4000, 4030, 3), np.arange(9000, 9100, 7)
    ])
    return sealed, grow, queries, deleted


class CountingStore(MemoryObjectStore):
    """The port's memory store, recording every key read."""

    def __init__(self):
        super().__init__()
        self.reads: list[str] = []

    def get(self, key):
        self.reads.append(key)
        return super().get(key)


def _ref_binlogs(sealed):
    store = RefStore()
    for metric in METRICS:
        coll = f"c_{metric}"
        for sid, x in sealed.items():
            seg = RefSegment(sid, coll, 0, DIM)
            seg.append(np.arange(sid * 1000, sid * 1000 + len(x)), x,
                       np.full(len(x), TS_SEALED, np.int64))
            seg.seal()
            ref_binlog.write_segment_binlog(store, seg)
    return store


class Ticks:
    """A timestamp oracle for the coord channel: 150, 151, ... (after the
    build tasks, before the deletes)."""

    def __init__(self):
        self.ts = 150

    def next(self) -> int:
        self.ts += 1
        return self.ts


def _tasks(log_mod, broker):
    for j, (metric, sid) in enumerate((m, s) for m in METRICS for s in SEALED):
        _, kind, params = SEALED[sid]
        broker.publish("coord", log_mod.LogEntry(TS_SEALED + j, log_mod.EntryType.COORD, {
                "msg": "index_build_task", "collection": f"c_{metric}", "segment_id": sid,
                "index_kind": kind, "metric": metric, "params": params,
            }))


def _wal(log_mod, broker, grow, deleted):
    for metric in METRICS:
        coll = f"c_{metric}"
        ch = log_mod.dml_channel(coll, 0)
        broker.create_channel(ch)
        for j, lo in enumerate(range(0, GROWING_ROWS, 50)):
            broker.publish(ch, log_mod.LogEntry(TS_GROW + j, log_mod.EntryType.INSERT, {
                "collection": coll, "segment_id": GROWING_SID, "shard": 0,
                "pk": np.arange(9000 + lo, 9000 + lo + 50), "vector": grow[lo : lo + 50],
            }))
        broker.publish(ch, log_mod.LogEntry(TS_DEL, log_mod.EntryType.DELETE,
                                            {"collection": coll, "pk": deleted}))
        broker.publish("coord", log_mod.LogEntry(TS_DEL, log_mod.EntryType.COORD,
                                                 {"msg": "tombstones", "collection": coll, "pk": deleted}))


@pytest.fixture(scope="module")
def systems():
    sealed, grow, queries, deleted = _data()
    ref_store = _ref_binlogs(sealed)
    port_store = CountingStore()
    for meta in ref_store.list():
        port_store.put(meta.key, ref_store.get(meta.key))
    out = {}
    for name, log_mod, store, inode_cls, meta_cls, qnode_cls, kw in (
        ("ref", ref_log, ref_store, RefIndexNode, RefMetaStore, RefNode, {}),
        ("port", log, port_store, IndexNode, MetaStore, QueryNode, {"device": "cpu"}),
    ):
        broker = log_mod.LogBroker()
        broker.create_channel("coord")
        inode = inode_cls("in-1", broker, store, meta_cls(), Ticks(), **kw)
        _tasks(log_mod, broker)
        assert inode.step()
        build_reads = [k for k in getattr(store, "reads", []) if k.startswith("binlog/")]
        built = [
            e.payload for e in broker.read("coord", 0)
            if e.payload.get("msg") == "index_built"
        ]
        nodes = {
            n: qnode_cls(f"qn-{n}", broker, store, slice_rows=SLICE_ROWS, **kw) for n in "ab"
        }
        for p in built:
            node = nodes["a" if p["segment_id"] in NODE_A else "b"]
            node.load_sealed(p["collection"], p["segment_id"])
            node.load_index(p["collection"], p["segment_id"], p["index_kind"], p["index_key"])
        _wal(log_mod, broker, grow, deleted)
        for metric in METRICS:
            nodes["b"].subscribe(log_mod.dml_channel(f"c_{metric}", 0))
        for node in nodes.values():
            node.step()
        out[name] = {
            "broker": broker, "index_node": inode, "nodes": nodes, "built": built,
            "build_reads": build_reads,
        }
    out["queries"], out["deleted"], out["store"] = queries, deleted, port_store
    return out


def test_index_node_builds_every_task_like_reference(systems):
    ref, port = systems["ref"], systems["port"]
    assert port["index_node"].builds_completed == len(METRICS) * len(SEALED)

    def strip(payloads):
        return [{k: v for k, v in p.items() if k != "built_by"} for p in payloads]

    assert strip(port["built"]) == strip(ref["built"])
    m = port["index_node"].metrics
    for _, kind, _ in SEALED.values():
        assert m.counter_value("index_builds_total", labels={"kind": kind}) == len(METRICS)
    # Only the vector column (and the metadata probe) of a binlog was read.
    reads = port["build_reads"]
    assert len(reads) == len(METRICS) * len(SEALED)
    assert all(k.endswith("/col/vector") for k in reads)


def test_index_claim_is_exclusive(systems):
    """A second index node on the same meta store and coord channel finds
    every task claimed and builds nothing."""
    port = systems["port"]
    inode = port["index_node"]
    other = IndexNode("in-2", port["broker"], systems["store"], inode.meta, Ticks(), device="cpu")
    assert not other.step()
    assert other.builds_completed == 0


def test_growing_slices_get_interim_indexes(systems):
    for name in ("ref", "port"):
        node = systems[name]["nodes"]["b"]
        for metric in METRICS:
            key = (f"c_{metric}", GROWING_SID)
            seg = node.growing[key] if name == "port" else node.growing[key].segment
            built = seg.slice_indexes if name == "port" else node.growing[key].slice_index_built
            assert sorted(built) == [0, 1, 2]
    port_seg = systems["port"]["nodes"]["b"].growing[("c_l2", GROWING_SID)]
    ref_gs = systems["ref"]["nodes"]["b"].growing[("c_l2", GROWING_SID)]
    for s, idx in port_seg.slice_indexes.items():
        want = ref_gs.slice_index_built[s]._state()
        got = idx._state()
        np.testing.assert_array_equal(got["row_ids"], want["row_ids"])
        np.testing.assert_array_equal(got["list_offsets"], want["list_offsets"])
        np.testing.assert_allclose(got["centroids"], want["centroids"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("ts", PINS, ids=["before_delete", "after_delete"])
@pytest.mark.parametrize("metric", METRICS)
def test_indexed_two_node_search_matches_reference(systems, metric, ts):
    coll = f"c_{metric}"
    queries = systems["queries"]
    ref_parts, port_parts = [], []
    for n in "ab":
        want = systems["ref"]["nodes"][n].search_request(RefRequest(
            collection=coll, k=K, metric=RefMetric(metric),
            guarantee=RefGuarantee(query_ts=ts, staleness_ms=float("inf")),
            anns=[RefAnns("vector", queries)],
        ))[0]
        got = systems["port"]["nodes"][n].search_request(NodeSearchRequest(
            collection=coll, k=K, metric=Metric(metric),
            guarantee=GuaranteeTs(query_ts=ts, staleness_ms=float("inf")),
            anns=[AnnsQuery("vector", queries)],
        ))[0]
        assert_topk_near_tie(got, (torch.from_numpy(want[0]), torch.from_numpy(want[1])), 1e-5, 1e-4)
        if ts > TS_DEL:
            assert not np.isin(got[1].numpy(), systems["deleted"]).any()
        ref_parts.append(want)
        port_parts.append(got)
    mstr = "l2" if metric == "l2" else "ip"
    got = ops.merge_topk(torch.cat([p[0] for p in port_parts], 1),
                         torch.cat([p[1] for p in port_parts], 1), K, metric=mstr)
    want = ops.merge_topk(torch.from_numpy(np.concatenate([p[0] for p in ref_parts], 1)),
                          torch.from_numpy(np.concatenate([p[1] for p in ref_parts], 1)), K, metric=mstr)
    assert_topk_near_tie(got, want, 1e-5, 1e-4)


def test_l2_plan_uses_slice_indexes_and_cosine_keeps_them_in_the_tail(systems):
    node = systems["port"]["nodes"]["b"]
    l2 = node.plan_search("c_l2", 400, metric=Metric.L2)
    cos = node.plan_search("c_cosine", 400, metric=Metric.COSINE)
    assert len(l2.growing_slice) == 3 and len(l2.brute_tail) == 1
    assert int(l2.brute_tail[0].mask.sum()) == GROWING_ROWS - 3 * SLICE_ROWS - int(
        np.isin(np.arange(9000 + 3 * SLICE_ROWS, 9000 + GROWING_ROWS), systems["deleted"]).sum()
    )
    assert not cos.growing_slice and len(cos.brute_tail) == 1
