"""The write path on the CPU against ``repro``: the port's Logger shards a
seeded batch exactly as the reference's (same channels, same pks per shard,
same LSN per request, inserts, deletes and upserts alike); the DataNode's
sealed binlog and attribute-satellite bytes equal the reference's for the
same WAL; and the coordinators emit the same coord message sequence (msg
kinds, payload keys and placement values) for create -> insert -> flush ->
index."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
from repro.core.coordinator import DataCoordinator as RefDataCoord  # noqa: E402
from repro.core.coordinator import RootCoordinator as RefRoot  # noqa: E402
from repro.core.data_node import DataNode as RefDataNode  # noqa: E402
from repro.core.log import LogBroker as RefBroker  # noqa: E402
from repro.core.logger_node import Logger as RefLogger  # noqa: E402
from repro.core.meta_store import MetaStore as RefMeta  # noqa: E402
from repro.core.object_store import MemoryObjectStore as RefStore  # noqa: E402
from repro.core.timestamp import TSO as RefTSO  # noqa: E402
from repro.core.timestamp import ManualClock as RefClock  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.core.coordinator import DataCoordinator, RootCoordinator  # noqa: E402
from repro_torch.core.data_node import DataNode  # noqa: E402
from repro_torch.core.log import LogBroker, dml_channel  # noqa: E402
from repro_torch.core.logger_node import Logger  # noqa: E402
from repro_torch.core.meta_store import MetaStore  # noqa: E402
from repro_torch.core.object_store import MemoryObjectStore  # noqa: E402
from repro_torch.core.timestamp import TSO, ManualClock  # noqa: E402

SHARDS, DIM, SEAL = 3, 8, 150


def _run(pkg, modules):
    Broker, Meta, Tso, Clock, Root, DataCoord, Log, DNode, Store = modules
    clock = Clock(1_000_000)
    tso = Tso(clock)
    broker, meta, store = Broker(), Meta(clock), Store()
    root = Root(broker, meta, tso)
    schema = pkg.Schema.simple(DIM, extra=[pkg.FieldSchema("tag", pkg.FieldType.INT)])
    info = root.create_collection("c", schema, num_shards=SHARDS, seal_rows=SEAL)
    dcoord = DataCoord(broker, meta, tso, clock)
    logger = Log("lg", broker, tso, dcoord, clock)
    dn = DNode("dn", broker, store, tso, dcoord)
    for s in range(SHARDS):
        dn.subscribe(dml_channel("c", s))
    rng = np.random.default_rng(3)
    results = []
    for b in range(4):
        n = 97 + 11 * b
        rows = {"vector": rng.standard_normal((n, DIM)).astype(np.float32),
                "tag": rng.integers(0, 50, n)}
        results.append(logger.mutate(info, pkg.InsertRequest(rows)))
        dn.step()
    pk = rng.integers(0, 400, 7)
    results.append(logger.mutate(info, pkg.UpsertRequest({
        "pk": pk, "vector": rng.standard_normal((7, DIM)).astype(np.float32),
        "tag": rng.integers(0, 50, 7)})))
    results.append(logger.mutate(info, pkg.DeleteRequest(rng.integers(0, 500, 25))))
    results.append(logger.mutate(info, pkg.DeleteRequest(np.array([10**9]))))  # no-match
    dn.step()
    dcoord.flush("c")
    dn.step()
    return {"broker": broker, "store": store, "results": results}


REF_MODULES = (RefBroker, RefMeta, RefTSO, RefClock, RefRoot, RefDataCoord, RefLogger, RefDataNode, RefStore)
PORT_MODULES = (LogBroker, MetaStore, TSO, ManualClock, RootCoordinator, DataCoordinator, Logger,
                DataNode, MemoryObjectStore)


@pytest.fixture(scope="module")
def runs():
    return {"ref": _run(ref, REF_MODULES), "port": _run(port, PORT_MODULES)}


@pytest.mark.parametrize("shard", range(SHARDS))
def test_logger_shards_like_reference(runs, shard):
    got = runs["port"]["broker"].read(dml_channel("c", shard), 0)
    want = runs["ref"]["broker"].read(dml_channel("c", shard), 0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.ts, g.type.value, g.position) == (w.ts, w.type.value, w.position)
        assert sorted(g.payload) == sorted(w.payload)
        for key, val in w.payload.items():
            if key == "extras":
                assert sorted(g.payload[key]) == sorted(val)
                for f, arr in val.items():
                    np.testing.assert_array_equal(g.payload[key][f], arr)
            elif isinstance(val, np.ndarray):
                assert g.payload[key].dtype == val.dtype
                np.testing.assert_array_equal(g.payload[key], val)
            else:
                assert g.payload[key] == val


def test_mutation_results_match_reference(runs):
    for g, w in zip(runs["port"]["results"], runs["ref"]["results"], strict=True):
        assert (g.op, g.shard_lsns, g.watermark_ts, g.row_count, g.ack_rows) == (
            w.op, w.shard_lsns, w.watermark_ts, w.row_count, w.ack_rows)
        np.testing.assert_array_equal(g.pks, w.pks)


def test_coord_tombstone_mirror_matches_reference(runs):
    got = [(e.ts, e.payload["msg"], e.payload.get("pk")) for e in runs["port"]["broker"].read("coord", 0)]
    want = [(e.ts, e.payload["msg"], e.payload.get("pk")) for e in runs["ref"]["broker"].read("coord", 0)]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        if w[2] is not None:
            np.testing.assert_array_equal(g[2], w[2])


def test_data_node_binlog_bytes_match_reference(runs):
    got, want = runs["port"]["store"], runs["ref"]["store"]
    keys = [m.key for m in want.list("")]
    assert [m.key for m in got.list("")] == keys
    assert any(k.endswith("/meta") for k in keys) and any(k.startswith("attr/") for k in keys)
    for key in keys:
        assert got.get(key) == want.get(key), key


def _coord_sequence(pkg):
    kw = {"device": "cpu"} if pkg is port else {}
    manu = pkg.ManuSystem(pkg.ManuConfig(num_query_nodes=2, seal_rows=300, slice_rows=128), **kw)
    coll = manu.create_collection("c", dim=DIM)
    rng = np.random.default_rng(5)
    for _ in range(3):
        coll.insert({"vector": rng.standard_normal((250, DIM)).astype(np.float32)})
    coll.flush()
    coll.create_index("vector", "ivf_flat", {"nlist": 4, "nprobe": 2})
    coll.insert({"vector": rng.standard_normal((100, DIM)).astype(np.float32)})
    coll.flush()
    scalar = ("collection", "segment_id", "node_id", "channel", "shard", "num_rows",
              "index_kind", "from_position", "field", "column", "visible_from_ts")
    return [
        (e.ts, e.payload["msg"], sorted(e.payload),
         {k: e.payload[k] for k in scalar if k in e.payload})
        for e in manu.broker.read("coord", 0)
    ] + [("ddl", e.payload) for e in manu.broker.read("ddl", 0)]


def test_coordinators_emit_reference_coord_sequence():
    """The reference's sequence; the port's ``segment_sealed`` also names the
    channel's replay point, ``replay_from`` (``test_torch_recovery``)."""
    got, want = _coord_sequence(port), _coord_sequence(ref)
    sealed = [g for g in got if g[1] == "segment_sealed"]
    assert sealed and all("replay_from" in g[2] for g in sealed)
    got = [
        (g[0], g[1], [k for k in g[2] if k != "replay_from"], g[3]) if g[1] == "segment_sealed" else g
        for g in got
    ]
    msgs = {w[1] for w in want if w[0] != "ddl"}
    assert {"subscribe_channel", "segment_sealed", "index_build_task", "index_built",
            "load_segment", "segment_loaded", "load_index"} <= msgs
    assert got == want
