"""Dropping a partition through the port's ManuSystem against ``repro``:
the pks that lived only in the dropped partition are broadcast as
``tombstones_folded`` (one TSO tick, ``compact_ts`` = the drop ts), every
query node records them for pruning, and the next mutation's timestamp and
a STRONG search afterwards equal the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402

DIM = 8


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _run(pkg):
    kw = {"device": "cpu"} if pkg is port else {}
    manu = pkg.ManuSystem(pkg.ManuConfig(num_query_nodes=2, seal_rows=200, slice_rows=64), **kw)
    coll = manu.create_collection("c", dim=DIM)
    for part in ("hot", "cold"):
        coll.create_partition(part)
    rng = np.random.default_rng(11)
    hot = coll.insert(pkg.InsertRequest(
        {"vector": rng.standard_normal((260, DIM)).astype(np.float32)}, partition="hot"))
    cold = coll.insert(pkg.InsertRequest(
        {"vector": rng.standard_normal((330, DIM)).astype(np.float32)}, partition="cold"))
    coll.flush()  # sealed segments in both partitions, growing tails too
    coll.insert(pkg.InsertRequest(
        {"vector": rng.standard_normal((40, DIM)).astype(np.float32)}, partition="cold"))
    coll.delete(np.concatenate([hot.pks[:5], cold.pks[:3]]))
    start = len(manu.broker.read("coord", 0))
    coll.drop_partition("cold")
    coord = manu.broker.read("coord", 0)[start:]
    after = coll.insert(pkg.InsertRequest(
        {"vector": rng.standard_normal((30, DIM)).astype(np.float32)}, partition="hot"))
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    res = coll.search(pkg.SearchRequest.single(q, k=20, consistency=pkg.ConsistencyLevel.STRONG))
    prunes = [node._pending_prunes for node in manu.query_nodes.values()]
    return {"coord": coord, "after": after, "res": res, "prunes": prunes}


@pytest.fixture(scope="module")
def runs():
    return {"ref": _run(ref), "port": _run(port)}


def test_drop_partition_coord_messages_match_reference(runs):
    got, want = runs["port"]["coord"], runs["ref"]["coord"]
    assert [(e.ts, e.payload["msg"]) for e in got] == [(e.ts, e.payload["msg"]) for e in want]
    folded = [e.payload for e in want if e.payload["msg"] == "tombstones_folded"]
    assert len(folded) == 1 and folded[0]["folded_pks"].size > 0
    for g, w in zip(got, want):
        assert sorted(g.payload) == sorted(w.payload)
        for key, val in w.payload.items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(g.payload[key], val)
            else:
                assert g.payload[key] == val, key


def test_drop_partition_keeps_reference_timestamps_and_answers(runs):
    got, want = runs["port"], runs["ref"]
    assert got["after"].watermark_ts == want["after"].watermark_ts
    assert got["after"].shard_lsns == want["after"].shard_lsns
    np.testing.assert_array_equal(got["after"].pks, want["after"].pks)
    gr, wr = got["res"], want["res"]
    assert gr.query_ts == wr.query_ts
    np.testing.assert_array_equal(_np(gr.pks), _np(wr.pks))
    np.testing.assert_allclose(_np(gr.scores), _np(wr.scores), rtol=1e-5, atol=1e-4)


def test_query_nodes_record_folded_tombstones_like_reference(runs):
    got, want = runs["port"]["prunes"], runs["ref"]["prunes"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(p["collection"], p["compact_ts"]) for p in g] == [
            (p["collection"], p["compact_ts"]) for p in w]
        assert len(w) == 1
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp["folded_pks"], wp["folded_pks"])
