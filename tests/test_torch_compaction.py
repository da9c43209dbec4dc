"""Compaction & GC through the port's ``ManuSystem`` on the CPU.

The first part ports ``tests/test_compaction.py`` case for case (delete-
ratio purge, small-segment merging, the MVCC-safe hot swap, tombstone
pruning, checkpoint-aware GC).  The second runs one seeded workload through
``repro``'s and the port's ``ManuSystem`` and holds them together: the
``compact()`` result dicts and segment-map epochs, the rewritten binlog
bytes key for key (the checkpoints' replay positions excepted, see
``test_torch_recovery``), the coord-channel message sequence, the search answers
before and after the swap and after ``gc()``, the reaped key sets and the
``RestoredCollection`` answers.  Scores within ``SCORE_TOL["l2"]``; pks
exactly, except at near-ties (``testing.assert_topk_near_tie``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core.object_store import FileObjectStore, MemoryObjectStore  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL, ATOL = testing.SCORE_TOL["l2"]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _system(pkg=port, **config):
    kw = {"device": "cpu"} if pkg is port else {}
    return pkg.ManuSystem(pkg.ManuConfig(**config), **kw)


@pytest.fixture
def system():
    return _system(num_query_nodes=2, seal_rows=200, slice_rows=64, num_shards=2)


def ingest(coll, rng, n, dim, batch=200):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    for lo in range(0, n, batch):
        coll.insert({"vector": vecs[lo : lo + batch]})
    return vecs


def live_pks(res):
    return {int(pk) for pk in _np(res.pks).ravel().tolist() if pk >= 0}


def sorted_pks(res):
    return np.sort(_np(res.pks), 1)


# ------------------------------------------------- the reference's cases


def test_end_to_end_compaction_demo(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 800, 8)
    coll.flush()
    sources = system.data_coord.sealed_segments("c")
    assert len(sources) >= 4

    victims = rng.choice(800, 320, replace=False)  # 40% tombstones
    coll.delete(victims)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    after_delete = coll.search(q, limit=10, staleness_ms=0.0)
    assert not set(victims.tolist()) & live_pks(after_delete)
    assert all(len(qn.delta_deletes.get("c", {})) > 0 for qn in system.query_nodes.values())

    epoch_before = system.meta.segment_map().epoch("c")
    report = coll.compact()
    assert report["tasks"] >= 1
    assert report["rows_purged"] == 320
    assert system.meta.segment_map().epoch("c") > epoch_before
    live_map = set(system.meta.segment_map().live("c"))
    assert not live_map & set(sources)
    assert set(system.data_coord.sealed_segments("c")) == live_map

    post = coll.search(q, limit=10, staleness_ms=0.0)
    np.testing.assert_array_equal(sorted_pks(post), sorted_pks(after_delete))

    late_victims = [pk for pk in range(800) if pk not in set(victims.tolist())][:5]
    coll.delete(np.asarray(late_victims))

    deleted_before_gc = system.store.bytes_deleted
    gc_report = coll.gc()
    assert gc_report["bytes"] > 0
    assert system.store.bytes_deleted - deleted_before_gc == gc_report["bytes"]
    assert system.store.delete_count >= len(sources)
    for sid in sources:
        assert not system.store.exists(f"binlog/c/{sid}/meta")
    for qn in system.query_nodes.values():
        assert set(qn.delta_deletes.get("c", {})) <= set(late_victims)

    final = coll.search(q, limit=10, staleness_ms=0.0)
    assert not set(late_victims) & live_pks(final)
    assert not set(victims.tolist()) & live_pks(final)


def test_pinned_query_bit_identical_through_swap(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 600, 8)
    coll.flush()
    coll.delete(rng.choice(600, 240, replace=False))
    q = rng.standard_normal((4, 8)).astype(np.float32)
    pinned = coll.search(q, limit=8, staleness_ms=0.0)
    assert coll.compact()["tasks"] >= 1
    replay = coll.search(q, limit=8, time_travel_ts=pinned.query_ts)
    assert torch.equal(pinned.pks, replay.pks)
    assert torch.equal(pinned.scores, replay.scores)


def test_search_during_compaction_no_dups_no_misses(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 600, 8)
    coll.flush()
    coll.delete(rng.choice(600, 200, replace=False))
    q = rng.standard_normal((2, 8)).astype(np.float32)
    baseline = coll.search(q, limit=10, staleness_ms=0.0)
    assert system.compaction_coord.plan("c")
    for _ in range(200):
        res = coll.search(q, limit=10, staleness_ms=0.0)
        np.testing.assert_array_equal(sorted_pks(res), sorted_pks(baseline))
        for row in _np(res.pks):
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)
        if not system.compaction_coord.pending:
            break
        system.pump()
    assert not system.compaction_coord.pending


def test_small_segment_merge_up_to_seal_size(system, rng):
    coll = system.create_collection("c", dim=8)
    for _ in range(3):
        ingest(coll, rng, 60, 8)
        coll.flush()
    before = system.data_coord.sealed_segments("c")
    assert len(before) >= 4
    q = rng.standard_normal((2, 8)).astype(np.float32)
    pre = coll.search(q, limit=10, staleness_ms=0.0)
    assert coll.compact()["tasks"] >= 1
    assert len(system.data_coord.sealed_segments("c")) < len(before)
    assert sum(system.data_coord._sealed_rows.values()) == 180
    post = coll.search(q, limit=10, staleness_ms=0.0)
    np.testing.assert_array_equal(sorted_pks(pre), sorted_pks(post))


def test_time_travel_checkpoint_survives_gc(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 600, 8)
    coll.flush()
    system.checkpoint_collection("c")
    mark = system.tso.last_issued()
    protected = system.data_coord.sealed_segments("c")

    coll.delete(rng.choice(600, 240, replace=False))
    coll.compact()
    gc_report = coll.gc()
    assert gc_report["protected"] == len(protected)
    assert gc_report["objects"] == 0
    for sid in protected:
        assert system.store.exists(f"binlog/c/{sid}/meta")

    restored = system.restore_collection("c", mark)
    assert restored.num_rows() == 600
    _s, p = restored.search(rng.standard_normal((2, 8)).astype(np.float32), 3)
    assert (p >= 0).all()


def test_index_rebuilt_on_compacted_segment(system, rng):
    coll = system.create_collection("c", dim=8)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 4, "nprobe": 4})
    vecs = ingest(coll, rng, 600, 8)
    coll.flush()
    coll.delete(np.arange(240))
    assert coll.compact()["tasks"] >= 1
    new_live = system.meta.segment_map().live("c")
    for sid in new_live:
        assert system.meta.get(f"index/c/{sid}/vector") is not None
    held = {
        sid: handle
        for qn in system.query_nodes.values()
        for (c, sid), handle in qn.sealed.items()
        if c == "c" and handle.retired_at_ts is None
    }
    assert set(held) == set(new_live)
    assert all(h.index is not None for h in held.values())

    q = rng.standard_normal((2, 8)).astype(np.float32)
    res = coll.search(q, limit=5, staleness_ms=0.0)
    keep = vecs[240:]
    d = np.sum(q**2, 1, keepdims=True) - 2 * q @ keep.T + np.sum(keep**2, 1)
    gt = np.argsort(d, axis=1)[:, :5] + 240
    got = _np(res.pks)
    assert sum(len(set(got[r].tolist()) & set(gt[r].tolist())) for r in range(2)) == 10


def test_concurrent_compaction_nodes_cas_claim(rng):
    system = _system(num_query_nodes=2, num_compaction_nodes=2, seal_rows=200, slice_rows=64)
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 800, 8)
    coll.flush()
    coll.delete(rng.choice(800, 320, replace=False))
    report = coll.compact()
    done = sum(cn.compactions_completed for cn in system.compaction_nodes)
    assert done == report["tasks"] == system.compaction_coord.compactions_completed


def test_isin_sorted_matches_np_isin(rng):
    for n_hay, n_val in ((0, 10), (7, 0), (1, 5), (100, 1000), (1000, 100)):
        hay = np.unique(rng.integers(0, 5000, n_hay))
        vals = rng.integers(0, 5000, n_val)
        got = ops.isin_sorted(torch.from_numpy(vals), torch.from_numpy(hay))
        np.testing.assert_array_equal(got.numpy(), np.isin(vals, hay))


def test_object_store_delete_accounting(tmp_path):
    for store in (MemoryObjectStore(), FileObjectStore(str(tmp_path))):
        store.put("a", b"x" * 100)
        store.put("b", b"y" * 50)
        assert store.delete("a") is True
        assert store.delete("a") is False
        assert store.delete("missing") is False
        assert store.delete_count == 1
        assert store.bytes_deleted == 100


def test_all_rows_dead_leaves_no_phantom_segment(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 400, 8)
    coll.flush()
    coll.delete(np.arange(400))
    report = coll.compact()
    assert report["tasks"] >= 1 and report["rows_purged"] == 400
    assert system.meta.segment_map().live("c") == []
    assert system.data_coord.sealed_segments("c") == []
    assert not system.compaction_coord.tombstones.get("c")
    assert coll.compact()["rows_purged"] == 0
    coll.gc()
    assert not list(system.store.list("binlog/c/"))


def _retired(system, name):
    return [
        key
        for qn in system.query_nodes.values()
        for key, h in qn.sealed.items()
        if key[0] == name and h.retired_at_ts is not None
    ]


def test_gc_is_scoped_per_collection(system, rng):
    a = system.create_collection("a", dim=8)
    b = system.create_collection("b", dim=8)
    for coll in (a, b):
        ingest(coll, rng, 400, 8)
        coll.flush()
        coll.delete(rng.choice(400, 160, replace=False))
        coll.compact()
    assert _retired(system, "a") and _retired(system, "b")
    report = a.gc()
    assert all(c == "a" for c, _sid in report["segments"])
    assert not _retired(system, "a") and _retired(system, "b")
    assert list(system.store.list("binlog/b/"))
    b.gc()
    assert not _retired(system, "b")


def test_failover_preserves_mvcc_gate_of_rewrites(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 400, 8)
    coll.flush()
    coll.delete(rng.choice(400, 160, replace=False))
    coll.compact()
    q = rng.standard_normal((2, 8)).astype(np.float32)
    baseline = coll.search(q, limit=8, staleness_ms=0.0)

    live = system.meta.segment_map().live("c")
    victim = system.query_coord.assignment[("c", live[0])]
    system.kill_query_node(victim)
    system.recover_failures()
    gates = {
        sid: h.visible_from_ts
        for qn in system.query_nodes.values()
        if qn.alive
        for (c, sid), h in qn.sealed.items()
        if c == "c" and sid in live
    }
    assert set(gates) == set(live)
    assert all(ts > 0 for ts in gates.values())
    after = coll.search(q, limit=8, staleness_ms=0.0)
    np.testing.assert_array_equal(sorted_pks(baseline), sorted_pks(after))


def test_retired_handle_serves_until_horizon_then_drops(system, rng):
    coll = system.create_collection("c", dim=8)
    ingest(coll, rng, 400, 8)
    coll.flush()
    coll.delete(rng.choice(400, 160, replace=False))
    coll.compact()
    assert _retired(system, "c")
    coll.gc()
    for qn in system.query_nodes.values():
        assert all(h.retired_at_ts is None for h in qn.sealed.values())


# ------------------------------------ one workload through both packages

PARITY_CFG = dict(num_query_nodes=2, seal_rows=200, slice_rows=64, num_shards=2)


def _coord_messages(system) -> list:
    """The coord channel as (ts, msg, payload) with array values as lists."""

    def plain(v):
        if torch.is_tensor(v):
            return v.tolist()
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    return [
        (e.ts, plain(e.payload))
        for e in system.broker.read("coord", 0)
        if e.payload.get("msg") is not None
    ]


def _objects(store) -> dict:
    return {m.key: store.get(m.key) for m in store.list("")}


def _maintenance(pkg, indexed: bool):
    """The seeded workload: ingest, flush, checkpoint, deletes (a purge
    candidate and fragments), compact, a late delete, gc, restore."""
    system = _system(pkg, **PARITY_CFG)
    coll = system.create_collection(
        "c", dim=8, extra_fields=[pkg.FieldSchema("price", pkg.FieldType.FLOAT)]
    )
    if indexed:
        coll.create_index("vector", kind="ivf_flat", params={"nlist": 4, "nprobe": 4})
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((900, 8)).astype(np.float32)
    price = rng.uniform(0, 100, 900)
    for lo in range(0, 800, 200):
        coll.insert({"vector": vecs[lo:lo + 200], "price": price[lo:lo + 200]})
    coll.flush()
    system.checkpoint_collection("c")
    mark = system.tso.last_issued()
    coll.insert({"vector": vecs[800:], "price": price[800:]})
    coll.flush()  # two ~50-row fragments
    coll.delete(np.arange(0, 160))
    q = rng.standard_normal((4, 8)).astype(np.float32)
    out = {"q": q}
    out["before"] = coll.search(q, limit=10, staleness_ms=0.0)
    out["filtered_before"] = coll.query(q, limit=10, expr="price < 50", staleness_ms=0.0)
    out["epoch_before"] = system.meta.segment_map().epoch("c")
    out["compact"] = coll.compact()
    out["epoch_after"] = system.meta.segment_map().epoch("c")
    out["binlogs"] = _objects(system.store)
    out["pinned"] = coll.search(q, limit=10, time_travel_ts=out["before"].query_ts)
    out["after"] = coll.search(q, limit=10, staleness_ms=0.0)
    out["filtered_after"] = coll.query(q, limit=10, expr="price < 50", staleness_ms=0.0)
    coll.delete(np.arange(160, 170))
    out["gc"] = coll.gc()
    out["after_gc"] = coll.search(q, limit=10, staleness_ms=0.0)
    out["coord"] = _coord_messages(system)
    out["events"] = [(e.kind, e.detail) for e in system.events()
                     if e.kind in ("compaction_task", "compaction_done", "segment_hot_swap",
                                   "gc_reap")]
    restored = system.restore_collection("c", mark)
    out["restored_rows"] = restored.num_rows()
    out["restored_pks"] = _np(restored.pks())
    out["restored"] = restored.search(q, 10)
    out["stats"] = {k: system.stats()[k] for k in ("compactions", "rows_purged", "gc_bytes_reclaimed")}
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["brute", "ivf_flat"])
def both(request):
    return _maintenance(ref, request.param), _maintenance(port, request.param)


def _index_bytes(run, segments) -> int:
    """Bytes of the index objects of ``segments`` before the GC: index
    builds are held to the reference by their answers, not their bytes."""
    return sum(
        len(blob) for key, blob in run["binlogs"].items()
        for _c, sid in segments if key.startswith(f"index/c/{sid}/")
    )


def test_parity_compact_report_and_epochs(both):
    want, got = both
    assert got["compact"] == want["compact"]
    assert got["compact"]["tasks"] == 2 and got["compact"]["rows_purged"] == 160
    assert (got["epoch_before"], got["epoch_after"]) == (want["epoch_before"], want["epoch_after"])
    for run in (got, want):
        run["stats"]["gc_bytes_reclaimed"] -= _index_bytes(run, run["gc"]["segments"])
    assert got["stats"] == want["stats"]


def test_parity_rewritten_binlog_bytes_key_for_key(both):
    want, got = both
    assert sorted(got["binlogs"]) == sorted(want["binlogs"])
    for key, blob in want["binlogs"].items():
        if key.startswith(("binlog/", "attr/")):
            assert got["binlogs"][key] == blob, key
        elif key.startswith("checkpoint/"):
            # The same segment map; each shard's replay position is the
            # data node's replay_from, at most the reference's
            # checkpoint_pos + 1 (ROADMAP Queue 3).
            g, w = (json.loads(b) for b in (got["binlogs"][key], blob))
            gpos, wpos = g.pop("replay_positions"), w.pop("replay_positions")
            assert g == w
            assert sorted(gpos) == sorted(wpos)
            assert all(gpos[ch] <= wpos[ch] for ch in wpos)


def test_parity_coord_message_sequence(both):
    want, got = both
    assert [(ts, p["msg"]) for ts, p in got["coord"]] == [(ts, p["msg"]) for ts, p in want["coord"]]
    for (_ts, gp), (_tw, wp) in zip(got["coord"], want["coord"]):
        if gp["msg"] in ("compaction_task", "segment_compacted", "retire_segment",
                         "tombstones_folded", "retention_advance", "segment_gc"):
            assert gp == wp, gp["msg"]

    def events(run):  # the GC's bytes include index objects (see _index_bytes)
        return [(kind, {k: v for k, v in d.items() if k != "bytes"}) for kind, d in run["events"]]

    assert events(got) == events(want)


@pytest.mark.parametrize(
    "label", ["before", "filtered_before", "pinned", "after", "filtered_after", "after_gc"]
)
def test_parity_answers_through_swap_and_gc(both, label):
    want, got = both
    testing.assert_topk_near_tie(
        (got[label].scores, got[label].pks),
        (torch.from_numpy(np.asarray(want[label].scores)), torch.from_numpy(np.asarray(want[label].pks))),
        RTOL, ATOL,
    )
    if label == "pinned":
        assert torch.equal(got["pinned"].pks, got["before"].pks)
        assert torch.equal(got["pinned"].scores, got["before"].scores)
    if label in ("after", "after_gc"):
        assert not live_pks(got[label]) & set(range(160 if label == "after" else 170))


def test_parity_gc_reaped_keys(both):
    want, got = both
    assert got["gc"]["segments"] and got["gc"]["protected"] > 0
    assert {k: v for k, v in got["gc"].items() if k != "bytes"} == {
        k: v for k, v in want["gc"].items() if k != "bytes"
    }
    assert got["gc"]["bytes"] - _index_bytes(got, got["gc"]["segments"]) == (
        want["gc"]["bytes"] - _index_bytes(want, want["gc"]["segments"])
    )


def test_parity_restored_collection(both):
    want, got = both
    assert got["restored_rows"] == want["restored_rows"] == 800
    np.testing.assert_array_equal(got["restored_pks"], want["restored_pks"])
    ws, wp = want["restored"]
    testing.assert_topk_near_tie(got["restored"], (torch.from_numpy(ws), torch.from_numpy(wp)),
                                 RTOL, ATOL)


# --------------------------------------- the helpers, held to the reference


def _pair(n=60, dim=6, seed=3, extras=True):
    """One seeded segment history in each package: rows with an extra
    column, a delete, an upsert-style re-delete, a checkpoint position."""
    from repro.core.segment import Segment as RefSegment
    from repro_torch.core.segment import Segment

    rng = np.random.default_rng(seed)
    pks = np.arange(100, 100 + n)
    vec = rng.standard_normal((n, dim)).astype(np.float32)
    ts = np.arange(10, 10 + n, dtype=np.int64)
    price = rng.uniform(0, 10, n)
    out = []
    for seg in (RefSegment(7, "c", 1, dim, slice_rows=16, extra_fields=("price",) if extras else (),
                           partition="p"),
                Segment(7, "c", 1, dim, slice_rows=16, extra_fields=("price",) if extras else (),
                        partition="p", device="cpu")):
        seg.append(pks, vec, ts, {"price": price} if extras else None)
        seg.delete(pks[[1, 5, 9]], ts=40)
        seg.delete(pks[[5]], ts=55)
        seg.checkpoint_pos = 13
        seg.seal()
        out.append(seg)
    return out


def test_segment_helpers_match_reference():
    want, got = _pair()
    assert got.tail_rows() == want.tail_rows()
    assert got.deleted_fraction() == want.deleted_fraction()
    assert vars(got.stats()) == vars(want.stats())


def test_segment_single_blob_binlog_cross_loads():
    from repro.core.segment import Segment as RefSegment
    from repro_torch.core.segment import Segment

    want, got = _pair()
    for blob, cls, kw in ((want.to_binlog(), Segment, {"device": "cpu"}),
                          (got.to_binlog(), RefSegment, {})):
        seg = cls.from_binlog("c", blob, slice_rows=16, **kw)
        assert (seg.segment_id, seg.shard, seg.dim, seg.checkpoint_pos, seg.partition) == (
            7, 1, 6, 13, "p")
        for ts in (0, 39, 40, 54, 55, 10**9):
            np.testing.assert_array_equal(_np(seg.visible_mask(ts)), _np(want.visible_mask(ts)))
        np.testing.assert_array_equal(_np(seg.vectors()), _np(want.vectors()))
        np.testing.assert_array_equal(np.asarray(seg.extra("price")), want.extra("price"))


def test_merge_segments_matches_reference():
    from repro.core.segment import merge_segments as ref_merge
    from repro_torch.core.segment import merge_segments

    (wa, ga), (wb, gb) = _pair(seed=3), _pair(seed=4)
    want, got = ref_merge(99, [wa, wb]), merge_segments(99, [ga, gb])
    assert got.num_rows == want.num_rows == 2 * 60 - 2 * 3
    assert got.state.value == "sealed" and got.checkpoint_pos == want.checkpoint_pos
    for col in ("pks", "vectors", "timestamps"):
        np.testing.assert_array_equal(_np(getattr(got, col)()), getattr(want, col)())
    np.testing.assert_array_equal(np.asarray(got.extra("price")), want.extra("price"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prune_folded_matches_reference(seed):
    from repro.core.compaction import prune_folded as ref_prune
    from repro.core.segment import add_tombstone
    from repro_torch.core.compaction import prune_folded

    rng = np.random.default_rng(seed)
    dd: dict = {}
    for pk, ts in zip(rng.integers(0, 50, 80).tolist(), rng.integers(1, 100, 80).tolist()):
        add_tombstone(dd, pk, ts)
    folded = np.unique(rng.integers(0, 50, 20))
    for cut in (0, 50, 100):
        assert prune_folded(dict(dd), folded, cut) == ref_prune(dict(dd), folded, cut)
    assert prune_folded({}, folded, 50) is None and prune_folded(dd, np.empty(0, np.int64), 50) is None


def test_log_retention_and_replay_match_reference():
    import threading

    from repro.core import log as ref_log
    from repro_torch.core import log as port_log

    def fill(mod):
        b = mod.LogBroker()
        b.create_channel("dml/c/0")
        for ts in range(1, 13):
            kind = mod.EntryType.TIME_TICK if ts % 3 == 0 else mod.EntryType.DELETE
            b.publish("dml/c/0", mod.LogEntry(ts=ts, type=kind, payload={"pk": np.arange(ts)}))
        return b

    got, want = fill(port_log), fill(ref_log)
    assert [e.ts for e in got.entries_between("dml/c/0", 2, 10)] == [
        e.ts for e in want.entries_between("dml/c/0", 2, 10)] == [4, 5, 7, 8, 10]
    assert got.truncate_before("dml/c/0", 6) == want.truncate_before("dml/c/0", 6) == 5
    assert [e.ts for e in got.read("dml/c/0", 0)] == [e.ts for e in want.read("dml/c/0", 0)]
    assert got.wait_for_tick("dml/c/0", 12, timeout_s=0.0)
    assert not got.wait_for_tick("dml/c/0", 20, timeout_s=0.01)
    later = threading.Timer(0.05, lambda: got.publish(
        "dml/c/0", port_log.LogEntry(ts=21, type=port_log.EntryType.TIME_TICK, payload={})))
    later.start()
    assert got.wait_for_tick("dml/c/0", 20, timeout_s=5.0)
    later.join()


def test_attr_satellites_rebuild_and_list_match_reference():
    from repro.core import binlog as ref_binlog
    from repro.core.object_store import MemoryObjectStore as RefStore
    from repro_torch.core import binlog

    want_seg, got_seg = _pair()
    ref_store, store = RefStore(), MemoryObjectStore()
    ref_binlog.write_segment_binlog(ref_store, want_seg)
    binlog.write_segment_binlog(store, got_seg)
    want = ref_binlog.rebuild_attr_satellites(ref_store, "c", 7)
    got = binlog.rebuild_attr_satellites(store, "c", 7)
    assert got == want and set(got) == {"pk", "price"}
    for key in got.values():
        assert store.get(key) == ref_store.get(key)
    assert binlog.list_segments(store, "c") == ref_binlog.list_segments(ref_store, "c") == [7]
