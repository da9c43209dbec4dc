"""The port's bucket and HNSW indexes and its BOHB auto-tuner against the
reference's, on the CPU.

Bucket searches run on the SAME index state in both directions (the
reference builds and saves, the port loads and searches; the port builds
and saves, the reference loads and searches) for L2, IP and cosine, SQ
payload and float payload, with and without a validity mask.  Builds are
held as ``tests/test_torch_index.py`` holds the IVF builds (same buckets
and slot order, centres within atol=1e-4, codes within one step) and
structurally: every row in ``replicas`` buckets, no bucket above 128 rows,
recall@10 at least ``tests/test_index.py``'s 0.70.  The HNSW graph is the
reference's numpy code on the host, so levels, entry point and every
neighbour list must be bit-identical, and so must the searches.  BOHB's
first rung proposes the reference's configurations.  A small bucket and
HNSW collection answers the same through both ``ManuSystem``s.

Tolerance for searches: ``repro_torch.testing.SCORE_TOL`` per metric
(float32 scores summed in another order); ids exact except at near-ties
(``repro_torch.testing.assert_topk_near_tie``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402  (the reference's index package imports its core first)
from repro.core.collection import Metric as RefMetric  # noqa: E402
from repro.index.autotune import bohb_tune as ref_bohb  # noqa: E402
from repro.index.base import IndexSpec as RefSpec  # noqa: E402
from repro.index.base import VectorIndex as RefVectorIndex  # noqa: E402
from repro.index.registry import create_index as ref_create  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core.collection import Metric  # noqa: E402
from repro_torch.index import INDEX_KINDS  # noqa: E402
from repro_torch.index.autotune import bohb_tune  # noqa: E402
from repro_torch.index.base import IndexSpec, VectorIndex  # noqa: E402
from repro_torch.index.bucket import BUCKET_ROW_QUANTUM  # noqa: E402
from repro_torch.index.registry import create_index  # noqa: E402
from repro_torch.testing import SCORE_TOL, assert_topk_near_tie  # noqa: E402

K = 10
METRICS = ("l2", "ip", "cosine")
BUCKET = {"target_bucket_rows": 48, "replicas": 2, "nprobe_buckets": 6}
HNSW = {"m": 8, "ef_construction": 40, "ef_search": 32}


def _clustered(seed, n, d, n_centers=16, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * spread
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return {
        "x": _clustered(1, 1_200, 16),
        "q": _clustered(2, 7, 16),
        "valid": rng.random(1_200) > 0.3,
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _bucket_params(compress):
    return {**BUCKET, "compress": compress}


_REF_CACHE: dict = {}


def _ref_bucket(metric, compress, x):
    key = (metric, compress)
    if key not in _REF_CACHE:
        idx = ref_create(RefSpec("bucket", RefMetric(metric), _bucket_params(compress)))
        idx.build(x)
        _REF_CACHE[key] = idx
    return _REF_CACHE[key]


def test_registry_builds_every_reference_kind():
    from repro.index.registry import INDEX_KINDS as REF_KINDS

    assert sorted(INDEX_KINDS) == sorted(REF_KINDS)


# ------------------------------------------------------------------ bucket


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("compress", [True, False], ids=["sq", "f32"])
@pytest.mark.parametrize("metric", METRICS)
def test_bucket_search_from_reference_bytes_matches(data, metric, compress, masked):
    ref_idx = _ref_bucket(metric, compress, data["x"])
    got = VectorIndex.load(ref_idx.save(), device="cpu")
    assert got.KIND == "bucket" and got.metric is Metric(metric)
    assert got.num_rows == ref_idx.num_rows and got.compress is compress
    valid = data["valid"] if masked else None
    want = ref_idx.search(data["q"], K, valid=valid)
    gs, gi = got.search(_t(data["q"]), K, valid=None if valid is None else _t(valid))
    assert gs.dtype == torch.float32 and gi.dtype == torch.int64 and gs.shape == (7, K)
    assert_topk_near_tie((gs, gi), tuple(map(_t, want)), *SCORE_TOL[metric])
    if masked:
        assert data["valid"][gi.numpy()[gi.numpy() >= 0]].all()


@pytest.mark.parametrize("compress", [True, False], ids=["sq", "f32"])
@pytest.mark.parametrize("metric", METRICS)
def test_bucket_port_bytes_load_in_reference(data, metric, compress):
    idx = create_index(IndexSpec("bucket", Metric(metric), _bucket_params(compress)), device="cpu")
    idx.build(_t(data["x"]))
    blob = idx.save()
    back = RefVectorIndex.load(blob)
    assert back.KIND == "bucket" and back.num_rows == idx.num_rows == len(data["x"])
    mine, theirs = idx._state(), back._state()
    assert sorted(mine) == sorted(theirs)
    for name, arr in mine.items():
        assert arr.dtype == np.asarray(theirs[name]).dtype, name
        np.testing.assert_array_equal(arr, theirs[name], err_msg=name)
    for valid in (None, data["valid"]):
        want = back.search(data["q"], K, valid=valid)
        got = idx.search(_t(data["q"]), K, valid=None if valid is None else _t(valid))
        assert_topk_near_tie(got, tuple(map(_t, want)), *SCORE_TOL[metric])
    assert idx.save() == blob  # the bytes depend on the state alone


@pytest.mark.parametrize("compress", [True, False], ids=["sq", "f32"])
def test_bucket_build_matches_reference(data, compress):
    """The same hierarchical clusterings (bucket offsets and slot rows
    exact, centres within atol=1e-4: float32 means in another order); the
    payload exactly (float) or within one code step (SQ)."""
    w = _ref_bucket("l2", compress, data["x"])._state()
    idx = create_index(IndexSpec("bucket", Metric.L2, _bucket_params(compress)), device="cpu")
    idx.build(_t(data["x"]))
    g = idx._state()
    np.testing.assert_array_equal(g["bucket_offsets"], w["bucket_offsets"])
    np.testing.assert_array_equal(g["bucket_rows"], w["bucket_rows"])
    np.testing.assert_allclose(g["centers"], w["centers"], rtol=0, atol=1e-4)
    if compress:
        np.testing.assert_array_equal(g["vmin"], w["vmin"])
        np.testing.assert_array_equal(g["vmax"], w["vmax"])
        assert np.abs(g["storage"].astype(int) - w["storage"].astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(g["storage"], w["storage"])


def _brute_force(base, queries, k):
    d = np.sum(queries**2, 1, keepdims=True) - 2 * queries @ base.T + np.sum(base**2, 1)
    return np.argsort(d, axis=1)[:, :k]


def _recall(idx, gt):
    return sum(len(set(idx[r].tolist()) & set(gt[r].tolist())) for r in range(len(gt))) / gt.size


def test_bucket_build_structure_and_recall():
    """``tests/test_index.py``'s bucket case at 2,000 x 32: every row in
    ``replicas`` buckets, no bucket above the 128-row quantum, recall@10 at
    least 0.70 at nprobe_buckets 16, and the reference's recall on the same
    rows within 0.05."""
    base = _clustered(7, 2_000, 32, n_centers=20, spread=4.0)
    queries = _clustered(8, 16, 32, n_centers=20, spread=4.0)
    params = {"target_bucket_rows": 96, "replicas": 2, "nprobe_buckets": 16}
    idx = create_index(IndexSpec("bucket", Metric.L2, params), device="cpu")
    idx.build(_t(base))
    rows = idx.bucket_rows.numpy()
    assert (np.bincount(rows, minlength=len(base)) == 2).all()
    sizes = np.diff(idx.bucket_offsets.numpy())
    assert sizes.min() > 0 and sizes.max() <= BUCKET_ROW_QUANTUM
    gt = _brute_force(base, queries, K)
    got = _recall(idx.search(_t(queries), K)[1].numpy(), gt)
    ref_idx = ref_create(RefSpec("bucket", RefMetric.L2, params))
    ref_idx.build(base)
    want = _recall(ref_idx.search(queries, K)[1], gt)
    assert got >= 0.70 and abs(got - want) <= 0.05, (got, want)


def test_bucket_search_equals_per_bucket_scans(data):
    """The batched search (one segmented scan per query, one merge) equals
    the reference's loop run on the port's ops: a scan per (query, probed
    bucket) at k_b = min(k, rows), a stable sort, a ``seen`` set."""
    from repro_torch.kernels import ops

    idx = VectorIndex.load(_ref_bucket("l2", True, data["x"]).save(), device="cpu")
    q = _t(data["q"])
    valid = _t(data["valid"])
    gs, gi = idx.search(q, K, valid=valid)
    _cs, probes = ops.topk_scan(q, idx.centers, BUCKET["nprobe_buckets"])
    vs_all = valid[idx.bucket_rows]
    off = idx.bucket_offsets.tolist()
    for r in range(len(q)):
        cand = []
        for b in probes[r].tolist():
            lo, hi = off[b], off[b + 1]
            s, i = ops.sq_topk_scan(q[r : r + 1], idx.storage[lo:hi], idx.vmin, idx.vmax,
                                    min(K, hi - lo), valid=vs_all[lo:hi])
            cand += [(float(sv), int(idx.bucket_rows[lo + iv])) for sv, iv in zip(s[0], i[0]) if iv >= 0]
        seen, want = set(), []
        for sv, row in sorted(cand, key=lambda t: t[0]):  # stable
            if row not in seen:
                seen.add(row)
                want.append((sv, row))
        want = want[:K]
        n = len(want)
        assert gi[r, :n].tolist() == [row for _, row in want]
        assert gs[r, :n].tolist() == [sv for sv, _ in want]
        assert (gi[r, n:] == -1).all()


def test_bucket_oracle_unit_matches_search(data):
    """``testing.oracle_unit``'s bucket branch (float64 scores of every
    probed slot, each row's best) agrees with the index's own search."""
    idx = VectorIndex.load(_ref_bucket("l2", True, data["x"]).save(), device="cpu")
    q, valid = _t(data["q"]), _t(data["valid"])
    s = testing.oracle_unit(idx, q, valid)
    vals, order = torch.sort(s, dim=1, stable=True)
    want_p = torch.where(torch.isfinite(vals[:, :K]), order[:, :K], -1)
    got = idx.search(q, K, valid=valid)
    assert_topk_near_tie(got, (vals[:, :K].float(), want_p), *SCORE_TOL["l2"])


# -------------------------------------------------------------------- HNSW


@pytest.fixture(scope="module")
def hnsw_data():
    return {"x": _clustered(11, 600, 32), "q": _clustered(12, 6, 32)}


_HNSW_CACHE: dict = {}


def _hnsw_pair(metric, x):
    if metric not in _HNSW_CACHE:
        ref_idx = ref_create(RefSpec("hnsw", RefMetric(metric), dict(HNSW)))
        ref_idx.build(x)
        idx = create_index(IndexSpec("hnsw", Metric(metric), dict(HNSW)), device="cpu")
        idx.build(_t(x))
        _HNSW_CACHE[metric] = (ref_idx, idx)
    return _HNSW_CACHE[metric]


@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_graph_is_the_reference_graph(hnsw_data, metric):
    ref_idx, idx = _hnsw_pair(metric, hnsw_data["x"])
    np.testing.assert_array_equal(idx.levels, ref_idx.levels)
    assert idx.entry_point == ref_idx.entry_point
    assert len(idx.graph) == len(ref_idx.graph)
    for g, w in zip(idx.graph, ref_idx.graph):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(idx.vectors, ref_idx.vectors)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_search_matches_reference(hnsw_data, metric, masked):
    """Bit-identical answers, both ways through the saved bytes; with the
    mask of ``tests/test_index.py``'s HNSW case (every other row), every
    returned row is valid."""
    ref_idx, idx = _hnsw_pair(metric, hnsw_data["x"])
    valid = None
    if masked:
        valid = np.zeros(len(hnsw_data["x"]), bool)
        valid[::2] = True
    ws, wi = ref_idx.search(hnsw_data["q"], K, valid=valid)
    for index in (idx, VectorIndex.load(ref_idx.save(), device="cpu")):
        gs, gi = index.search(_t(hnsw_data["q"]), K, valid=None if valid is None else _t(valid))
        assert gs.dtype == torch.float32 and gi.dtype == torch.int64
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gs.numpy(), ws)
    back = RefVectorIndex.load(idx.save())
    bs, bi = back.search(hnsw_data["q"], K, valid=valid)
    np.testing.assert_array_equal(bi, wi)
    np.testing.assert_array_equal(bs, ws)
    if masked:
        assert (wi[wi >= 0] % 2 == 0).all()


# -------------------------------------------------------------------- BOHB


@pytest.fixture(scope="module")
def tune_data():
    return {"base": _clustered(7, 2_000, 32, n_centers=20, spread=4.0),
            "queries": _clustered(8, 8, 32, n_centers=20, spread=4.0)}


def test_bohb_first_rung_proposals_match_reference(tune_data):
    kw = dict(k=10, max_trials=6, min_budget_rows=500, seed=3)
    got = bohb_tune("ivf_flat", tune_data["base"], tune_data["queries"], device="cpu", **kw)
    want = ref_bohb("ivf_flat", tune_data["base"], tune_data["queries"], **kw)
    first = max(2, kw["max_trials"] // 2)  # the initial ladder
    assert [t.config for t in got.trials[:first]] == [t.config for t in want.trials[:first]]
    assert [t.budget_rows for t in got.trials] == [t.budget_rows for t in want.trials]
    for g, w in zip(got.trials[:first], want.trials[:first]):
        assert abs(g.recall - w.recall) <= 0.05


def test_bohb_finds_working_config(tune_data):
    """``tests/test_index.py``'s BOHB case on the port."""
    res = bohb_tune("ivf_flat", tune_data["base"], tune_data["queries"], k=10, max_trials=6,
                    min_budget_rows=500, seed=3, device="cpu")
    assert res.best_config["nlist"] in [16, 32, 64, 128, 256]
    assert len(res.trials) == 6 and all(0.0 <= t.recall <= 1.0 for t in res.trials)


@pytest.mark.parametrize("kind", ["bucket", "hnsw"])
def test_bohb_tunes_the_new_kinds(kind):
    base = _clustered(9, 600, 16)
    queries = _clustered(10, 4, 16)
    space = {"bucket": {"target_bucket_rows": [48, 96], "replicas": [1, 2],
                        "nprobe_buckets": [4, 8]},
             "hnsw": {"m": [8], "ef_construction": [20, 40], "ef_search": [16, 32]}}[kind]
    from repro_torch.index.autotune import ParamSpace

    res = bohb_tune(kind, base, queries, k=5, max_trials=3, min_budget_rows=300, seed=1,
                    space=ParamSpace(space), device="cpu")
    assert len(res.trials) == 3 and res.best_config in [t.config for t in res.trials]
    assert max(t.recall for t in res.trials) >= 0.5


# ------------------------------------------------------------------ facade

SYSTEM = dict(num_query_nodes=2, num_index_nodes=1, seal_rows=400, slice_rows=128)
FAMILY = {"bucket": {"target_bucket_rows": 48, "replicas": 2, "nprobe_buckets": 4},
          "hnsw": dict(HNSW)}


def _family_collection(pkg, kind):
    kw = {"device": "cpu"} if pkg is port else {}
    manu = pkg.ManuSystem(pkg.ManuConfig(**SYSTEM), **kw)
    coll = manu.create_collection("fam", dim=16)
    coll.create_index("vector", kind=kind, params=dict(FAMILY[kind]))
    x = _clustered(21, 1_000, 16)
    for lo in range(0, 800, 200):
        coll.insert({"vector": x[lo:lo + 200]})
    coll.flush()
    coll.insert({"vector": x[800:]})
    rng = np.random.default_rng(5)
    doomed = rng.choice(1_000, 40, replace=False)
    coll.delete(doomed)
    q = _clustered(22, 5, 16)
    out = {
        "strong": coll.search(q, limit=K, staleness_ms=0.0),
        "time_travel": None,
    }
    out["time_travel"] = coll.search(q, limit=K, time_travel_ts=out["strong"].query_ts - 1)
    kinds = sorted(h.index.KIND for n in manu.query_nodes.values() for h in n.sealed.values()
                   if h.index is not None)
    return {"out": out, "doomed": doomed, "kinds": kinds, "manu": manu, "q": q}


@pytest.mark.parametrize("kind", ["bucket", "hnsw"])
def test_family_collection_matches_reference(kind):
    got, want = _family_collection(port, kind), _family_collection(ref, kind)
    assert got["kinds"] == want["kinds"] and got["kinds"].count(kind) == 2
    rtol, atol = SCORE_TOL["l2"]
    for name in ("strong", "time_travel"):
        g, w = got["out"][name], want["out"][name]
        assert torch.is_tensor(g.pks) and g.query_ts == w.query_ts
        assert_topk_near_tie((g.scores, g.pks), (_t(w.scores), _t(w.pks)), rtol, atol)
    assert not torch.isin(got["out"]["strong"].pks, _t(got["doomed"])).any()
    if kind == "bucket":  # the port's own float64 oracle over what its nodes hold
        nodes = list(got["manu"].query_nodes.values())
        res = got["out"]["strong"]
        oracle = testing.system_oracle(nodes, "fam", _t(got["q"]), K, res.query_ts,
                                       _t(got["doomed"]))
        testing.assert_oracle_answer("bucket", (res.scores, res.pks), oracle, rtol, atol)
