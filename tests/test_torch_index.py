"""The port's SQ, PQ, OPQ, IVF-FLAT, IVF-SQ and IVF-PQ indexes against the
reference's, on the CPU.

Search and build are held apart.  Searches run on the SAME index state:
the reference builds and saves, the port loads those bytes and both answer
the same queries (L2, IP, cosine; with and without a validity mask; IVF at
nprobe 1 and nprobe = nlist); the port's saved bytes load in the reference
with equal state.  ``search_batched`` blocks must equal per-index
``search``, and the batched IVF pipeline must equal the per-list
``_search_reference`` oracle.  Builds (k-means on the device) are compared
separately, with the tolerance stated at each test.

Tolerance for searches: scores rtol=1e-5, atol=1e-4 (float32 products and
tables summed in another order); ids exact except at near-ties
(``repro_torch.testing.assert_topk_near_tie``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (the reference's index package imports its core first)
from repro.core.collection import Metric as RefMetric  # noqa: E402
from repro.index import kmeans as ref_kmeans  # noqa: E402
from repro.index.base import IndexSpec as RefSpec  # noqa: E402
from repro.index.base import VectorIndex as RefVectorIndex  # noqa: E402
from repro.index.registry import create_index as ref_create  # noqa: E402
from repro_torch.core.collection import Metric  # noqa: E402
from repro_torch.index import kmeans  # noqa: E402
from repro_torch.index.base import IndexSpec, VectorIndex  # noqa: E402
from repro_torch.index.registry import create_index  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.testing import assert_topk_near_tie  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
K = 10
KINDS = {
    "sq": {},
    "pq": {"m": 4, "ksub": 16},
    "opq": {"m": 4, "ksub": 16},
    "ivf_flat": {"nlist": 8, "nprobe": 3},
    "ivf_sq": {"nlist": 8, "nprobe": 3},
    "ivf_pq": {"nlist": 8, "nprobe": 3, "m": 4, "ksub": 16},
}
IVF = ("ivf_flat", "ivf_sq", "ivf_pq")
METRICS = ("l2", "ip", "cosine")
SEARCH_CASES = [(kind, None) for kind in KINDS if kind not in IVF] + [
    (kind, nprobe) for kind in IVF for nprobe in (1, "nlist")
]


def _clustered(seed, n, d=16, n_centers=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {
        "x": _clustered(5, 400),
        "q": _clustered(6, 7),
        "valid": rng.random(400) > 0.25,
    }


_REF_CACHE: dict = {}


def _ref_index(kind, metric, x):
    """The reference's index of one kind and metric, built once."""
    key = (kind, metric)
    if key not in _REF_CACHE:
        idx = ref_create(RefSpec(kind, RefMetric(metric), dict(KINDS[kind])))
        idx.build(x)
        _REF_CACHE[key] = idx
    return _REF_CACHE[key]


def _t(a):
    return torch.from_numpy(np.array(a))


def _set_nprobe(indexes, nprobe):
    for idx in indexes:
        idx.params["nprobe"] = idx.nlist if nprobe == "nlist" else nprobe


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind,nprobe", SEARCH_CASES)
def test_search_from_reference_bytes_matches(data, kind, nprobe, metric, masked):
    ref = _ref_index(kind, metric, data["x"])
    got = VectorIndex.load(ref.save(), device="cpu")
    assert got.KIND == kind and got.metric is Metric(metric) and got.num_rows == len(data["x"])
    if nprobe is not None:
        _set_nprobe([ref, got], nprobe)
    valid = data["valid"] if masked else None
    try:
        want = ref.search(data["q"], K, valid=valid)
    finally:
        if nprobe is not None:
            ref.params["nprobe"] = KINDS[kind]["nprobe"]
    gs, gi = got.search(_t(data["q"]), K, valid=None if valid is None else _t(valid))
    assert gs.dtype == torch.float32 and gi.dtype == torch.int64
    assert_topk_near_tie((gs, gi), tuple(map(_t, want)), RTOL, ATOL)
    if masked:
        assert data["valid"][gi.numpy()[gi.numpy() >= 0]].all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_port_bytes_load_in_reference(data, kind, metric):
    idx = create_index(IndexSpec(kind, Metric(metric), dict(KINDS[kind])), device="cpu")
    idx.build(_t(data["x"]))
    blob = idx.save()
    back = RefVectorIndex.load(blob)
    assert back.KIND == kind and back.num_rows == idx.num_rows
    mine = idx._state()
    theirs = back._state()
    assert sorted(mine) == sorted(theirs)
    for name, arr in mine.items():
        assert arr.dtype == np.asarray(theirs[name]).dtype, name
        np.testing.assert_array_equal(arr, theirs[name], err_msg=name)
    want = back.search(data["q"], K)
    got = idx.search(_t(data["q"]), K)
    assert_topk_near_tie(got, tuple(map(_t, want)), RTOL, ATOL)
    assert idx.save() == blob  # the bytes depend on the state alone


@pytest.mark.parametrize("kind", list(KINDS))
def test_search_batched_blocks_equal_search(data, kind):
    """Three co-located indexes of one spec (one L2): each block of the
    batched pool, merged, is that index's own search."""
    x = data["x"]
    indexes = []
    for j, (lo, hi) in enumerate(((0, 150), (150, 300), (300, 400))):
        ref = ref_create(RefSpec(kind, RefMetric.L2, dict(KINDS[kind])))
        ref.build(x[lo:hi])
        indexes.append((ref, VectorIndex.load(ref.save(), device="cpu"), lo, hi))
    q = _t(data["q"])
    valids = [None, _t(data["valid"][150:300]), _t(data["valid"][300:400])]
    s, i, splits = type(indexes[0][1]).search_batched(
        [p for _, p, _, _ in indexes], q, K, valids=valids
    )
    ref_s, ref_i, ref_splits = type(indexes[0][0]).search_batched(
        [r for r, _, _, _ in indexes], data["q"], K,
        valids=[None if v is None else v.numpy() for v in valids],
    )
    assert len(splits) == len(ref_splits) == 4
    for u, (ref, port, _lo, _hi) in enumerate(indexes):
        blk = slice(splits[u], splits[u + 1])
        merged = ops.merge_topk(s[:, blk].contiguous(), i[:, blk].contiguous(), K)
        own = port.search(q, K, valid=valids[u])
        assert torch.equal(merged[1], own[1]) and torch.equal(merged[0], own[0])
        rblk = slice(ref_splits[u], ref_splits[u + 1])
        want = ops.merge_topk(_t(ref_s[:, rblk]), _t(ref_i[:, rblk]), K)
        assert_topk_near_tie(merged, want, RTOL, ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", IVF)
def test_batched_ivf_equals_search_reference(data, kind, metric, masked):
    got = VectorIndex.load(_ref_index(kind, metric, data["x"]).save(), device="cpu")
    valid = _t(data["valid"]) if masked else None
    q = _t(data["q"])
    assert_topk_near_tie(
        got.search(q, K, valid=valid), got._search_reference(q, K, valid=valid), RTOL, ATOL
    )


# ---------------------------------------------------------------- builds


def test_kmeans_build_matches_reference():
    """Same seed, same host seeding, Lloyd on the port's device: on
    clustered data the assignments agree exactly and the centroids within
    atol=1e-4 (float32 sums in another order); inertia within rtol=1e-5."""
    x = _clustered(21, 600)
    wc, wa = ref_kmeans.kmeans(x, 12, seed=3)
    gc, ga = kmeans.kmeans(_t(x), 12, seed=3)
    np.testing.assert_array_equal(ga.numpy(), wa)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=0, atol=1e-4)
    w_in = float(np.sum((x - wc[wa]) ** 2))
    g_in = float(((_t(x) - gc[ga]) ** 2).sum())
    assert abs(g_in - w_in) <= 1e-5 * w_in


def test_kmeans_seeding_is_the_reference_numpy():
    x = _clustered(22, 5000)  # above the 4,096-row seeding sample
    rng_w, rng_g = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(
        kmeans.kmeanspp_seed(_t(x), 9, rng_g), ref_kmeans.kmeanspp_seed(x, 9, rng_w)
    )
    assert rng_w.random() == rng_g.random()  # the same draws were consumed


def test_kmeans_reseeds_empty_clusters_like_reference(monkeypatch):
    """Seeds that leave clusters empty (two far-away centroids): both
    packages re-seed them from the same farthest rows."""
    x = _clustered(23, 300)
    seeds = np.concatenate([x[:6], np.full((2, x.shape[1]), 1e3, np.float32)])
    seeds[7] *= -1
    for mod in (ref_kmeans, kmeans):
        monkeypatch.setattr(mod, "kmeanspp_seed", lambda *a, **kw: seeds.copy())
    wc, wa = ref_kmeans.kmeans(x, 8, seed=1, max_iters=4)
    gc, ga = kmeans.kmeans(_t(x), 8, seed=1, max_iters=4)
    np.testing.assert_array_equal(ga.numpy(), wa)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=0, atol=1e-4)
    assert np.bincount(wa, minlength=8).min() > 0  # the far seeds were replaced


def test_balanced_kmeans_matches_reference():
    x = _clustered(24, 700)
    wc, wa = ref_kmeans.balanced_kmeans(x, 40, 80, seed=2)
    gc, ga = kmeans.balanced_kmeans(_t(x), 40, 80, seed=2)
    np.testing.assert_array_equal(ga.numpy(), wa)
    np.testing.assert_allclose(gc.numpy(), wc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", IVF)
def test_ivf_build_matches_reference(kind):
    """The same partition (list offsets and row order exact, centroids
    within atol=1e-4); the encoded payload agrees as far as each codec
    allows: FLAT storage exactly, SQ codes within one step, PQ codebooks
    within atol=1e-3 and codes on >= 99% of rows."""
    x = _clustered(25, 500)
    params = dict(KINDS[kind])
    ref = ref_create(RefSpec(kind, RefMetric.L2, params))
    ref.build(x)
    got = create_index(IndexSpec(kind, Metric.L2, params), device="cpu")
    got.build(_t(x))
    w, g = ref._state(), got._state()
    np.testing.assert_array_equal(g["list_offsets"], w["list_offsets"])
    np.testing.assert_array_equal(g["row_ids"], w["row_ids"])
    np.testing.assert_allclose(g["centroids"], w["centroids"], rtol=0, atol=1e-4)
    if kind == "ivf_flat":
        np.testing.assert_array_equal(g["storage"], w["storage"])
    elif kind == "ivf_sq":
        np.testing.assert_array_equal(g["vmin"], w["vmin"])
        np.testing.assert_array_equal(g["vmax"], w["vmax"])
        assert np.abs(g["codes"].astype(int) - w["codes"].astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(g["codebooks"], w["codebooks"], rtol=0, atol=1e-3)
        assert (g["codes"] == w["codes"]).all(axis=1).mean() >= 0.99
        np.testing.assert_array_equal(g["perm_assign"], w["perm_assign"])


@pytest.mark.parametrize("kind", list(KINDS))
def test_two_builds_from_one_seed_give_the_same_bytes(kind):
    x = _t(_clustered(26, 300))
    blobs = []
    for _ in range(2):
        idx = create_index(IndexSpec(kind, Metric.L2, dict(KINDS[kind])), device="cpu")
        idx.build(x)
        blobs.append(idx.save())
    assert blobs[0] == blobs[1]
