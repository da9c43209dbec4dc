"""The port's index-build and indexed-search kernel layer (plain PyTorch
path, on the CPU) against the reference's host paths in
``repro.kernels.ops`` and, at one tiny shape each, against the Pallas
kernels in interpret mode: ``kmeans_assign``, ``sq_encode``,
``sq_topk_scan``, ``pq_adc_topk`` and the IVF gather-scan ops.

Tolerance: float32 scores rtol=1e-5, atol=1e-4 (products summed in another
order); ids exact except at near-ties (``repro_torch.testing``).  SQ codes
and PQ table sums do no reordered arithmetic, so they must match exactly."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_FORCE_PALLAS", "0")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.kmeans_assign import kmeans_assign_pallas  # noqa: E402
from repro.kernels.pq_adc import pq_adc_topk_pallas  # noqa: E402
from repro.kernels.sq_codec import sq_encode_pallas, sq_l2_topk_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_adc as pq_mod  # noqa: E402
from repro_torch.kernels import sq_codec as sq_mod  # noqa: E402
from repro_torch.testing import assert_topk_near_tie  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_assign_close(got, want, x, c):
    """Assignments exact except where two centroids' distances tie within
    the tolerance; min distances close."""
    ga, gd = got
    wa, wd = want
    assert ga.dtype == torch.int64 and gd.dtype == torch.float32
    np.testing.assert_allclose(gd.numpy(), wd, rtol=RTOL, atol=ATOL)
    for r in np.nonzero(ga.numpy() != wa)[0]:
        d_got = np.sum((x[r] - c[ga[r]]) ** 2)
        d_want = np.sum((x[r] - c[wa[r]]) ** 2)
        assert abs(d_got - d_want) <= ATOL + RTOL * abs(d_want), (r, d_got, d_want)


@pytest.mark.parametrize("n,c,d", [(1, 1, 16), (70, 16, 16), (300, 37, 24), (129, 130, 8)])
def test_kmeans_assign_matches_reference(n, c, d):
    rng = np.random.default_rng(n + c)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    want = ref_ops.kmeans_assign(x, cent)
    got = ops.kmeans_assign(_t(x), _t(cent))
    _assert_assign_close(got, want, x, cent)


def test_kmeans_assign_earliest_duplicate_wins():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 12)).astype(np.float32)
    cent = rng.standard_normal((6, 12)).astype(np.float32)
    cent = np.concatenate([cent, cent, cent[:2]])  # every centroid again, later
    ga, gd = ops.kmeans_assign(_t(x), _t(cent))
    wa, wd = ref_ops.kmeans_assign(x, cent)
    np.testing.assert_array_equal(ga.numpy(), wa)
    assert (ga.numpy() < 6).all()
    np.testing.assert_allclose(gd.numpy(), wd, rtol=RTOL, atol=ATOL)


def test_kmeans_assign_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    cent = rng.standard_normal((20, 16)).astype(np.float32)
    padded = np.concatenate([cent, np.full((108, 16), 1e18, np.float32)])
    pa, pd = kmeans_assign_pallas(jnp.asarray(x), jnp.asarray(padded), tn=128, tc=128, interpret=True)
    ga, gd = ops.kmeans_assign(_t(x), _t(cent))
    _assert_assign_close((ga, gd), (np.asarray(pa, np.int64), np.asarray(pd)), x, cent)


def test_kmeans_assign_rejects_bad_input():
    with pytest.raises(ValueError, match="at least one centroid"):
        ops.kmeans_assign(torch.zeros((3, 4)), torch.zeros((0, 4)))
    with pytest.raises(ValueError):
        ops.kmeans_assign(torch.zeros((3, 4)), torch.zeros((2, 5)))


def _sq_data(rng, n=200, d=12):
    x = rng.standard_normal((n, d)).astype(np.float32)
    vmin, vmax = x.min(0), x.max(0)
    # Column 0: scale exactly 1, every value an exact .5 boundary.
    vmin[0], vmax[0] = 0.0, 255.0
    x[:, 0] = (np.arange(n) % 256).astype(np.float32) + 0.5
    x[:3, 0] = (-3.5, 300.25, 254.5)  # below, above the range; 254.5 -> 254
    # Column 1: constant (vmin == vmax).
    x[:, 1] = 0.75
    vmin[1] = vmax[1] = 0.75
    return x, vmin.astype(np.float32), vmax.astype(np.float32)


def test_sq_encode_matches_reference_bitwise():
    x, vmin, vmax = _sq_data(np.random.default_rng(3))
    want = ref_ops.sq_encode(x, vmin, vmax)
    got = ops.sq_encode(_t(x), _t(vmin), _t(vmax))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # round half to even at the exact .5 boundaries of column 0
    col = got.numpy()[3:, 0].astype(np.int64)
    base = (np.arange(3, len(x)) % 256)
    np.testing.assert_array_equal(col, np.clip(base + (base % 2), 0, 255))
    np.testing.assert_array_equal(got.numpy()[:3, 0], [0, 255, 254])
    assert (got.numpy()[:, 1] == 0).all()
    np.testing.assert_array_equal(
        ops.sq_scale(_t(vmin), _t(vmax)).numpy(), ref_ops.sq_scale(vmin, vmax)
    )


def test_sq_encode_matches_pallas_interpret():
    x, vmin, vmax = _sq_data(np.random.default_rng(4), n=256, d=16)
    want = np.asarray(
        sq_encode_pallas(jnp.asarray(x), jnp.asarray(vmin), jnp.asarray(vmax), tn=128, interpret=True)
    )
    got = ops.sq_encode(_t(x), _t(vmin), _t(vmax))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,k", [(0, 5), (4, 9), (150, 10)])
def test_sq_topk_scan_matches_reference(metric, n, k):
    rng = np.random.default_rng(n + k)
    d = 16
    x = rng.standard_normal((max(n, 1), d)).astype(np.float32)[:n]
    vmin = x.min(0) if n else np.zeros(d, np.float32)
    vmax = x.max(0) if n else np.ones(d, np.float32)
    codes = ref_ops.sq_encode(x, vmin, vmax) if n else np.zeros((0, d), np.uint8)
    q = rng.standard_normal((6, d)).astype(np.float32)
    valid = rng.random(n) > 0.3
    want = ref_ops.sq_topk_scan(q, codes, vmin, vmax, k, metric=metric, valid=valid)
    got = ops.sq_topk_scan(_t(q), _t(codes), _t(vmin), _t(vmax), k, metric=metric, valid=_t(valid))
    assert_topk_near_tie(got, tuple(map(_t, want)), RTOL, ATOL)


def test_sq_topk_scan_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    vmin, vmax = x.min(0), x.max(0)
    codes = ref_ops.sq_encode(x, vmin, vmax)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    valid = (rng.random(256) > 0.2).astype(np.int32)
    for metric in ("l2", "ip"):
        pv, pi = sq_l2_topk_pallas(
            jnp.asarray(q), jnp.asarray(codes.astype(np.int32)), jnp.asarray(vmin),
            jnp.asarray(vmax), jnp.asarray(valid), 9, metric=metric, tq=8, tn=128, interpret=True,
        )
        got = ops.sq_topk_scan(_t(q), _t(codes), _t(vmin), _t(vmax), 9, metric, _t(valid.astype(bool)))
        want = (_t(np.asarray(pv)), _t(np.asarray(pi, np.int64)))
        assert_topk_near_tie(got, want, 3e-4, 3e-4)


def test_sq_scan_limits():
    q = torch.zeros((1, 4))
    codes = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ops.sq_topk_scan(q, codes, torch.zeros(4), torch.ones(4), sq_mod.MAX_K + 1)
    with pytest.raises(ValueError, match="uint8"):
        sq_mod.sq_l2_topk(q, codes.to(torch.int32), torch.zeros(4), torch.ones(4), None, 2)


def _pq_data(rng, nq, n, m, ksub):
    luts = rng.standard_normal((nq, m, ksub)).astype(np.float32) * 3
    codes = rng.integers(0, ksub, (n, m)).astype(np.int32)
    return luts, codes


@pytest.mark.parametrize("n,k", [(0, 4), (5, 8), (300, 20)])
@pytest.mark.parametrize("code_dtype", [np.int32, np.uint8])
def test_pq_adc_topk_matches_reference(n, k, code_dtype):
    rng = np.random.default_rng(n + k)
    luts, codes = _pq_data(rng, 7, n, 6, 32)
    if n:
        codes[: n // 3] = codes[0]  # exact ties: equal codes give equal sums
    valid = rng.random(n) > 0.25
    want = ref_ops.pq_adc_topk(luts, codes, k, valid=valid)
    got = ops.pq_adc_topk(_t(luts), _t(codes.astype(code_dtype)), k, valid=_t(valid))
    assert_topk_near_tie(got, tuple(map(_t, want)), 0.0, 0.0)
    # the table sums themselves are the host loop's, bit for bit
    if n:
        ln, cn = luts, codes.astype(np.int64)
        sums = np.zeros((7, n), np.float32)
        for j in range(6):
            sums += ln[:, j, cn[:, j]]
        np.testing.assert_array_equal(pq_mod.adc_scores_plain(_t(luts), _t(codes)).numpy(), sums)


def test_pq_adc_topk_matches_pallas_interpret():
    rng = np.random.default_rng(6)
    luts, codes = _pq_data(rng, 4, 256, 4, 16)
    valid = (rng.random(256) > 0.2).astype(np.int32)
    pv, pi = pq_adc_topk_pallas(
        jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(valid), 7, tn=128, interpret=True
    )
    got = ops.pq_adc_topk(_t(luts), _t(codes), 7, valid=_t(valid.astype(bool)))
    want = (_t(np.asarray(pv)), _t(np.asarray(pi, np.int64)))
    assert_topk_near_tie(got, want, 1e-5, 1e-5)


def test_ivf_gather_topk_matches_reference():
    """Probe inversion + bucketed gather-scan over one CSR layout: the
    port's pools equal the reference's, slot for slot."""
    rng = np.random.default_rng(8)
    lengths = np.array([0, 3, 140, 9, 1600, 1, 77, 300, 2500])  # two width classes
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    n, d, nq, nprobe, k = int(offsets[-1]), 8, 11, 3, 6
    storage = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    probes = np.stack([rng.permutation(len(lengths))[:nprobe] for _ in range(nq)])
    probes[::4, -1] = -1  # padded probe slots, as a scan over few lists emits
    valid = rng.random(n) > 0.2

    def ref_score(b):
        s = np.matmul(q[b.q_idx], storage[b.rows].transpose(0, 2, 1))
        return np.where(b.wmask[:, None, :] & valid[b.rows][:, None, :], s, np.float32(np.inf))

    st, vt, qt = _t(storage), _t(valid), _t(q)

    def port_score(b):
        s = torch.bmm(qt[b.q_idx], st[b.rows].transpose(1, 2))
        return s.masked_fill(~(b.wmask & vt[b.rows])[:, None, :], float("inf"))

    ws, wr = ref_ops.ivf_gather_topk(ref_ops.ivf_probe_schedule(probes, offsets), k, ref_score)
    sched = ops.ivf_probe_schedule(_t(probes), _t(offsets), device="cpu")
    gs, gr = ops.ivf_gather_topk(sched, k, port_score, "cpu")
    assert_topk_near_tie((gs, gr), (_t(ws), _t(wr)), RTOL, ATOL)
