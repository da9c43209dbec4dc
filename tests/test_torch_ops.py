"""The port's kernel layer (plain PyTorch path, on the CPU) against the
reference's host paths in ``repro.kernels.ops`` and, at one small shape,
against the Pallas kernels in interpret mode.

Tolerance: scores rtol=1e-5, atol=1e-4 (float32 products summed in another
order); ids exact except at near-ties (``repro_torch.testing``).  Merges
do no arithmetic, so they must match exactly."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_FORCE_PALLAS", "0")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.l2_topk import l2_topk_pallas  # noqa: E402
from repro.kernels.merge_topk import merge_topk_pallas  # noqa: E402
from repro_torch.kernels import l2_topk as l2_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.testing import assert_scan_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _segments(rng, sizes, d):
    bases, valids = [], []
    for s, n in enumerate(sizes):
        bases.append(rng.standard_normal((n, d)).astype(np.float32))
        if s == 3:
            valids.append(np.zeros(n, bool))  # all-invalid segment
        elif s % 2:
            valids.append(None)
        else:
            valids.append(rng.random(n) >= 0.3)
    return bases, valids


def _to_t(valids):
    return [None if v is None else _t(v) for v in valids]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,k", [(0, 5), (3, 8), (50, 8), (200, 17)])
def test_topk_scan_matches_reference(metric, n, k):
    rng = np.random.default_rng(n + k)
    q = rng.standard_normal((6, 12)).astype(np.float32)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    valid = rng.random(n) >= 0.25
    want = ref_ops.topk_scan(q, x, k, metric=metric, valid=valid)
    got = ops.topk_scan(_t(q), _t(x), k, metric=metric, valid=_t(valid))
    assert_scan_close(got, tuple(map(_t, want)), _t(q), [_t(x)], [_t(valid)], k, metric, RTOL, ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_topk_scan_segmented_matches_reference(metric):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    bases, valids = _segments(rng, (0, 7, 130, 64, 64, 5), 24)
    k = 11
    want = ref_ops.topk_scan_segmented(q, bases, k, metric=metric, valids=valids)
    got = ops.topk_scan_segmented(_t(q), [_t(b) for b in bases], k, metric, _to_t(valids))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert_scan_close(
        got, tuple(map(_t, want)), _t(q), [_t(b) for b in bases], _to_t(valids), k, metric,
        RTOL, ATOL,
    )


def test_topk_scan_k_limit():
    with pytest.raises(ValueError):
        ops.topk_scan(torch.zeros((1, 4)), torch.zeros((3, 4)), l2_mod.MAX_K + 1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_topk_scan_matches_pallas_interpret(metric):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    valid = (rng.random(256) > 0.2).astype(np.int32)
    k = 9
    pv, pi = l2_topk_pallas(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), k,
        metric=metric, tq=8, tn=128, interpret=True,
    )
    gv, gi = ops.topk_scan(_t(q), _t(x), k, metric=metric, valid=_t(valid.astype(bool)))
    np.testing.assert_allclose(gv.numpy(), np.asarray(pv), rtol=3e-4, atol=3e-4)
    assert (gi.numpy() == np.asarray(pi)).all()


def _pools(rng, nq, m, pk_hi, pk_lo=-2):
    s = rng.standard_normal((nq, m)).astype(np.float32)
    s[:, ::5] = np.round(s[:, ::5])  # exact ties across pks
    s[:, 3::11] = -0.0
    s[:, 1::9] = 0.0
    s[:, 5::13] = np.inf
    s[:, 6::17] = np.nan
    s[:, 8::19] = -np.inf
    p = rng.integers(pk_lo, pk_hi, size=(nq, m)).astype(np.int64)  # duplicates, pk < 0
    return s, p


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("m,k,pk_hi", [(40, 10, 12), (300, 25, 400), (64, 100, 30), (1, 3, 5)])
def test_merge_topk_matches_reference(metric, m, k, pk_hi):
    rng = np.random.default_rng(m + k)
    s, p = _pools(rng, 7, m, pk_hi)
    p[:, ::23] += 2**40  # pks beyond int32
    ws, wp = ref_ops.merge_topk(s, p, k, metric=metric)
    gs, gp = ops.merge_topk(_t(s), _t(p), k, metric=metric)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_array_equal(gs.numpy(), ws)  # bitwise, -0.0 included
    assert np.array_equal(np.signbit(gs.numpy()), np.signbit(ws))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [100, 1024])
def test_merge_topk_wider_than_kernel_matches_reference(metric, k):
    """Pools wider than one kernel launch takes merge in chunks, exactly."""
    rng = np.random.default_rng(k)
    m = 2 * ops.MAX_MERGE_WIDTH + 300
    s, p = _pools(rng, 3, m, m // 3)
    s[:, -40:] = s[:, :40]  # the same (score, pk) in the first and last chunk
    p[:, -40:] = p[:, :40]
    ws, wp = ref_ops.merge_topk(s, p, k, metric=metric)
    gs, gp = ops.merge_topk(_t(s), _t(p), k, metric=metric)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_array_equal(gs.numpy(), ws)
    assert np.array_equal(np.signbit(gs.numpy()), np.signbit(ws))


def test_merge_topk_wide_pool_k_limit():
    m = ops.MAX_MERGE_WIDTH + 1
    with pytest.raises(ValueError, match="takes k"):
        ops.merge_topk(torch.zeros((1, m)), torch.zeros((1, m), dtype=torch.int64),
                       ops.MAX_MERGE_WIDTH // 2 + 1)


def test_merge_topk_empty_pool():
    for metric, fill in (("l2", np.inf), ("ip", -np.inf)):
        gs, gp = ops.merge_topk(torch.zeros((3, 0)), torch.zeros((3, 0), dtype=torch.int64), 4, metric)
        assert (gs.numpy() == fill).all() and (gp.numpy() == -1).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_merge_topk_matches_pallas_interpret(metric):
    rng = np.random.default_rng(9)
    s = rng.standard_normal((8, 128)).astype(np.float32)
    p = rng.integers(-1, 60, size=(8, 128)).astype(np.int32)
    k = 16
    pv, pp = merge_topk_pallas(jnp.asarray(s), jnp.asarray(p), k, metric=metric, tq=8, interpret=True)
    pv, pp = np.asarray(pv), np.asarray(pp).astype(np.int64)
    pp = np.where(np.abs(pv) >= 1e38, -1, pp)
    gs, gp = ops.merge_topk(_t(s), _t(p.astype(np.int64)), k, metric=metric)
    np.testing.assert_array_equal(gp.numpy(), pp)
    live = pp >= 0
    np.testing.assert_array_equal(gs.numpy()[live], pv[live])


def test_mask_ops_match_reference():
    rng = np.random.default_rng(4)
    hay = np.unique(rng.integers(0, 100, 40))
    vals = rng.integers(-5, 110, 70)
    np.testing.assert_array_equal(
        ops.isin_sorted(_t(vals), _t(hay)).numpy(), ref_ops.isin_sorted(vals, hay)
    )
    assert not ops.isin_sorted(_t(vals), torch.zeros(0, dtype=torch.int64)).any()

    pks = rng.integers(0, 30, 80)
    dts = rng.integers(100, 200, 80).astype(np.int64)
    seg_pks = rng.integers(0, 40, 120)
    seg_ts = rng.integers(50, 220, 120).astype(np.int64)
    for ts in (90, 130, 170, 250):
        want = ref_ops.eff_tombstones(pks, dts, ts)
        got = ops.eff_tombstones(_t(pks), _t(dts), ts)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(
            ops.tombstone_mask(_t(seg_pks), _t(seg_ts), *got).numpy(),
            ref_ops.tombstone_mask(seg_pks, seg_ts, *want),
        )

    a, b = rng.random(50) < 0.5, rng.random(50) < 0.7
    np.testing.assert_array_equal(
        ops.mask_intersect(None, _t(a), _t(b)).numpy(), ref_ops.mask_intersect(None, a, b)
    )
    assert ops.mask_intersect(None, None) is None

    s, p = _pools(rng, 4, 30, 20)
    for metric in ("l2", "ip"):
        for radius, rf in ((0.5, None), (None, -0.5), (1.0, -1.0)):
            if metric == "ip" and radius is not None and rf is not None:
                radius, rf = rf, radius
            ws, wp = ref_ops.range_cut(s, p, metric, radius, rf)
            gs, gp = ops.range_cut(_t(s), _t(p), metric, radius, rf)
            np.testing.assert_array_equal(gs.numpy(), ws)
            np.testing.assert_array_equal(gp.numpy(), wp)
        idx = rng.integers(-1, 30, (4, 12))
        keep = rng.random(30) < 0.5
        ws, wi = ref_ops.post_filter_cut(s[:, :12], idx, keep, metric)
        gs, gi = ops.post_filter_cut(_t(s[:, :12]), _t(idx), _t(keep), metric)
        np.testing.assert_array_equal(gs.numpy(), ws)
        np.testing.assert_array_equal(gi.numpy(), wi)
