"""``merge_topk_plain`` (the CPU path of the port's merge) against the
reference's host ``ops.merge_topk`` on pools with the main path's
structure: concatenated partials, each sorted by the metric's order and
ending in dead slots, pks repeated across partials (a segment on two
replicas, a row in a growing copy and its sealed segment), exact ties
across partials, and the widths the node reduce, the proxy's global reduce
and the IVF candidate pools give (units x k, nodes x k, nprobe x k), cut to
CPU size.  A merge does no arithmetic, so scores and pks must match bit
for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (the reference's import order)
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import merge_topk as merge_mod  # noqa: E402


def main_path_pool(rng, nq: int, parts: int, k: int, metric: str, dup: float = 0.3,
                   dead: float = 0.1):
    """``parts`` partials of ``k`` columns: a partial's live candidates
    sorted best first, its last ``dead`` share empty (fill, pk -1); a
    ``dup`` share of each partial's pks (and their scores) copied from an
    earlier partial, in place."""
    fill = np.float32(np.inf if metric == "l2" else -np.inf)
    s = np.empty((nq, parts * k), np.float32)
    p = np.empty((nq, parts * k), np.int64)
    n_dead = int(round(dead * k))
    for j in range(parts):
        blk = slice(j * k, (j + 1) * k)
        sc = np.round(rng.standard_normal((nq, k)).astype(np.float32) * 8) / 8  # ties
        pk = rng.integers(0, 50 * parts * k, (nq, k))
        if j:
            src = rng.integers(0, j * k, (nq, k))
            take = rng.random((nq, k)) < dup
            rows = np.arange(nq)[:, None]
            sc = np.where(take, s[rows, src], sc)
            pk = np.where(take, p[rows, src], pk)
        sc = np.where(np.isfinite(sc), sc, np.float32(0.5))
        order = np.argsort(sc if metric == "l2" else -sc, axis=1, kind="stable")
        sc, pk = np.take_along_axis(sc, order, 1), np.take_along_axis(pk, order, 1)
        sc[:, k - n_dead:] = fill
        pk[:, k - n_dead:] = -1
        s[:, blk], p[:, blk] = sc, pk
    return s, p


# (nq, partials, k): the FLAT and indexed node reduces (4 scan units of
# k = 100, an IVF node's 44 units), the proxy's two nodes, an IVF pool of
# nprobe 8 and a slice pool of nprobe 4, cut to k = 10 / 25 where wide;
# pools across the one-warp limit (1,024) and past one launch (8,192).
SHAPES = [
    (1, 4, 100), (100, 4, 100), (1, 2, 100), (100, 2, 100), (1, 8, 100), (3, 8, 100),
    (2, 4, 25), (1, 44, 25), (5, 103, 10), (1, 11, 100), (2, 83, 100),
]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("nq,parts,k", SHAPES)
def test_merge_plain_matches_reference_on_main_path_pools(metric, nq, parts, k):
    rng = np.random.default_rng(nq * 1000 + parts * 10 + k)
    s, p = main_path_pool(rng, nq, parts, k, metric)
    ws, wp = ref_ops.merge_topk(s, p, k, metric=metric)
    gs, gp = merge_mod.merge_topk_plain(torch.from_numpy(s), torch.from_numpy(p), k, metric)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_array_equal(gs.numpy(), ws)
    # every pk at most once, and the duplicates really were there
    out = np.sort(gp.numpy(), axis=1)
    assert not ((out[:, 1:] == out[:, :-1]) & (out[:, 1:] >= 0)).any()
    live = p[p >= 0]
    assert len(np.unique(live)) < len(live)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_merge_plain_matches_reference_when_every_pk_repeats(metric):
    """Two replicas' identical partials: each pk twice, ties broken by the
    earlier column; and k above the survivors."""
    rng = np.random.default_rng(3)
    s, p = main_path_pool(rng, 4, 1, 50, metric, dead=0.4)
    s, p = np.concatenate([s, s], 1), np.concatenate([p, p], 1)
    for k in (10, 50, 120):
        ws, wp = ref_ops.merge_topk(s, p, k, metric=metric)
        gs, gp = merge_mod.merge_topk_plain(torch.from_numpy(s), torch.from_numpy(p), k, metric)
        np.testing.assert_array_equal(gp.numpy(), wp)
        np.testing.assert_array_equal(gs.numpy(), ws)
    assert (gp.numpy()[:, 30:] == -1).all()
