"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they build the kernels with nvcc and skip where no GPU is
visible.  Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import kmeans_assign as km_mod  # noqa: E402
from repro_torch.kernels import l2_topk as l2_mod  # noqa: E402
from repro_torch.kernels import merge_topk as merge_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_adc as pq_mod  # noqa: E402
from repro_torch.kernels import sq_codec as sq_mod  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    MODEL_TIE,
    SCORE_TOL,
    assert_assign_close,
    assign_error_float64,
    assert_scan_close,
    assert_ties_by_row,
    assert_topk_near_tie,
    model_tie,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _segments(rng, sizes, d, dev, invalid_frac=0.2, all_invalid=()):
    bases, valids = [], []
    for s, n in enumerate(sizes):
        bases.append(torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev))
        if s in all_invalid:
            valids.append(torch.zeros(n, dtype=torch.bool, device=dev))
        elif s % 2:
            valids.append(None)
        else:
            valids.append(torch.from_numpy(rng.random(n) >= invalid_frac).to(dev))
    return bases, valids


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [1, 100, 1024])
@pytest.mark.parametrize("nq,d", [(1, 768), (37, 96)])
def test_l2_topk_matches_plain(dev, metric, k, nq, d):
    rng = np.random.default_rng(k + nq)
    bases, valids = _segments(rng, [0, 1, 700, 5000, 3000, 65], d, dev, all_invalid=(4,))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(dev)
    before = l2_mod.l2_topk.launches
    got = l2_mod.l2_topk(q, bases, valids, k, metric)
    torch.cuda.synchronize()
    assert l2_mod.l2_topk.launches == before + 1
    want = l2_mod.l2_topk_plain(q, bases, valids, k, metric)
    assert_scan_close(got, want, q, bases, valids, k, metric, *SCORE_TOL[metric])


# The redesigned scans: nq across the small-nq path's threshold and the
# 128-query tensor-core tile, d with and without 16-byte rows, segments across the
# select's chunk of C rows, ties planted across chunk edges.
SCAN_NQ = [1, 4, 5, 7, 8, 9, 16, 17, 100, 128, 129, 300]
SCAN_D = [768, 96, 100, 19]
C = 16384  # kChunkRows in csrc/scan_common.cuh
TIE_ROWS = [3, C - 2, C - 1, C, C + 1, 2 * C + 7, 3 * C + 4]


def _kernel_launches(fn):
    """Kernels that one call of ``fn`` ran on the card (copies excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and not e.key.startswith(("Memcpy", "Memset")))


def _tied_segments(rng, d, dev):
    """Segments of 0, 1, C - 1, C, C + 1 and 3C + 5 rows (one all-invalid
    segment of 700), with one row repeated at TIE_ROWS of the last."""
    sizes = [0, 1, 700, C - 1, C, C + 1, 3 * C + 5]
    bases, valids = _segments(rng, sizes, d, dev, all_invalid=(2,))
    # a row of a quarter of the usual norm, so query 0 = that row sits at L2
    # distance ~0 without the float32 rounding of norms near d
    bases[-1][TIE_ROWS] = 0.25 * bases[-1][TIE_ROWS[0]]
    if valids[-1] is not None:
        valids[-1][TIE_ROWS] = True
    return bases, valids


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", SCAN_D)
@pytest.mark.parametrize("nq", SCAN_NQ)
def test_l2_topk_redesign_matches_plain(dev, metric, d, nq):
    rng = np.random.default_rng(nq * 1000 + d)
    bases, valids = _tied_segments(rng, d, dev)
    tied = bases[-1][TIE_ROWS[0]]
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(dev)
    q[0] = tied  # at L2 distance ~0 the tied rows lead query 0
    equal = None
    for k in (1024, 100, 1):
        got = l2_mod.l2_topk(q, bases, valids, k, metric)
        torch.cuda.synchronize()
        want = l2_mod.l2_topk_plain(q, bases, valids, k, metric)
        assert_scan_close(got, want, q, bases, valids, k, metric, *SCORE_TOL[metric])
        if metric != "l2":
            continue
        blk = slice((len(bases) - 1) * k, len(bases) * k)
        if equal is None:
            equal = torch.unique(got[0][0, blk][:len(TIE_ROWS)]).numel() == 1
        assert_ties_by_row(got[0][0, blk], got[1][0, blk], TIE_ROWS, equal)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", SCAN_D)
@pytest.mark.parametrize("nq", SCAN_NQ)
def test_sq_l2_topk_redesign_matches_plain(dev, metric, d, nq):
    rng = np.random.default_rng(nq * 1000 + d + 1)
    for n in (0, 1, C - 1, C + 1, 3 * C + 5):
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        lo = x.min(0).values if n else torch.zeros(d, device=dev)
        hi = x.max(0).values if n else torch.ones(d, device=dev)
        codes = sq_mod.sq_encode(x, lo, hi)
        ties = [r for r in TIE_ROWS if r < n]
        if ties:  # the code nearest the column centres: a row of small norm
            codes[ties] = sq_mod.sq_encode(((lo + hi) / 2)[None, :], lo, hi)
        decoded = sq_mod.sq_decode_plain(codes, lo, hi)
        q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(dev)
        if ties:
            q[0] = decoded[ties[0]]
        valid = torch.from_numpy(rng.random(n) > 0.2).to(dev)
        valid[ties] = True
        equal = None
        for k in (1024, 100, 1):
            got = sq_mod.sq_l2_topk(q, codes, lo, hi, valid, k, metric)
            torch.cuda.synchronize()
            want = sq_mod.sq_l2_topk_plain(q, codes, lo, hi, valid, k, metric)
            assert_scan_close(got, want, q, [decoded], [valid], k, metric, *SCORE_TOL[metric])
            if ties and metric == "l2":
                if equal is None:
                    equal = torch.unique(got[0][0, :len(ties)]).numel() == 1
                assert_ties_by_row(got[0][0], got[1][0], ties, equal)


@pytest.mark.parametrize("nq", [1, 100])
def test_scan_launches_two_kernels_per_chunk_fitting_call(dev, nq):
    """A call whose segments each fit in one select chunk makes two kernel
    launches (score pass, select); a longer segment adds the merge stage."""
    rng = np.random.default_rng(nq)
    q = torch.from_numpy(rng.standard_normal((nq, 64)).astype(np.float32)).to(dev)
    small = [torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32)).to(dev)
             for n in (2048, 128, C)]
    assert _kernel_launches(lambda: l2_mod.l2_topk(q, small, [None] * 3, 100)) == 2
    big = small + [torch.from_numpy(rng.standard_normal((C + 1, 64)).astype(np.float32)).to(dev)]
    assert _kernel_launches(lambda: l2_mod.l2_topk(q, big, [None] * 4, 100)) == 3
    x = torch.from_numpy(rng.standard_normal((2048, 64)).astype(np.float32)).to(dev)
    lo, hi = x.min(0).values, x.max(0).values
    codes = sq_mod.sq_encode(x, lo, hi)
    assert _kernel_launches(lambda: sq_mod.sq_l2_topk(q, codes, lo, hi, None, 100)) == 2


@pytest.mark.parametrize("k", [1, 100, 1024])
@pytest.mark.parametrize("n", [C - 1, C + 1, 3 * C + 5])
def test_pq_adc_topk_ties_across_chunks_are_bit_exact(dev, n, k):
    """Exact ties (equal codes) at both sides of every chunk edge: the
    two-stage select keeps the lowest rows, bit-exact against the plain
    stable sort."""
    rng = np.random.default_rng(n + k)
    m, ksub = 48, 256
    luts = torch.from_numpy(rng.standard_normal((7, m, ksub)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m))).to(dev, torch.uint8)
    codes[[r for r in TIE_ROWS if r < n]] = codes[TIE_ROWS[0]].clone()
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    got = pq_mod.pq_adc_topk(luts, codes, k, valid)
    want = pq_mod.pq_adc_topk_plain(luts, codes, k, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", [16_000, 10_001])
def test_scan_serves_rows_wider_than_shared_memory(dev, d):
    """Rows too wide for the small-nq path to stage the queries (and SQ's
    scale / vmin) in shared memory, on both score paths: small integers
    (SQ: codes 0..7 with vmin 0 and vmax 255, so scale is 1), whose products
    and sums float32 holds exactly, so both scans equal their plain
    versions bit for bit."""
    rng = np.random.default_rng(d)
    bases = [torch.from_numpy(rng.integers(-2, 3, (n, d)).astype(np.float32)).to(dev)
             for n in (700, 3000)]
    valids = [None, torch.from_numpy(rng.random(3000) > 0.2).to(dev)]
    codes = torch.from_numpy(rng.integers(0, 8, (3000, d), dtype=np.uint8)).to(dev)
    lo, hi = torch.zeros(d, device=dev), torch.full((d,), 255.0, device=dev)
    for nq, small_q in ((1, None), (4, None), (8, 8), (8, None), (100, None)):
        q = torch.from_numpy(rng.integers(-2, 3, (nq, d)).astype(np.float32)).to(dev)
        for metric in ("l2", "ip"):
            case = (nq, small_q, metric)
            got = l2_mod.l2_topk(q, bases, valids, 100, metric, small_q=small_q)
            want = l2_mod.l2_topk_plain(q, bases, valids, 100, metric)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case
            got = sq_mod.sq_l2_topk(q, codes, lo, hi, valids[1], 100, metric, small_q=small_q)
            want = sq_mod.sq_l2_topk_plain(q, codes, lo, hi, valids[1], 100, metric)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case


def test_scan_rejects_small_q_outside_its_paths(dev):
    q = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):
        l2_mod.l2_topk(q, [torch.zeros((4, 8), device=dev)], [None], 1, small_q=9)
    codes = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        sq_mod.sq_l2_topk(q, codes, torch.zeros(8, device=dev), torch.ones(8, device=dev), None, 1,
                          small_q=-1)


@pytest.mark.parametrize("kernel", ["l2_topk", "sq_l2_topk"])
@pytest.mark.parametrize("nq", [16, 100])
@pytest.mark.parametrize("signed", [False, True])
def test_tensor_core_scores_match_the_3xtf32_model(dev, kernel, nq, signed):
    """Ties the CPU model of the tensor-core score pass
    (``testing.scan_scores_tf32``), which ``test_torch_scan_numerics.py``
    holds to float64, to the card: ``testing.model_tie``'s share of
    bit-exact scores and largest ulps within ``MODEL_TIE``, on nonnegative
    rows and on centred (signed) rows whose partial sums cancel."""
    share, ulps = MODEL_TIE
    for metric, (exact, far) in model_tie(kernel, nq, dev, signed).items():
        assert exact >= share and far <= ulps, (
            f"{metric}: {exact:.4f} of the scores bit-exact, {far:.2f} ulps at most")


def test_l2_topk_rejects_k_above_limit(dev):
    q = torch.zeros((1, 8), device=dev)
    with pytest.raises(ValueError):
        l2_mod.l2_topk(q, [torch.zeros((4, 8), device=dev)], [None], l2_mod.MAX_K + 1)


def _pools(rng, nq, m, dev):
    s = rng.standard_normal((nq, m)).astype(np.float32)
    s[:, ::7] = np.round(s[:, ::7])  # exact ties
    s[:, 3::11] = -0.0
    s[:, 5::13] = np.inf
    s[:, 6::17] = np.nan
    s[:, 8::19] = -np.inf
    p = rng.integers(-2, m // 3, size=(nq, m)).astype(np.int64)  # duplicates
    p[:, ::23] += 2**40  # pks beyond int32
    return torch.from_numpy(s).to(dev), torch.from_numpy(p).to(dev)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k,m", [(1, 7), (100, 500), (1024, 8192)])
def test_merge_topk_matches_plain(dev, metric, k, m):
    rng = np.random.default_rng(k)
    s, p = _pools(rng, 33, m, dev)
    before = merge_mod.merge_topk.launches
    gv, gp = merge_mod.merge_topk(s, p, k, metric)
    torch.cuda.synchronize()
    assert merge_mod.merge_topk.launches == before + 1
    wv, wp = merge_mod.merge_topk_plain(s, p, k, metric)
    assert torch.equal(gp, wp)
    assert torch.equal(torch.isnan(gv), torch.isnan(wv))
    torch.testing.assert_close(gv, wv, rtol=0, atol=0, equal_nan=True)


def _regime_pool(rng, nq, m, kind, dev):
    """mixed: ties, -0.0, inf / NaN, pk < 0 and past int32; repeated: every
    pk twice (the copy scoring the same or 1 apart); dead: no live
    candidate."""
    s = np.round(rng.standard_normal((nq, m)).astype(np.float32) * 4) / 4
    p = rng.integers(0, max(1, m // 3), size=(nq, m)).astype(np.int64)
    if kind == "mixed":
        s[:, 3::11] = -0.0
        s[:, 5::13] = np.inf
        s[:, 6::17] = np.nan
        p[:, 7::9] = -1
        p[:, ::23] += 2**40
    elif kind == "repeated":
        h = (m + 1) // 2
        p[:, :h] = rng.permutation(h)
        p[:, h:] = p[:, :m - h]
        s[:, h:] = s[:, :m - h] + rng.integers(0, 2, (nq, m - h))
    else:
        p[:, ::2] = -1
        s[:, 1::2] = np.nan
    return torch.from_numpy(s).to(dev), torch.from_numpy(p).to(dev)


@pytest.mark.parametrize("m", [1, 31, 32, 33, 256, 257, 400, 716, 800, 1024, 1025, 1700, 4800,
                               8192])
@pytest.mark.parametrize("kind", ["mixed", "repeated", "dead"])
def test_merge_topk_regimes_are_bit_exact(dev, m, kind):
    """Each regime of the kernel: a warp per query (M <= 256; nq = 33
    fills no block of 3 or 8 warps evenly), a warp per 256-, 512- or
    1,024-column chunk then one over the chunks' lists (above 256 columns,
    k = 1024 up to M = 1,024 too), and the block kernel (k = 1024 above
    that); k above the survivors where pks repeat or die; both metrics."""
    rng = np.random.default_rng(m * 3 + len(kind))
    s, p = _regime_pool(rng, 33, m, kind, dev)
    for k in (1, 100, 1024):
        for metric in ("l2", "ip"):
            before = merge_mod.merge_topk.launches
            gv, gp = merge_mod.merge_topk(s, p, k, metric)
            torch.cuda.synchronize()
            assert merge_mod.merge_topk.launches == before + 1
            wv, wp = merge_mod.merge_topk_plain(s, p, k, metric)
            assert torch.equal(gp, wp), (k, metric)
            assert torch.equal(gv.view(torch.int32), wv.view(torch.int32)), (k, metric)


@pytest.mark.parametrize("k", [100, 1024])
def test_wide_merge_is_chunked_kernel_launches(dev, k):
    """A pool wider than one launch takes merges in kernel launches only:
    three chunks, then their top-k lists, equal to the plain merge."""
    rng = np.random.default_rng(k + 1)
    s, p = _pools(rng, 9, 2 * merge_mod.MAX_M + 300, dev)
    before = merge_mod.merge_topk.launches
    gv, gp = ops.merge_topk(s, p, k, "l2")
    torch.cuda.synchronize()
    assert merge_mod.merge_topk.launches == before + 4
    wv, wp = merge_mod.merge_topk_plain(s, p, k, "l2")
    assert torch.equal(gp, wp) and torch.equal(gv, wv)


def test_query_node_on_card_matches_cpu(dev):
    """The same two-segment node on both devices gives the same answer."""
    from repro_torch.core.collection import Metric
    from repro_torch.core.consistency import GuaranteeTs
    from repro_torch.core.log import LogBroker
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.core.query_node import QueryNode, SealedHandle
    from repro_torch.core.segment import segment_from_columns

    rng = np.random.default_rng(5)
    cols = [
        {
            "pk": np.arange(s * 1000, s * 1000 + 300),
            "vector": rng.standard_normal((300, 64)).astype(np.float32),
            "ts": np.arange(10, 310, dtype=np.int64),
        }
        for s in range(2)
    ]
    q = rng.standard_normal((9, 64)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        node = QueryNode("qn", LogBroker(), MemoryObjectStore(), device=device)
        for s, c in enumerate(cols):
            node.sealed[("c", s)] = SealedHandle(segment_from_columns(c, s, "c", device=device))
        node.delta_deletes["c"] = {5: 200, 1007: 200}
        g = GuaranteeTs(query_ts=250, staleness_ms=float("inf"))
        out[device] = [node.search("c", q, 20, m, g) for m in (Metric.L2, Metric.IP, Metric.COSINE)]
    for metric, (cs, cp), (gs, gp) in zip(("l2", "ip", "cosine"), out["cpu"], out["cuda"]):
        rtol, atol = SCORE_TOL[metric]
        torch.testing.assert_close(gs.cpu(), cs, rtol=rtol, atol=atol)
        assert torch.equal(gp.cpu(), cp)


# kmeans_assign: C across the byte-bound path's sizes and the tensor-core
# path's 128-centroid tile (17: two 16-wide column groups; 129 and up: the
# block walks several tiles), n across the 128-row tile and the interim slice
# size, d with and without 16-byte rows; each through every score path C can
# take (small_c) and the default.
ASSIGN_C = [1, 8, 16, 17, 128, 129, 256, 1000]
ASSIGN_N = [1, 700, 2048, 100_000]
ASSIGN_D = [16, 19, 768]


def _assign_paths(c, d):
    """small_c values that force each score path (c, d) can take: 0 (the
    tensor cores) and c (a CUDA-core path: narrow rows at any c, else the
    byte-bound path up to its largest c)."""
    return (0, c) if c <= km_mod.SMALL_C_MAX or d <= km_mod.NARROW_D else (0,)


@pytest.mark.parametrize("d", ASSIGN_D)
@pytest.mark.parametrize("c", ASSIGN_C)
def test_kmeans_assign_matches_plain(dev, c, d):
    rng = np.random.default_rng(c * 1000 + d)
    cent = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(dev)
    for n in ASSIGN_N:
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        want = km_mod.kmeans_assign_plain(x, cent)
        for small_c in _assign_paths(c, d) + (None,):
            before = km_mod.kmeans_assign.launches
            got = km_mod.kmeans_assign(x, cent, small_c=small_c)
            torch.cuda.synchronize()
            assert km_mod.kmeans_assign.launches == before + 1
            assert_assign_close(got, want, x, cent, *SCORE_TOL["l2"])


@pytest.mark.parametrize("c,copies,d", [(40, 3, 32), (8, 2, 16), (16, 2, 768), (128, 2, 16),
                                        (128, 2, 768), (150, 2, 16), (150, 2, 768)])
def test_kmeans_assign_earliest_duplicate_wins(dev, c, copies, d):
    """Each of c centroids ``copies`` times, copy after copy: within the
    byte-bound path's one tile, on both sides of the narrow-row path's
    256-centroid chunk edge, and on the tensor-core path on both sides of a
    128-centroid tile edge (at 2 x 128 centroid 127's copy also right after
    the edge, at 128).  Every row's nearest centroid has a copy, which ties
    exactly; the earliest must win."""
    rng = np.random.default_rng(c + d)
    base = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    cent = torch.cat([base] * copies)
    if c == 128:
        cent[128] = cent[127]
    cent = cent.contiguous().to(dev)
    x = torch.from_numpy(rng.standard_normal((5000, d)).astype(np.float32)).to(dev)
    want = km_mod.kmeans_assign_plain(x, cent)
    for small_c in _assign_paths(len(cent), d) + (None,):
        got = km_mod.kmeans_assign(x, cent, small_c=small_c)
        torch.cuda.synchronize()
        assert bool((got[0] < c).all()), small_c
        assert_assign_close(got, want, x, cent, *SCORE_TOL["l2"])


@pytest.mark.parametrize("d", [16, 19, 768])
@pytest.mark.parametrize("c", [32, 256])
def test_kmeans_assign_near_rows_hold_float64(dev, c, d):
    """Rows 0.1 sigma from their centroid, where d2 ~ 0.01 d sits far below
    the norms and the expansion cancels: two float32 versions may differ
    there by both their errors, so each path is held to float64."""
    rng = np.random.default_rng(c * d)
    cent = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(dev)
    x = cent[torch.from_numpy(rng.integers(0, c, 20_000)).to(dev)] + 0.1 * torch.from_numpy(
        rng.standard_normal((20_000, d)).astype(np.float32)).to(dev)
    for small_c in _assign_paths(c, d):
        got = km_mod.kmeans_assign(x, cent, small_c=small_c)
        torch.cuda.synchronize()
        assign_error_float64(got, x, cent, *SCORE_TOL["l2"])


def test_kmeans_assign_rejects_small_c_outside_its_paths(dev):
    wide = torch.zeros((4, km_mod.NARROW_D + 1), device=dev)
    for small_c in (-1, km_mod.SMALL_C_MAX + 1):
        with pytest.raises(ValueError):
            km_mod.kmeans_assign(wide, wide, small_c=small_c)
    narrow = torch.zeros((4, km_mod.NARROW_D), device=dev)
    with pytest.raises(ValueError):
        km_mod.kmeans_assign(narrow, narrow, small_c=-1)


def _offset_view(t, elems: int):
    """``t``'s values in a contiguous view ``elems`` elements past an
    aligned allocation (narrower loads in the kernel)."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = flat[elems:].view(t.shape)
    view.copy_(t)
    return view


def test_pq_adc_topk_table_at_the_shared_memory_limit(dev):
    """A table of exactly MAX_LUT_BYTES runs one query per block (G = 1),
    bit-exact; one subquantizer more is refused."""
    rng = np.random.default_rng(11)
    m, ksub, nq, n = pq_mod.MAX_LUT_BYTES // (4 * 256), 256, 5, 3000
    assert 4 * m * ksub == pq_mod.MAX_LUT_BYTES and pq_mod.query_group(nq, m, ksub) == 1
    luts = torch.from_numpy(rng.standard_normal((nq, m, ksub)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, ksub, (n, m))).to(dev)
    for dtype in (torch.uint8, torch.int32):
        got = pq_mod.pq_adc_topk(luts, codes.to(dtype), 100)
        want = pq_mod.pq_adc_topk_plain(luts, codes.to(dtype), 100)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    wider = torch.zeros((1, m + 1, ksub), device=dev)
    with pytest.raises(ValueError):
        pq_mod.pq_adc_topk(wider, torch.zeros((4, m + 1), dtype=torch.uint8, device=dev), 1)


def test_sq_encode_is_bit_exact(dev):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4096, 768)).astype(np.float32)
    vmin, vmax = x.min(0), x.max(0)
    vmin[0], vmax[0] = 0.0, 255.0  # scale 1: exact .5 boundaries round half to even
    x[:, 0] = (np.arange(4096) % 256).astype(np.float32) + 0.5
    x[:, 1] = vmin[1] = vmax[1] = 0.25  # constant column
    xt, lo, hi = (torch.from_numpy(a).to(dev) for a in (x, vmin, vmax))
    before = sq_mod.sq_encode.launches
    got = sq_mod.sq_encode(xt, lo, hi)
    torch.cuda.synchronize()
    assert sq_mod.sq_encode.launches == before + 1
    assert torch.equal(got, sq_mod.sq_encode_plain(xt, lo, hi))
    col = got[:, 0].long().cpu().numpy()
    base = np.arange(4096) % 256
    np.testing.assert_array_equal(col, base + (base % 2) - (base == 255))


@pytest.mark.parametrize("n,d,offset", [(1, 1, 0), (700, 19, 0), (257, 768, 1), (257, 768, 4),
                                        (1001, 768, 0), (999, 100, 0), (2, 4096, 0),
                                        (3, 4100, 0), (5, 10_001, 0), (131_072, 768, 0)])
def test_sq_encode_edge_cases_are_bit_exact(dev, n, d, offset):
    """The 4-element path (d % 4 == 0, x 16-byte aligned: a view 4 floats
    off too, rows up to 4,096 wide) and the scalar path (d % 4 != 0, a view
    one float off the 16-byte grid, d above 4,096), one row, row counts no
    grid step divides; a column on exact .5 boundaries and a constant
    column wherever d allows."""
    rng = np.random.default_rng(n + d + offset)
    flat = rng.standard_normal(offset + n * d).astype(np.float32)
    x = flat[offset:].reshape(n, d)
    vmin, vmax = x.min(0), x.max(0)
    if d >= 2:
        vmin[0], vmax[0] = 0.0, 255.0
        x[:, 0] = (np.arange(n) % 256).astype(np.float32) + 0.5
        x[:, 1] = vmin[1] = vmax[1] = 0.25
    xt = torch.from_numpy(flat).to(dev)[offset:].view(n, d)
    lo, hi = torch.from_numpy(vmin).to(dev), torch.from_numpy(vmax).to(dev)
    before = sq_mod.sq_encode.launches
    got = sq_mod.sq_encode(xt, lo, hi)
    torch.cuda.synchronize()
    assert sq_mod.sq_encode.launches == before + 1
    assert torch.equal(got, sq_mod.sq_encode_plain(xt, lo, hi))


# Three profiled windows in one process, each a torch kernel (the sentinel)
# beside one sq_encode call; every event of each as (key, device type,
# count, self device time).
_ONE_ENCODE = """
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import sq_codec as sq
x = torch.randn((4096, 768), device="cuda")
lo, hi = x.min(0).values, x.max(0).values
sq.sq_encode(x, lo, hi)
x.add(1.0)
torch.cuda.synchronize()
windows = []
for _ in range(3):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.add(1.0)
        sq.sq_encode(x, lo, hi)
        torch.cuda.synchronize()
    windows.append([(e.key, str(e.device_type), e.count, e.self_device_time_total)
                    for e in prof.key_averages()])
print(repr(windows))
"""
# CUPTI's own overhead records, which the profiler lists beside the kernels
_CUPTI_OVERHEAD = {
    "Activity Buffer Request", "Buffer Flush", "Command Buffer Full", "Driver Compiler",
    "Instrumentation", "Lazy Function Loading", "Resource", "Runtime Triggered Module Loading",
    "UVM Activity Init",
}


def _window_kernels(events) -> list:
    """The kernels among a profiled window's ``(key, device type, count,
    self device time)`` events: device work that is no copy and no CUPTI
    overhead record, once per launch."""
    return [key for key, device, count, dev_time in events for _ in range(count)
            if "CUDA" in device and dev_time > 0 and key not in _CUPTI_OVERHEAD
            and not key.startswith(("Memcpy", "Memset"))]


def test_sq_encode_is_one_launch_without_torch_scale(dev, monkeypatch, record_property):
    """The kernel computes the scale itself: the wrapper calls no
    ``sq_scale`` (three torch launches), its counter moves by one per call,
    and ``torch.profiler`` sees one kernel per call.  A torch kernel (the
    sentinel) shares each profiled window: late in this file's process the
    profiler has recorded no kernel at all, the sentinel's neither, so a
    window counts only where the sentinel was recorded, and then it must
    hold exactly the sentinel and one ``sq_encode``.  Such a window is
    sought in this process (the kernels it saw kept as the
    ``in_process_kernels`` property), then in three fresh processes of
    three windows each; the test fails if none records the sentinel."""
    import ast
    import os
    import subprocess
    import sys
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    def forbidden(*args):
        raise AssertionError("sq_encode computed the scale in torch")

    def one_encode(kernels) -> bool:  # the window counts: the sentinel was recorded
        if not any("sq_encode" not in k for k in kernels):
            return False
        assert len(kernels) == 2 and sum("sq_encode" in k for k in kernels) == 1, kernels
        return True

    x = torch.randn((4096, 768), device=dev)
    lo, hi = x.min(0).values, x.max(0).values
    want = sq_mod.sq_encode_plain(x, lo, hi)
    monkeypatch.setattr(sq_mod, "sq_scale", forbidden)
    before = sq_mod.sq_encode.launches
    assert torch.equal(sq_mod.sq_encode(x, lo, hi), want)
    assert sq_mod.sq_encode.launches == before + 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.add(1.0)
        sq_mod.sq_encode(x, lo, hi)
        torch.cuda.synchronize()
    seen = _window_kernels([(e.key, str(e.device_type), e.count, e.self_device_time_total)
                            for e in prof.key_averages()])
    record_property("in_process_kernels", seen)
    if one_encode(seen):
        return
    src = str(Path(__file__).resolve().parents[1] / "src")
    tries = []
    for _ in range(3):
        out = subprocess.run([sys.executable, "-c", _ONE_ENCODE], capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": src}, timeout=600)
        assert out.returncode == 0, out.stderr
        windows = [_window_kernels(w) for w in ast.literal_eval(out.stdout.strip().splitlines()[-1])]
        tries.append(windows)
        record_property("fresh_process_windows", tries)
        if any(one_encode(w) for w in windows):
            return
    raise AssertionError(f"the profiler recorded no sentinel kernel in this process ({seen}) "
                         f"or in three fresh ones ({tries})")


def test_segmented_sq_scan_blocks_equal_single_scans(dev):
    """One segmented launch over buckets of a shared codec gives, block by
    block, each bucket's own ``sq_l2_topk`` bit for bit (nq = 1, the bucket
    search's calls)."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((700, 768)).astype(np.float32)).to(dev)
    lo, hi = x.min(0).values, x.max(0).values
    codes = sq_mod.sq_encode(x, lo, hi)
    cuts = [0, 96, 97, 225, 353, 353, 480, 700]
    segs = [codes[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    valids = [torch.from_numpy(rng.random(len(c)) > 0.2).to(dev) for c in segs]
    q = torch.from_numpy(rng.standard_normal((1, 768)).astype(np.float32)).to(dev)
    for metric in ("l2", "ip"):
        before = sq_mod.sq_l2_topk.launches
        s, i = sq_mod.sq_l2_topk_segmented(q, segs, lo, hi, valids, 100, metric)
        assert sq_mod.sq_l2_topk.launches == before + 1
        for j, (c, v) in enumerate(zip(segs, valids)):
            ws, wi = sq_mod.sq_l2_topk(q, c, lo, hi, v, 100, metric)
            assert torch.equal(s[:, j * 100:(j + 1) * 100], ws)
            assert torch.equal(i[:, j * 100:(j + 1) * 100], wi)


@pytest.mark.parametrize("compress", [True, False])
def test_bucket_search_on_card_matches_plain(dev, compress):
    """A bucket index built on the CPU and loaded on the card: the card's
    search (one centre probe, one segmented scan per query, one merge)
    equals the plain versions' search on the CPU within SCORE_TOL."""
    from repro_torch.core.collection import Metric
    from repro_torch.index.base import IndexSpec, VectorIndex
    from repro_torch.index.registry import create_index

    rng = np.random.default_rng(29)
    centers = rng.standard_normal((32, 96)).astype(np.float32) * 3
    x = centers[rng.integers(0, 32, 3000)] + rng.standard_normal((3000, 96)).astype(np.float32)
    q = torch.from_numpy(centers[rng.integers(0, 32, 20)] + rng.standard_normal((20, 96)).astype(np.float32))
    valid = torch.from_numpy(rng.random(3000) > 0.1)
    cpu = create_index(IndexSpec("bucket", Metric.L2, {"compress": compress}), device="cpu")
    cpu.build(torch.from_numpy(x))
    card = VectorIndex.load(cpu.save(), device=dev)
    scan = sq_mod.sq_l2_topk if compress else l2_mod.l2_topk
    before = scan.launches
    got = card.search(q.to(dev), 100, valid=valid.to(dev))
    torch.cuda.synchronize()
    assert scan.launches == before + (len(q) if compress else len(q) + 1)
    want = cpu.search(q, 100, valid=valid)
    assert_topk_near_tie(tuple(t.cpu() for t in got), want, *SCORE_TOL["l2"])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [1, 100, 1024])
@pytest.mark.parametrize("nq,n", [(1, 5000), (100, 700), (37, 0)])
def test_sq_l2_topk_matches_plain(dev, metric, k, nq, n):
    rng = np.random.default_rng(k + nq + n)
    d = 768
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    lo = x.min(0).values if n else torch.zeros(d, device=dev)
    hi = x.max(0).values if n else torch.ones(d, device=dev)
    codes = sq_mod.sq_encode(x, lo, hi)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.3).to(dev)
    before = sq_mod.sq_l2_topk.launches
    got = sq_mod.sq_l2_topk(q, codes, lo, hi, valid, k, metric)
    torch.cuda.synchronize()
    assert sq_mod.sq_l2_topk.launches == before + 1
    want = sq_mod.sq_l2_topk_plain(q, codes, lo, hi, valid, k, metric)
    decoded = sq_mod.sq_decode_plain(codes, lo, hi)
    assert_scan_close(got, want, q, [decoded], [valid], k, metric, *SCORE_TOL[metric])


@pytest.mark.parametrize("m", [8, 20, 48])
@pytest.mark.parametrize("nq", [1, 3, 4, 5, 8, 33, 100])
def test_pq_adc_topk_is_bit_exact(dev, nq, m):
    """Query groups full and ragged (G = 4), m with 16-byte, 4-byte and
    single-code loads (aligned and offset views of codes and tables), tables
    of 16 and 256 entries, uint8 and int32 codes, exact ties, k across the
    select's sizes: bit-exact against the plain version."""
    rng = np.random.default_rng(nq * 100 + m)
    n = 20_000  # two select chunks
    valid = torch.from_numpy(rng.random(n) > 0.2).to(dev)
    for ksub in (16, 256):
        luts = torch.from_numpy(rng.standard_normal((nq, m, ksub)).astype(np.float32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, ksub, (n, m))).to(dev)
        codes[:50] = codes[0].clone()  # exact ties
        for code_dtype in (torch.uint8, torch.int32):
            c = codes.to(code_dtype)
            offset = (_offset_view(luts, 1), _offset_view(c, 1))
            for k, (lt, ct) in [(1, (luts, c)), (100, (luts, c)), (1024, (luts, c)), (100, offset)]:
                before = pq_mod.pq_adc_topk.launches
                got = pq_mod.pq_adc_topk(lt, ct, k, valid)
                torch.cuda.synchronize()
                assert pq_mod.pq_adc_topk.launches == before + 1
                want = pq_mod.pq_adc_topk_plain(luts, c, k, valid)
                case = (ksub, code_dtype, k, lt.data_ptr() % 16, ct.data_ptr() % 16)
                assert torch.equal(got[0], want[0]), case
                assert_topk_near_tie(got, want, 0.0, 0.0)


@pytest.mark.parametrize("n,d,offset", [(1, 1, 0), (1, 768, 0), (700, 19, 0), (1001, 768, 0),
                                        (513, 48, 0), (257, 768, 3), (65_536, 768, 0),
                                        (999, 100, 0), (301, 6, 0), (257, 768, 4), (3, 4100, 0),
                                        (2, 4096, 0), (41_248, 768, 0)])
def test_sq_decode_is_bit_exact(dev, n, d, offset):
    """The 4-code path (d % 4 == 0, codes 4-byte aligned: d = 100 and a view
    4 bytes off the 16-byte grid too; rows up to 4,096 wide) and the scalar
    path (d % 4 != 0, a view 3 bytes off, d = 4,100), one row, row counts
    whose n * d no grid step divides."""
    rng = np.random.default_rng(n + d + offset)
    flat = torch.from_numpy(rng.integers(0, 256, offset + n * d).astype(np.uint8)).to(dev)
    codes = flat[offset:].view(n, d)
    lo = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dev)
    hi = lo + torch.from_numpy(rng.random(d).astype(np.float32) * 4).to(dev)
    hi[0] = lo[0]  # a constant column
    before = sq_mod.sq_decode.launches
    got = sq_mod.sq_decode(codes, lo, hi)
    torch.cuda.synchronize()
    assert sq_mod.sq_decode.launches == before + 1
    want = sq_mod.sq_decode_plain(codes, lo, hi)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sq_scale_on_card_is_the_ieee_division(dev):
    """``sq_scale`` on the card equals the CPU's (and numpy's) IEEE division
    bit for bit, as the decode kernel's own scale does."""
    rng = np.random.default_rng(17)
    lo = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi = lo + torch.from_numpy(rng.random(4096).astype(np.float32) * 7)
    want = np.maximum(hi.numpy() - lo.numpy(), np.float32(1e-12)) / np.float32(255.0)
    got = sq_mod.sq_scale(lo.to(dev), hi.to(dev)).cpu()
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(got, sq_mod.sq_scale(lo, hi))


def test_sq_decode_is_one_launch_without_torch_scale(dev, monkeypatch):
    """The kernel computes the scale itself: the wrapper calls no
    ``sq_scale`` (three torch launches) before its one launch."""
    def forbidden(*args):
        raise AssertionError("sq_decode computed the scale in torch")

    codes = torch.randint(0, 256, (4096, 768), dtype=torch.uint8, device=dev)
    lo = torch.randn(768, device=dev)
    hi = lo + 1.0
    want = sq_mod.sq_decode_plain(codes, lo, hi)
    monkeypatch.setattr(sq_mod, "sq_scale", forbidden)
    before = sq_mod.sq_decode.launches
    got = sq_mod.sq_decode(codes, lo, hi)
    torch.cuda.synchronize()
    assert sq_mod.sq_decode.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_facade_round_trip_on_card(dev):
    """Insert, flush, search, delete and search again through the port's
    ManuSystem on the card: each answer equals the float64 oracle over what
    the query nodes hold, and the IVF-SQ norms went through sq_decode."""
    from repro_torch import testing
    from repro_torch.core import ConsistencyLevel, FieldSchema, FieldType, ManuConfig, ManuSystem
    from repro_torch.core import SearchRequest

    manu = ManuSystem(ManuConfig(seal_rows=1_000, slice_rows=256), device=dev)
    coll = manu.create_collection("c", dim=64, extra_fields=[FieldSchema("ordinal", FieldType.INT)])
    coll.create_index("vector", "ivf_sq", {"nlist": 16, "nprobe": 4})
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3_000, 64)).astype(np.float32)
    coll.insert({"vector": x[:2_500], "ordinal": np.arange(2_500)})
    coll.flush()
    coll.insert({"vector": x[2_500:], "ordinal": np.arange(2_500, 3_000)})
    q = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).to(dev)
    nodes = list(manu.query_nodes.values())
    before = sq_mod.sq_decode.launches
    doomed = None
    for step in ("before", "after"):
        if step == "after":
            doomed = torch.from_numpy(rng.choice(3_000, 30, replace=False)).to(dev)
            coll.delete(doomed.cpu().numpy())
        got = coll.search(SearchRequest.single(q, k=50, consistency=ConsistencyLevel.STRONG))
        assert got.pks.device.type == "cuda"
        oracle = testing.system_oracle(nodes, "c", q, 50, got.query_ts, doomed)
        testing.assert_oracle_answer(step, (got.scores, got.pks), oracle, *SCORE_TOL["l2"])
    assert sq_mod.sq_decode.launches > before
    assert not torch.isin(got.pks, doomed).any()


def test_threaded_round_trip_on_card(dev):
    """The same flow on a threaded system: the pump thread seals, builds
    and loads on the card while the caller inserts and searches; STRONG
    answers equal the float64 oracle, and ``stop_threads()`` leaves no
    thread."""
    import threading

    from repro_torch import testing
    from repro_torch.core import ConsistencyLevel, ManuConfig, ManuSystem, SearchRequest

    manu = ManuSystem(ManuConfig(seal_rows=1_000, slice_rows=256, threaded=True, manual_clock=False),
                      device=dev)
    try:
        coll = manu.create_collection("c", dim=64)
        coll.create_index("vector", "ivf_flat", {"nlist": 16, "nprobe": 4})
        rng = np.random.default_rng(10)
        x = rng.standard_normal((3_000, 64)).astype(np.float32)
        q = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).to(dev)
        for lo in range(0, 3_000, 500):
            coll.insert({"vector": torch.from_numpy(x[lo:lo + 500]).to(dev)})
            got = coll.search(SearchRequest.single(q, k=50, consistency=ConsistencyLevel.STRONG))
            manu.wait_idle()
            nodes = list(manu.query_nodes.values())
            got_idle = coll.search(SearchRequest.single(q, k=50, consistency=ConsistencyLevel.STRONG))
            oracle = testing.system_oracle(nodes, "c", q, 50, got_idle.query_ts, None)
            testing.assert_oracle_answer(f"{lo}", (got_idle.scores, got_idle.pks), oracle,
                                         *SCORE_TOL["l2"])
            assert int((got.pks >= 0).sum()) == 8 * min(50, lo + 500)  # every row visible
    finally:
        manu.stop_threads()
    assert not [t for t in threading.enumerate() if t.name.startswith("manu-") and t.is_alive()]


def test_embedder_on_card_matches_the_cpu(dev):
    """A reduced yi-9b embeds on the card as on the CPU (one seeded model
    moved over): within 0.02 in L2 per row, unit norm, finite."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models.embedder import Embedder

    cfg = get_arch("yi-9b").reduced(d_model=256, num_layers=4, vocab_size=1_000, d_ff=512)
    cpu_model = M.init_params(cfg, seed=3, device="cpu")
    card_model = M.Transformer(cfg, device="meta")
    card_model.load_state_dict({k: v.to(dev) for k, v in cpu_model.state_dict().items()}, assign=True)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (21, 64))
    want = Embedder(cfg, cpu_model, max_batch=8).embed(tok)
    got = Embedder(cfg, card_model, max_batch=8).embed(tok)
    assert got.device.type == "cuda" and got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(torch.linalg.vector_norm(got, dim=1).cpu(), torch.ones(21),
                               rtol=0, atol=1e-5)
    assert torch.linalg.vector_norm(got.cpu() - want, dim=1).max().item() <= 0.02


ALL_ARCHS = ["deepseek-moe-16b", "jamba-v0.1-52b", "mamba2-370m", "minicpm3-4b", "musicgen-medium",
             "paligemma-3b", "qwen1.5-4b", "qwen3-32b", "qwen3-moe-30b-a3b", "yi-9b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_on_card_matches_the_cpu(dev, arch):
    """A reduced model's prefill and 8 decode steps on the card as on the
    CPU (one seeded model moved over, both fed the CPU's greedy tokens):
    logits within ``testing.logit_atol``, greedy tokens equal outside
    near-ties."""
    import copy

    from repro_torch import testing
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M

    cfg = get_arch(arch).reduced()
    cpu_model = M.init_params(cfg, seed=7, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
    prefix = None
    if cfg.frontend == "vlm_stub":
        prefix = torch.randn((4, cfg.num_prefix_embeddings, cfg.d_model), generator=gen)
    res = testing.compare_decode(cfg, cpu_model, card_model, tokens, prefix, 8, testing.logit_atol(cfg))
    assert res["tokens"].shape == (4, 8) and res["max_abs_err"] <= testing.logit_atol(cfg)


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm3-4b", "qwen3-moe-30b-a3b", "mamba2-370m"])
def test_train_step_on_card_matches_the_cpu(dev, arch):
    """One ``build_local_train_cell`` step of a reduced model on the card as on
    the CPU (one seeded model moved over, one synthetic batch): the loss
    within ``testing.loss_atol``, the gradient norm within
    ``testing.GRAD_RTOL`` (``testing.compare_train_step``), and the
    parameters still finite after the update."""
    import copy

    from repro_torch import testing
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainConfig, synthetic_lm_batches

    cfg = get_arch(arch).reduced()
    cpu_model = M.init_params(cfg, seed=5, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = next(synthetic_lm_batches(cfg, TrainConfig(batch=4, seq_len=64, seed=6), device="cpu"))
    res = testing.compare_train_step(cfg, cpu_model, card_model, batch)
    assert res["loss_abs_err"] <= testing.loss_atol(cfg)
    assert all(torch.isfinite(p).all() for p in card_model.parameters())
