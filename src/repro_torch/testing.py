"""Comparison helpers for scan results (tests and ``chip_smoke.py``).

Two float32 scans that add their products in different orders may rank two
rows whose scores lie within the tolerance in either order.  These checks
therefore hold ids exact except at such near-ties, where the id a scan
chose must score (by the plain expression) within the tolerance of the
reference's score at that slot.
"""

from __future__ import annotations

import torch

#: (rtol, atol) for float32 scores on the card, per metric, against a plain
#: float32 version at D <= 768.  Set from the measured error: the largest
#: kernel-vs-plain difference on L2 distances near 1.5e3 (D = 768) was
#: 4.9e-4, so L2 allows 3.5e-3 there.  ``chip_smoke.py`` checks that a
#: TF32 product falls outside the L2 and cosine tolerances.
SCORE_TOL = {"l2": (1e-6, 2e-3), "ip": (1e-6, 1e-3), "cosine": (1e-5, 5e-6)}


def row_scores(queries, base, q_rows, rows, metric: str) -> torch.Tensor:
    """Plain-expression scores of ``base[rows]`` against ``queries[q_rows]``
    (L2 distance, or IP similarity), one per pair."""
    q = queries[q_rows]
    x = base[rows]
    qx = (q * x).sum(1)
    if metric == "l2":
        return ((q * q).sum(1) - 2.0 * qx) + (x * x).sum(1)
    return qx


def assert_scan_close(got, want, queries, bases, valids, k: int, metric: str,
                      rtol: float, atol: float) -> None:
    """Check a segmented scan ``got`` = (vals, idx) against ``want``."""
    gv, gi = got
    wv, wi = want
    if gv.shape != wv.shape or gi.shape != wi.shape:
        raise AssertionError(f"shape {tuple(gv.shape)} != {tuple(wv.shape)}")
    if not torch.equal(gi < 0, wi < 0):
        raise AssertionError("empty-slot pattern differs")
    fin = torch.isfinite(wv)
    if not torch.equal(fin, torch.isfinite(gv)):
        raise AssertionError("finite-score pattern differs")
    torch.testing.assert_close(gv[fin], wv[fin], rtol=rtol, atol=atol)
    torch.testing.assert_close(gv[~fin], wv[~fin], rtol=0, atol=0)
    for s, (base, valid) in enumerate(zip(bases, valids)):
        blk = slice(s * k, (s + 1) * k)
        g, w = gi[:, blk], wi[:, blk]
        srt = torch.sort(g, dim=1).values
        if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
            raise AssertionError(f"segment {s}: a row index repeats within a query")
        diff = (g != w) & (g >= 0)
        if not bool(diff.any()):
            continue
        q_rows, slots = torch.nonzero(diff, as_tuple=True)
        rows = g[q_rows, slots]
        if valid is not None and not bool(valid[rows].all()):
            raise AssertionError(f"segment {s}: an invalid row was returned")
        torch.testing.assert_close(
            row_scores(queries, base, q_rows, rows, metric), wv[:, blk][q_rows, slots],
            rtol=rtol, atol=atol,
        )


def assert_topk_near_tie(got, want, rtol: float, atol: float) -> None:
    """Check one search's ``(scores, ids)`` [nq, k] against another's that
    ranked the same candidates with scores summed in another order: the
    same empty slots, scores close slot by slot, no id twice in a row, and
    ids equal except at near-ties.  A differing id must sit in ``want``'s
    row at a slot whose score lies within the tolerance of this slot's, or
    this slot must tie with ``want``'s last live slot, where the other
    search may have kept another of the tied rows."""
    gs, gi = got
    ws, wi = want
    if gs.shape != ws.shape or gi.shape != wi.shape:
        raise AssertionError(f"shape {tuple(gs.shape)} != {tuple(ws.shape)}")
    live = wi >= 0
    if not torch.equal(gi >= 0, live):
        raise AssertionError("empty-slot pattern differs")
    torch.testing.assert_close(gs[live], ws[live], rtol=rtol, atol=atol)
    srt = torch.sort(gi, dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError("an id repeats within a query")
    for r, j in torch.nonzero((gi != wi) & live).tolist():
        tol = atol + rtol * abs(float(ws[r, j]))
        near = live[r] & ((ws[r] - ws[r, j]).abs() <= tol)
        if bool((wi[r][near] == gi[r, j]).any()):
            continue
        last = int(live[r].sum()) - 1
        if abs(float(ws[r, j]) - float(ws[r, last])) <= 2 * tol:
            continue
        raise AssertionError(
            f"query {r} slot {j}: id {int(gi[r, j])} where {int(wi[r, j])} was expected, "
            f"and no near-tie explains it"
        )


def assert_assign_close(got, want, x, centroids, rtol: float, atol: float) -> None:
    """Check a nearest-centroid assignment ``got`` = (assign, min_d2)
    against ``want``: distances close, assignments exact except where the
    chosen centroid's distance ties the reference's within the tolerance."""
    ga, gd = got
    wa, wd = want
    if ga.shape != wa.shape or ga.dtype != torch.int64 or gd.dtype != torch.float32:
        raise AssertionError("assignment shape or dtype differs")
    torch.testing.assert_close(gd, wd, rtol=rtol, atol=atol)
    rows = torch.nonzero(ga != wa).squeeze(1)
    if rows.numel():
        xr = x[rows]
        d_got = ((xr - centroids[ga[rows]]) ** 2).sum(1)
        d_want = ((xr - centroids[wa[rows]]) ** 2).sum(1)
        torch.testing.assert_close(d_got, d_want, rtol=rtol, atol=atol)
