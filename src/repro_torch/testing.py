"""Comparison helpers for scan results (tests and ``chip_smoke.py``).

Two float32 scans that add their products in different orders may rank two
rows whose scores lie within the tolerance in either order.  These checks
therefore hold ids exact except at such near-ties, where the id a scan
chose must score (by the plain expression) within the tolerance of the
reference's score at that slot.
"""

from __future__ import annotations

import numpy as np
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


# --------------------------------------------------------------------------
# Plain emulations of the scan kernels' arithmetic and select
# (csrc/scan_common.cuh), for the CPU tests
# --------------------------------------------------------------------------

#: Depth of the tensor-core score pass's fresh partial sums (one 8-deep
#: wgmma step) and rows of the select's chunk (``kChunkRows``) in
#: ``csrc/scan_common.cuh``.
SCAN_DEPTH = 8
SELECT_CHUNK = 16384
#: Bits below the leading bit of an instruction's largest addend that the
#: model of a ``wgmma ... .tf32`` instruction keeps (see
#: :func:`_tensor_core_step`): fitted to an NVIDIA H100's scores
#: (``tests/test_torch_cuda.py::test_tensor_core_scores_match_the_3xtf32_model``).
TC_ALIGN_BITS = 27


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` and the kernel's integer rounding do
    on finite values: add half a TF32 ulp to the magnitude bits, clear the
    13 low bits."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32).reshape(x.shape)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32_rna(x), lo = tf32_rna(x - hi)."""
    x = x.to(torch.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _kernel_norms(a: torch.Tensor) -> torch.Tensor:
    """Row sums of squares in float32 in the tensor-core path's order: in
    each 32-column ring stage, each 16-column half is an FMA chain from 0
    (one ``fmaf`` = one rounding of the exact float64 sum) added to that
    half's running total; the two halves' totals are added last."""
    a = a.to(torch.float32)
    halves = [torch.zeros(a.shape[0], dtype=torch.float32) for _ in range(2)]
    for c0 in range(0, a.shape[1], 32):
        for h in (0, 1):
            p = torch.zeros(a.shape[0], dtype=torch.float32)
            for c in range(c0 + 16 * h, min(c0 + 16 * h + 16, a.shape[1])):
                v = a[:, c].double()
                p = (v * v + p.double()).float()
            halves[h] = halves[h] + p
    return halves[0] + halves[1]


def _round_toward_zero(t: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounding toward zero."""
    r = t.to(torch.float32)
    over = r.to(torch.float64).abs() > t.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _exponent(t: torch.Tensor) -> torch.Tensor:
    """frexp exponent (|t| in [2^(e-1), 2^e)), -1000 for zeros."""
    return torch.where(t != 0, torch.frexp(t).exponent, -1000)


def _tensor_core_step(part, a, b) -> torch.Tensor:
    """One tensor-core instruction's 8-deep slice for every (query, row):
    ``part + sum_k a[:, k] b[:, k]`` as modelled -- the products exact, every
    addend (the accumulator too) truncated toward zero to a multiple of
    2^(e - TC_ALIGN_BITS), their sum exact, and the sum truncated to
    float32.  e is the largest addend exponent, where a product's exponent
    is the sum of its inputs' (frexp) exponents, not its own: a product of
    significands below 1 keeps the inputs' alignment (fitted on signed data,
    where cancelling sums showed it)."""
    a, b = a.double(), b.double()
    prods = a[:, None, :] * b[None, :, :]
    pe = _exponent(a)[:, None, :] + _exponent(b)[None, :, :]
    pd = part.double()
    e = torch.maximum(pe.amax(2, keepdim=True), _exponent(pd)[:, :, None])
    unit = torch.ldexp(torch.ones_like(e, dtype=torch.float64), (e - TC_ALIGN_BITS).double())
    terms = torch.cat([pd[:, :, None], prods], 2)
    return _round_toward_zero((torch.trunc(terms / unit) * unit).sum(2))


def scan_scores_tf32(queries, base, metric: str = "l2", passes: int = 3,
                     depth: int = SCAN_DEPTH, return_peak: bool = False):
    """Plain emulation of the tensor-core score pass.  q.x comes from TF32
    splits (passes=3: lo_q.hi_x + hi_q.lo_x + hi_q.hi_x, the kernel's
    3xTF32; passes=1: hi_q.hi_x, plain TF32), one instruction of 8 products
    at a time into the step's float32 partial (:func:`_tensor_core_step`:
    aligned, truncated addends and a sum truncated toward zero); every
    ``depth`` of K the partial is added to the running float32 total (round
    to nearest) and a fresh one begins.  Row norms are summed in the kernel's order
    (16-deep FMA chains), and the score is (|q|^2 - 2 q.x) + |x|^2 (L2) or
    -q.x (IP) in float32.  A model: on an H100 it gave 99.96% to 100% of the
    kernel's scores bit for bit at D = 768 on nonnegative and on signed
    data, and ``tests/test_torch_cuda.py`` holds the kernel to it on the
    card.  ``return_peak`` also returns the largest magnitude the running
    q.x total took (the scale at which its sum rounds; |q.x| itself when
    every addend is nonnegative)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    q = queries.to(torch.float32)
    x = base.to(torch.float32)
    qh, ql = split_tf32(q)
    xh, xl = split_tf32(x)
    terms = ((ql, xh), (qh, xl), (qh, xh)) if passes == 3 else ((qh, xh),)
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    peak = torch.zeros_like(acc)
    part = torch.zeros_like(acc)
    d = q.shape[1]
    for k0 in range(0, d, 8):
        sl = slice(k0, k0 + 8)
        for a, b in terms:
            part = _tensor_core_step(part, a[:, sl], b[:, sl])
        if (k0 + 8) % depth == 0 or k0 + 8 >= d:
            acc = acc + part
            peak = torch.maximum(peak, acc.abs())
            part = torch.zeros_like(acc)
    if metric == "ip":
        scores = -acc
    else:
        scores = (_kernel_norms(q)[:, None] - 2.0 * acc) + _kernel_norms(x)[None, :]
    return (scores, peak) if return_peak else scores


#: What ``model_tie`` requires of the card: this share of the scores
#: bit-exact against ``scan_scores_tf32``, none further than this many ulps.
MODEL_TIE = (0.99, 4.0)


def model_tie_inputs(kernel: str, nq: int, signed: bool = False):
    """``model_tie``'s seeded inputs on the host: queries [nq, 768] and the
    1,000 rows the kernel scores (``x``, decoded for SQ), plus the SQ codes
    and range.  Nonnegative, or with ``signed`` centred on 0, so partial
    sums cancel."""
    rng = np.random.default_rng(nq + (1000 if signed else 0))
    n, d = 1000, 768
    shift = 0.5 if signed else 0.0
    q = torch.from_numpy(rng.random((nq, d), dtype=np.float32) - np.float32(shift))
    if kernel == "l2_topk":
        x = torch.from_numpy(rng.random((n, d), dtype=np.float32) - np.float32(shift))
        return {"q": q, "x": x}
    codes = torch.from_numpy(rng.integers(0, 256, (n, d), dtype=np.uint8))
    lo = torch.from_numpy(rng.random(d, dtype=np.float32) * np.float32(0.1) - np.float32(shift))
    hi = lo + 1.0
    from .kernels import sq_codec as sq_mod

    return {"q": q, "x": sq_mod.sq_decode_plain(codes, lo, hi), "codes": codes, "lo": lo, "hi": hi}


def model_tie(kernel: str, nq: int, dev, signed: bool = False) -> dict:
    """How closely the tensor-core score pass of ``kernel`` (``"l2_topk"``
    or ``"sq_l2_topk"``; nq > 8 takes that path) follows
    :func:`scan_scores_tf32`, on seeded data (:func:`model_tie_inputs`:
    nonnegative, so no partial sum cancels, or ``signed``, centred rows):
    ``nq`` queries against 1,000 rows of 768, k = 1,000 so every score
    comes back.  Per metric, the share of scores equal to the model's bit
    for bit and the largest distance in float32 ulps of the magnitudes the
    expression rounds at: for IP the largest the running q.x total took
    (|q.x| on nonnegative data), for L2 the largest of that, |q|^2 and
    |x|^2."""
    from .kernels import l2_topk as l2_mod
    from .kernels import sq_codec as sq_mod

    inp = model_tie_inputs(kernel, nq, signed)
    q, x = inp["q"], inp["x"]
    n = x.shape[0]
    if kernel == "l2_topk":

        def run(metric):
            return l2_mod.l2_topk(q.to(dev), [x.to(dev)], [None], n, metric)
    else:

        def run(metric):
            return sq_mod.sq_l2_topk(q.to(dev), inp["codes"].to(dev), inp["lo"].to(dev),
                                     inp["hi"].to(dev), None, n, metric)
    neg_qx, peak = scan_scores_tf32(q, x, "ip", return_peak=True)
    qx = -neg_qx
    big = torch.maximum(peak, torch.maximum((q * q).sum(1)[:, None], (x * x).sum(1)[None, :]))
    out = {}
    for metric, model, mag in (("ip", qx, peak), ("l2", scan_scores_tf32(q, x, "l2"), big)):
        vals, idx = run(metric)
        got = torch.empty((nq, n)).scatter_(1, idx.cpu(), vals.cpu())
        ulps = (got - model).abs() / (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag)
        out[metric] = ((got == model).double().mean().item(), ulps.max().item())
    return out


def topk_select_two_stage(scores, k: int, metric: str = "l2", chunk: int = SELECT_CHUNK):
    """Plain emulation of the kernel's two-stage select over one segment's
    ascending keys ``scores`` [nq, n]: stage A keeps each ``chunk``-row
    chunk's best min(k, rows) by (key, row), stage B merges the chunk lists
    in chunk order by a stable sort (list order is row order among equal
    keys).  Same contract as ``kernels.l2_topk.topk_select_plain``."""
    nq, n = scores.shape
    fill = float("inf") if metric == "l2" else float("-inf")
    out_v = torch.full((nq, k), fill, dtype=torch.float32)
    out_i = torch.full((nq, k), -1, dtype=torch.int64)
    if n == 0:
        return out_v, out_i
    cand_v, cand_i = [], []
    for r0 in range(0, n, chunk):
        part = scores[:, r0 : r0 + chunk]
        v, i = torch.sort(part, dim=1, stable=True)
        keep = min(k, part.shape[1])
        cand_v.append(v[:, :keep])
        cand_i.append(i[:, :keep] + r0)
    v, order = torch.sort(torch.cat(cand_v, 1), dim=1, stable=True)
    i = torch.gather(torch.cat(cand_i, 1), 1, order)
    k_eff = min(k, n)
    v, i = v[:, :k_eff], i[:, :k_eff]
    out_i[:, :k_eff] = torch.where(v.abs() >= 1e38, -1, i)
    out_v[:, :k_eff] = -v if metric == "ip" else v
    return out_v, out_i


def assign_tf32(x, centroids):
    """Plain model of ``kmeans_assign``'s tensor-core path
    (``csrc/kmeans_assign.cu``): x.c from :func:`scan_scores_tf32`'s
    3xTF32 product (the rows as the base, the centroids as the queries),
    norms in the kernel's order, d2 = (|x|^2 - 2 x.c) + |c|^2 in float32,
    and the earliest centroid winning equal d2.  ``(assign [n] int64,
    min_d2 [n] float32)``."""
    x = x.to(torch.float32)
    c = centroids.to(torch.float32)
    xc = -scan_scores_tf32(c, x, "ip").T
    d2 = (_kernel_norms(x)[:, None] - 2.0 * xc) + _kernel_norms(c)[None, :]
    min_d2, assign = torch.min(d2, dim=1)
    return assign, min_d2


def adc_scores_grouped(luts, codes, group: int) -> torch.Tensor:
    """Plain model of the ADC score pass (``csrc/pq_adc.cu``): the tables of
    each group of ``group`` queries interleaved as [m, ksub, group] (the
    kernel's shared-memory layout, 0 past nq), each row's codes gathered
    once per group, and the group's ``group`` sums added over m = 0..M-1 in
    order.  [nq, n] float32."""
    nq, m, ksub = luts.shape
    pad = -nq % group
    tables = torch.cat([luts, luts.new_zeros((pad, m, ksub))]) if pad else luts
    tables = tables.reshape(-1, group, m, ksub).permute(0, 2, 3, 1).contiguous()
    codes = codes.to(torch.int64)
    out = torch.zeros((tables.shape[0], codes.shape[0], group), dtype=torch.float32)
    for j in range(m):
        out += tables[:, j].index_select(1, codes[:, j])
    return out.permute(0, 2, 1).reshape(-1, codes.shape[0])[:nq]


def assert_ties_by_row(vals, idx, ties, equal: bool) -> None:
    """One query's answer ``(vals [k], idx [k])`` in which the equal rows
    ``ties`` (ascending, across select-chunk edges) lead: the leading slots
    hold tied rows, and where the scan scored them all equal (``equal``,
    read from an answer with k >= len(ties)) the lowest rows come first."""
    lead = idx[: min(len(idx), len(ties))].tolist()
    if not set(lead) <= set(ties):
        raise AssertionError(f"tied rows {ties} do not lead the answer: {lead}")
    if equal and lead != list(ties[: len(lead)]):
        raise AssertionError(f"ties broken out of row order across chunks: {lead}")


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


def assign_error_float64(got, x, centroids, rtol: float, atol: float) -> float:
    """Check a nearest-centroid assignment ``got`` = (assign, min_d2)
    against float64: each returned distance within the tolerance of the
    float64 distance to the chosen centroid, which must itself lie within
    the tolerance of the float64 nearest.  For rows near their centroids,
    where the expansion cancels (d2 far below |x|^2 and |c|^2) and two
    float32 versions may differ by their two errors together.  Returns the
    largest distance error."""
    ga, gd = got
    x64, c64 = x.double(), centroids.double()
    d64 = ((x64 * x64).sum(1, keepdim=True) - 2.0 * (x64 @ c64.T)) + (c64 * c64).sum(1)[None, :]
    chosen = d64.gather(1, ga[:, None])[:, 0]
    torch.testing.assert_close(gd.double(), chosen, rtol=rtol, atol=atol)
    torch.testing.assert_close(chosen, d64.min(1).values, rtol=rtol, atol=atol)
    return (gd.double() - chosen).abs().max().item()


# --------------------------------------------------------------------------
# Float64 oracle over what query nodes hold (chip_smoke.py and the tests)
# --------------------------------------------------------------------------


def l2_scores(q, x) -> torch.Tensor:
    """[nq, n] squared L2 distances by the plain expansion."""
    return ((q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T)) + (x * x).sum(1)[None, :]


def sq_decoded(codes, vmin, vmax) -> torch.Tensor:
    """SQ rows as the codec defines them (float32, two roundings)."""
    scale = torch.clamp_min(vmax - vmin, 1e-12) / 255.0
    return codes.float() * scale[None, :] + vmin[None, :]


def lut_tables(q, codebooks) -> torch.Tensor:
    """L2 ADC tables [nq, m, ksub], the plain per-subspace expression."""
    m, _ksub, dsub = codebooks.shape
    qs = q.reshape(len(q), m, dsub)
    dots = torch.einsum("nmd,mkd->nmk", qs, codebooks)
    return ((qs * qs).sum(-1)[:, :, None] - 2.0 * dots) + (codebooks * codebooks).sum(-1)[None]


def lut_sums(lut, codes) -> torch.Tensor:
    """[nq, n] table sums over m = 0..M-1 in order."""
    codes = codes.long()
    out = torch.zeros((lut.shape[0], codes.shape[0]), dtype=lut.dtype, device=lut.device)
    for j in range(codes.shape[1]):
        out += lut[:, j, :].index_select(1, codes[:, j])
    return out


def oracle_unit(index, q, valid) -> torch.Tensor:
    """[nq, n] float64 L2 scores of one loaded index over its own rows
    (original order), +inf where the index does not score the row for that
    query: the probed lists' rows for IVF (probe by a full stable sort of
    the centroid distances), the probed buckets' rows for the bucket index,
    every valid row otherwise.  float64 makes these
    the exact values of the index's semantics (SQ rows decode in float32,
    as the index defines them), which the port's float32 answers are held
    to within ``SCORE_TOL``."""
    inf = float("inf")
    kind = index.KIND
    q = q.double()
    if kind == "flat":
        s = l2_scores(q, index.vectors.double())
    elif kind == "sq":
        s = l2_scores(q, sq_decoded(index.codes, index.vmin, index.vmax).double())
    elif kind == "pq":
        s = lut_sums(lut_tables(q, index.codebooks.double()), index.codes)
    elif kind == "bucket":
        s = _bucket_scores(index, q)
    elif kind not in ("ivf_flat", "ivf_sq", "ivf_pq"):
        raise ValueError(f"no oracle for index kind {kind!r}")
    else:
        c = index.centroids.double()
        nprobe = min(int(index.params["nprobe"]), len(c))
        probes = torch.sort(l2_scores(q, c), dim=1, stable=True).indices[:, :nprobe]
        probed = torch.zeros((len(q), len(c)), dtype=torch.bool, device=q.device)
        probed.scatter_(1, probes, True)
        counts = (index.list_offsets[1:] - index.list_offsets[:-1]).to(q.device)
        row_list = torch.repeat_interleave(torch.arange(len(c), device=q.device), counts)
        if kind == "ivf_flat":
            s = l2_scores(q, index.storage.double())
        elif kind == "ivf_sq":
            s = l2_scores(q, sq_decoded(index.codes, index.vmin, index.vmax).double())
        else:  # ivf_pq: residual tables per (query, probed list)
            s = torch.full((len(q), index.num_rows), inf, dtype=torch.float64, device=q.device)
            offsets = index.list_offsets.tolist()
            for lst in range(len(c)):
                lo, hi = offsets[lst], offsets[lst + 1]
                qsel = torch.nonzero(probed[:, lst]).squeeze(1)
                if hi <= lo or qsel.numel() == 0:
                    continue
                lut = lut_tables(q[qsel] - c[lst][None, :], index.codebooks.double())
                cols = torch.arange(lo, hi, device=q.device)
                s[qsel[:, None], cols[None, :]] = lut_sums(lut, index.codes[lo:hi])
        s = torch.where(probed[:, row_list], s, inf)
        unperm = torch.empty_like(s)
        unperm[:, index.row_ids] = s
        s = unperm
    return torch.where(valid[None, :], s, inf)


def _bucket_scores(index, q) -> torch.Tensor:
    """A bucket index's [nq, num_rows] float64 scores: probe by a full
    stable sort of the centre distances, score every probed slot (SQ slots
    decode in float32, as the index defines them), keep each row's best."""
    c = index.centers.double()
    nprobe = min(int(index.params["nprobe_buckets"]), len(c))
    probes = torch.sort(l2_scores(q, c), dim=1, stable=True).indices[:, :nprobe]
    probed = torch.zeros((len(q), len(c)), dtype=torch.bool, device=q.device)
    probed.scatter_(1, probes, True)
    counts = (index.bucket_offsets[1:] - index.bucket_offsets[:-1]).to(q.device)
    slot_bucket = torch.repeat_interleave(torch.arange(len(c), device=q.device), counts)
    rows = (sq_decoded(index.storage, index.vmin, index.vmax) if index.compress
            else index.storage)
    slots = torch.where(probed[:, slot_bucket], l2_scores(q, rows.double()), float("inf"))
    s = torch.full((len(q), index.num_rows), float("inf"), dtype=torch.float64, device=q.device)
    return s.scatter_reduce(1, index.bucket_rows.expand(len(q), -1), slots, "amin")


#: The filtered planner's brute rule (``core/query_node.py``): a unit whose
#: filter keeps at most max(2k, 64) rows, or a quarter of its visible rows,
#: is scanned exactly over the passing rows.  Pre- and post-filtering both
#: give the index's answer over the passing rows.
def _brute_filtered(n_vis: int, n_comb: int, k: int) -> bool:
    return n_comb <= max(2 * k, 64) or n_comb <= 0.25 * n_vis


def system_oracle(nodes, collection: str, q, k: int, pin: int, deleted, passes=None) -> dict:
    """The float64 top-k of an L2 search pinned at ``pin`` over every unit
    that the query ``nodes`` hold of ``collection``: sealed segments through
    their loaded index (exactly where none), growing segments through their
    interim slice indexes and an exact tail.  A row is visible when its LSN
    is at most ``pin`` and its pk is not in ``deleted`` (the pks deleted at
    or before the pin); ``passes(segment)`` gives a filter's row mask.
    Returns ``want`` (scores float64, pks), the merged ``all_scores`` /
    ``all_pks`` and, per unit, its ``kinds`` and column ``bounds``."""
    inf = float("inf")
    q = q.double()
    parts, pk_parts, kinds = [], [], []

    def visible(seg):
        vis = seg.timestamps() <= pin
        if deleted is not None and deleted.numel():
            vis &= ~torch.isin(seg.pks(), deleted.to(vis.device))
        fmask = None if passes is None else passes(seg).to(vis.device)
        return vis, (vis if fmask is None else vis & fmask), fmask is not None

    def exact(seg, lo, hi, valid):
        s = l2_scores(q, seg.vectors()[lo:hi].double())
        return torch.where(valid[None, :], s, inf)

    for node in nodes:
        for (coll, _sid), h in sorted(node.sealed.items()):
            if coll != collection or h.retired_at_ts is not None:
                continue
            seg = h.segment
            vis, comb, filtered = visible(seg)
            n_comb = int(comb.sum())
            if n_comb == 0:
                continue
            if h.index is None or (filtered and _brute_filtered(int(vis.sum()), n_comb, k)):
                parts.append(exact(seg, 0, seg.num_rows, comb))
                kinds.append("exact")
            else:
                parts.append(oracle_unit(h.index, q, comb))
                kinds.append(h.index.KIND)
            pk_parts.append(seg.pks())
        for (coll, _sid), seg in sorted(node.growing.items()):
            if coll != collection or seg.num_rows == 0:
                continue
            _vis, comb, _ = visible(seg)
            tail = 0  # slices cover a prefix of the segment
            for s_idx, idx in sorted(seg.slice_indexes.items()):
                lo, hi = seg.slice_bounds(s_idx)
                tail = max(tail, hi)
                parts.append(oracle_unit(idx, q, comb[lo:hi]))
                pk_parts.append(seg.pks()[lo:hi])
                kinds.append("interim ivf_flat")
            if tail < seg.num_rows:
                parts.append(exact(seg, tail, seg.num_rows, comb[tail:]))
                pk_parts.append(seg.pks()[tail:])
                kinds.append("brute tail")
    all_pks = torch.cat(pk_parts) if pk_parts else torch.empty(0, dtype=torch.int64)
    if len(torch.unique(all_pks)) != len(all_pks):
        raise AssertionError(f"{collection}: a pk is held by two units of the nodes")
    all_scores = (
        torch.cat(parts, 1) if parts else torch.empty((len(q), 0), dtype=torch.float64)
    )
    pad = max(0, k - all_scores.shape[1])
    vals, order = torch.sort(
        torch.cat([all_scores, all_scores.new_full((len(q), pad), inf)], 1), dim=1, stable=True
    )
    want_s = vals[:, :k]
    order = order[:, :k].clamp(max=max(len(all_pks) - 1, 0))
    want_p = torch.where(torch.isfinite(want_s), all_pks[order] if len(all_pks) else -1, -1)
    bounds = torch.tensor([0] + [len(p) for p in pk_parts]).cumsum(0)
    return {
        "want": (want_s, want_p), "all_scores": all_scores, "all_pks": all_pks,
        "kinds": kinds, "bounds": bounds,
    }


def assert_oracle_answer(label: str, got, oracle: dict, rtol: float, atol: float) -> int:
    """A search answer ``got`` = (scores, pks) [nq, k] against
    :func:`system_oracle`'s top-k: the same empty slots, scores within the
    tolerance slot by slot, and a pk that differs from the oracle's must
    score (by the oracle) within the tolerance of the oracle's score at
    that slot.  Returns the number of such near-tie swaps."""
    got_s, got_p = got
    want_s, want_p = oracle["want"]
    if got_s.shape != want_s.shape or got_p.dtype != torch.int64:
        raise AssertionError(f"{label}: malformed result {tuple(got_s.shape)}")
    got_s, got_p = got_s.to(want_s.device), got_p.to(want_s.device)
    if not torch.equal(got_p >= 0, want_p >= 0):
        raise AssertionError(f"{label}: empty-slot pattern differs from the oracle")
    live = want_p >= 0
    torch.testing.assert_close(got_s[live].double(), want_s[live], rtol=rtol, atol=atol)
    diff = (got_p != want_p) & live
    if diff.any():
        all_pks = oracle["all_pks"]
        col_of_pk = torch.full(
            (int(all_pks.max()) + 1,), -1, dtype=torch.int64, device=all_pks.device
        )
        col_of_pk[all_pks] = torch.arange(len(all_pks), device=all_pks.device)
        qi, slot = torch.nonzero(diff, as_tuple=True)
        pk = got_p[qi, slot]
        if bool((pk > int(all_pks.max())).any()) or bool((col_of_pk[pk] < 0).any()):
            raise AssertionError(f"{label}: a pk the nodes do not hold was returned")
        torch.testing.assert_close(
            oracle["all_scores"][qi, col_of_pk[pk]], want_s[qi, slot], rtol=rtol, atol=atol
        )  # a pk the oracle never scored reads +inf and fails here
    return int(diff.sum())


# ------------------------------------------------------------- models --
#: Logit bound (float32 logits of a bf16 model) between two runs of one
#: model whose bf16 products add in other orders: the CPU tests hold the
#: port's logits to the reference's within it at the reduced (2-layer)
#: sizes.  Deeper models drift by about one bf16 ulp of the residual per
#: layer, so ``logit_atol`` scales it by depth over 2 (reduced jamba's one
#: 8-layer period: 4x, as ``tests/_torch_model_refs.DEPTH_SCALE``).
LOGIT_ATOL = 2e-2
#: Decode against one prefill over the whole sequence: the reference's
#: ``test_prefill_decode_parity`` bound.
DECODE_ATOL = 0.15


def logit_atol(cfg) -> float:
    return LOGIT_ATOL * max(1.0, cfg.num_layers / 2)


def greedy_mismatches(got, want, tie: float) -> tuple[int, int]:
    """Positions whose argmax differs between ``got`` and ``want`` (float32
    logits [..., V]) while ``want``'s top two lie more than ``tie`` apart,
    and the positions where they lie within it (near-ties)."""
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= tie
    return int(((got.argmax(-1) != want.argmax(-1)) & ~near).sum()), int(near.sum())


def assert_logits_close(label: str, got, want, atol: float) -> int:
    """``got`` within ``atol`` of ``want`` (float32 logits [B, S, V]); the
    argmax equal at every position except where ``want``'s top two lie
    within ``atol`` of each other.  Returns the number of such near-ties."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not torch.isfinite(got).all() or err > atol:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max |err| {err:.4g} > {atol}")
    bad, ties = greedy_mismatches(got, want, atol)
    if bad:
        raise AssertionError(f"{label}: {bad} greedy tokens differ outside the near-ties")
    return ties


def compare_decode(cfg, cpu_model, model, tokens, prefix, steps: int, atol: float) -> dict:
    """``prefill`` of ``tokens`` [B, S] (after ``prefix``) and ``steps``
    ``decode_step``s through two copies of one model, ``cpu_model`` on the
    CPU and ``model`` on another device, both fed the CPU copy's greedy
    token each step.  Raises unless each step's logits agree within
    ``atol`` (``assert_logits_close``).  Returns the largest difference,
    the near-ties and the CPU's greedy tokens."""
    from .models import model as M

    b, s = tokens.shape
    p = 0 if prefix is None else prefix.shape[1]
    dev = model.device
    caches = [M.init_cache(cfg, b, p + s + steps, device=m.device) for m in (cpu_model, model)]
    out = {"max_abs_err": 0.0, "near_ties": 0, "tokens": []}

    def check(label, want, got):
        out["near_ties"] += assert_logits_close(label, got, want, atol)
        out["max_abs_err"] = max(out["max_abs_err"], (got.float().cpu() - want).abs().max().item())

    with torch.no_grad():
        want, caches[0] = M.prefill(cfg, cpu_model, tokens.cpu(), caches[0],
                                    None if prefix is None else prefix.cpu())
        got, caches[1] = M.prefill(cfg, model, tokens.to(dev), caches[1],
                                   None if prefix is None else prefix.to(dev))
        check(f"{cfg.name} prefill", want, got)
        tok = want[:, -1:].argmax(-1)
        for step in range(steps):
            out["tokens"].append(tok)
            want, caches[0] = M.decode_step(cfg, cpu_model, caches[0], tok)
            got, caches[1] = M.decode_step(cfg, model, caches[1], tok.to(dev))
            check(f"{cfg.name} decode step {step}", want, got)
            tok = want.argmax(-1)
    out["tokens"] = torch.cat(out["tokens"], 1)
    return out


# ----------------------------------------------------------- training --
#: ``lm_loss`` of one bf16 model computed two ways (the port against the
#: reference on the CPU, or the card against the CPU): 2-layer models
#: differ by at most 4e-4 in the CPU tests, reduced jamba (8 layers) by
#: 7e-4.  ``loss_atol`` scales it with depth as ``logit_atol`` does.
LOSS_ATOL = 2e-3
#: The global relative L2 difference of two bf16 gradient trees of one
#: model (the port against ``jax.grad``: 1.2-1.5% on 2-layer models): each
#: bf16 rounding in the backward pass falls elsewhere.
GRAD_RTOL = 3e-2


def loss_atol(cfg) -> float:
    return LOSS_ATOL * max(1.0, cfg.num_layers / 2)


def grad_rel_l2(got: dict, want: dict) -> float:
    """The global relative L2 difference of two gradient trees with the
    same keys, in float32: ||got - want|| / ||want|| over every leaf."""
    num = sum(float((got[k].float() - w.float()).square().sum()) for k, w in want.items())
    den = sum(float(w.float().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def compare_train_step(cfg, cpu_model, model, batch: dict, adamw=None) -> dict:
    """One ``launch.steps.build_local_train_cell`` step through two copies of one
    model, ``cpu_model`` on the CPU and ``model`` on another device, on the
    same batch.  Raises unless the losses agree within ``loss_atol`` and
    the gradient norms within ``GRAD_RTOL``.  Returns both differences."""
    from .launch.steps import build_local_train_cell
    from .train.optimizer import init_opt_state

    step = build_local_train_cell(cfg, adamw)
    dev = model.device
    out = {}
    for key, m in (("cpu", cpu_model), ("device", model)):
        mb = {k: v.to(m.device) for k, v in batch.items() if v is not None}
        _m, _o, metrics = step(m, init_opt_state(dict(m.named_parameters())), mb)
        out[key] = {k: float(v) for k, v in metrics.items()}
    loss_err = abs(out["device"]["loss"] - out["cpu"]["loss"])
    norm_err = abs(out["device"]["grad_norm"] / out["cpu"]["grad_norm"] - 1)
    if not loss_err <= loss_atol(cfg) or not norm_err <= GRAD_RTOL:
        raise AssertionError(f"{cfg.name} train step on {dev} against the CPU: loss {out['device']['loss']:.6f} "
                             f"vs {out['cpu']['loss']:.6f}, grad norm {out['device']['grad_norm']:.6f} vs "
                             f"{out['cpu']['grad_norm']:.6f}")
    return {"loss_abs_err": loss_err, "grad_norm_rel_err": norm_err, **out}
