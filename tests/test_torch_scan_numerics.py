"""The scan kernels' arithmetic and select, emulated in plain torch on the
CPU (``repro_torch.testing``): the 3xTF32 tensor-core product, each 8-deep
step summed in a fresh partial, holds the score tolerance against float64
on data with the chip cells' norms, where plain TF32 does not and where
partials carried 64 deep drift further on a query against its own row;
its top-k equals the
reference package's ``topk_scan`` except at near-ties; and the two-stage
select (per-chunk top-k, then a merge of the chunk lists) equals the
one-stage stable sort of ``l2_topk_plain`` on the cases that could tell
them apart."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.kernels.l2_topk import topk_select_plain  # noqa: E402
from repro_torch.testing import SCORE_TOL  # noqa: E402

NQ, N, D = 64, 4096, 768


def _mixture(seed: int):
    """Gaussian-mixture rows and queries as on the chip's indexed and facade
    cells: unit-normal centers plus 0.5 x unit-normal noise, so |x|^2 ~ 960
    and same-center L2 distances ~ 384."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, D)).astype(np.float32)
    x = centers[rng.integers(0, 32, N)] + 0.5 * rng.standard_normal((N, D)).astype(np.float32)
    q = centers[rng.integers(0, 32, NQ)] + 0.5 * rng.standard_normal((NQ, D)).astype(np.float32)
    return q.astype(np.float32), x.astype(np.float32)


def _exact(q, x, metric):
    """float64 scores of the float32 inputs: ascending keys."""
    q64, x64 = torch.from_numpy(q).double(), torch.from_numpy(x).double()
    qx = q64 @ x64.T
    if metric == "ip":
        return -qx
    return ((q64 * q64).sum(1, keepdim=True) - 2.0 * qx) + (x64 * x64).sum(1)[None, :]


def _violations(got, want, rtol, atol):
    err = (got.double() - want).abs()
    return int((err > atol + rtol * want.abs()).sum()), err.max().item()


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {
        one + 2**-11: one + 2**-10,  # halfway: away from zero
        -(one + 2**-11): -(one + 2**-10),
        one + 2**-11 - 2**-23: one,  # just below halfway
        one + 3 * 2**-11: one + 2 * 2**-10,  # halfway above an odd mantissa
        2.0 - 2**-12: 2.0,  # carries into the exponent
        0.0: 0.0,
    }
    got = testing.tf32_rna(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(10_000) * 10.0 ** rng.integers(-6, 6, 10_000)).astype(np.float32))
    r = testing.tf32_rna(v)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0  # 13 low bits clear
    ulp = torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 11)  # TF32 ulp of v
    assert bool(((r - v).abs() <= ulp / 2).all())
    hi, lo = testing.split_tf32(v)
    assert bool(((hi.double() + lo.double() - v.double()).abs() <= v.double().abs() * 2.0**-21).all())


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_3xtf32_product_holds_score_tol_against_float64(metric):
    q, x = _mixture(1)
    want = _exact(q, x, metric)
    got = testing.scan_scores_tf32(torch.from_numpy(q), torch.from_numpy(x), metric, passes=3)
    bad, worst = _violations(got, want, *SCORE_TOL[metric])
    assert bad == 0, f"{bad} scores outside SCORE_TOL[{metric}], max |err| {worst:.3g}"


def test_3xtf32_product_holds_cosine_tol_on_normalized_rows():
    q, x = _mixture(2)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    want = _exact(q.astype(np.float32), x.astype(np.float32), "ip")
    got = testing.scan_scores_tf32(torch.from_numpy(q), torch.from_numpy(x), "ip", passes=3)
    bad, worst = _violations(got, want, *SCORE_TOL["cosine"])
    assert bad == 0, f"{bad} cosine scores outside SCORE_TOL, max |err| {worst:.3g}"


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_3xtf32_model_on_signed_rows_holds_score_tol(metric):
    """``model_tie``'s signed inputs (centred rows, partial sums that
    cancel) through the model: within SCORE_TOL of float64, and the running
    q.x total's largest magnitude at least |q.x| (the scale its ulps are
    counted in)."""
    inp = testing.model_tie_inputs("l2_topk", 4, signed=True)
    q, x = inp["q"], inp["x"]
    assert bool((q < 0).any() and (x < 0).any())
    want = _exact(q.numpy(), x.numpy(), metric)
    got, peak = testing.scan_scores_tf32(q, x, metric, return_peak=True)
    bad, worst = _violations(got, want, *SCORE_TOL[metric])
    assert bad == 0, f"{bad} scores outside SCORE_TOL[{metric}], max |err| {worst:.3g}"
    qx = -testing.scan_scores_tf32(q, x, "ip")
    assert bool((peak >= qx.abs()).all()) and bool((peak > qx.abs()).any())


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_plain_tf32_product_fails_score_tol(metric):
    """The tolerance has teeth: one TF32 product (no lo terms) misses it."""
    q, x = _mixture(3)
    if metric == "cosine":
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    m = "l2" if metric == "l2" else "ip"
    want = _exact(q, x, m)
    got = testing.scan_scores_tf32(torch.from_numpy(q), torch.from_numpy(x), m, passes=1)
    bad, _ = _violations(got, want, *SCORE_TOL[metric])
    assert bad > 0


def test_fresh_partial_per_step_keeps_self_match_error_small():
    """The tensor cores round each step's sum toward zero, so a partial
    carried across many steps drifts one way where every product is
    positive -- a query against its own row.  8-deep fresh partials (the
    kernel's) stay well inside the tolerance there; 64-deep ones err more."""
    q, x = _mixture(5)
    x = x[:512]
    q = x[:NQ].copy()
    want = _exact(q, x, "l2")
    rows = torch.arange(NQ)
    err = {}
    for depth in (8, 64):
        got = testing.scan_scores_tf32(torch.from_numpy(q), torch.from_numpy(x), "l2", depth=depth)
        err[depth] = (got.double() - want)[rows, rows].abs().max().item()
    rtol, atol = SCORE_TOL["l2"]
    assert err[8] <= atol / 2 < err[64] or err[8] < err[64] / 1.5, err


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_3xtf32_topk_matches_reference_topk_scan(metric):
    q, x = _mixture(4)
    rng = np.random.default_rng(4)
    valid = rng.random(N) > 0.1
    k = 100
    want_s, want_i = ref_ops.topk_scan(q, x, k, metric=metric, valid=valid)
    scores = testing.scan_scores_tf32(torch.from_numpy(q), torch.from_numpy(x), metric)
    scores = scores.masked_fill(~torch.from_numpy(valid)[None, :], float("inf"))
    got = topk_select_plain(scores, k, metric)
    testing.assert_topk_near_tie(
        got, (torch.from_numpy(np.asarray(want_s)), torch.from_numpy(np.asarray(want_i))),
        *SCORE_TOL[metric],
    )


CHUNK = 64  # a small chunk, so every case below spans several


def _keys(rng, nq, n):
    """Ascending keys with many exact ties: coarse values, a run of equal
    leading keys across every chunk edge, some invalid (+inf) rows."""
    s = np.round(rng.standard_normal((nq, n)) * 4) / 4
    for edge in range(CHUNK, n, CHUNK):
        s[:, max(0, edge - 3) : edge + 3] = -9.0  # ties straddling the edge
    s[:, rng.random(n) < 0.05] = np.inf
    return torch.from_numpy(s.astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [1, 5, 100, 200])
@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5])
def test_two_stage_select_equals_one_stage_sort(metric, k, n):
    rng = np.random.default_rng(n * 7 + k)
    s = _keys(rng, 9, n)
    got = testing.topk_select_two_stage(s, k, metric, chunk=CHUNK)
    want = topk_select_plain(s, k, metric)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("k", [1, 100, 1024])
def test_two_stage_select_all_invalid_and_kernel_chunk(k):
    """All-invalid rows (every key +inf, every index -1), and the kernel's
    own chunk over 3C + 5 rows with k > C / 8."""
    rng = np.random.default_rng(k)
    dead = torch.full((3, 3 * CHUNK + 5), float("inf"))
    for s in (dead, _keys(rng, 3, 3 * testing.SELECT_CHUNK + 5)):
        got = testing.topk_select_two_stage(s, k, "l2")
        want = topk_select_plain(s, k, "l2")
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert bool((testing.topk_select_two_stage(dead, k, "l2", chunk=CHUNK)[1] == -1).all())
