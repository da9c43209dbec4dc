"""The redesigned index kernels' arithmetic, modelled in plain torch on the
CPU (``repro_torch.testing``).

``kmeans_assign``'s tensor-core path is the scans' 3xTF32 score pass with
the rows as the base and the centroids as the queries, d2 = (|x|^2 -
2 x.c) + |c|^2 in float32 and the earliest centroid winning equal d2:
``testing.assign_tf32`` models it (the product of ``scan_scores_tf32``,
which ``tests/test_torch_cuda.py`` ties to the card), and it must agree
with the reference's host ``kmeans_assign`` within the score tolerance at
the build paths' widths (an interim slice index, an IVF Lloyd step, a PQ
subspace; rows cut to 1,024, 128 and 1,024 to keep the CPU suite short),
and stay within it of float64 on rows near their centroids, where the
expansion cancels.

``pq_adc_topk``'s score pass serves groups of ``query_group`` queries from
tables interleaved as [m, ksub, G]; ``testing.adc_scores_grouped`` models
the layout and the per-group add chains, and must equal the plain sums and
the reference's ``pq_adc_topk`` bit for bit."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_FORCE_PALLAS", "0")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.kernels import kmeans_assign as km_mod  # noqa: E402
from repro_torch.kernels import pq_adc as pq_mod  # noqa: E402
from repro_torch.testing import SCORE_TOL, assert_assign_close, assert_topk_near_tie  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The float64 models run many small tensor ops: one intra-op thread
    each keeps the suite's parallel workers from oversubscribing the
    cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mixture(rng, n: int, c: int, d: int):
    """Rows drawn around c unit-normal centers with 0.5 x unit-normal noise
    (the chip cells' data), and those centers perturbed as the centroids."""
    centers = rng.standard_normal((c, d)).astype(np.float32)
    x = centers[rng.integers(0, c, n)] + 0.5 * rng.standard_normal((n, d)).astype(np.float32)
    cent = centers + 0.1 * rng.standard_normal((c, d)).astype(np.float32)
    return x.astype(np.float32), cent.astype(np.float32)


@pytest.mark.parametrize("n,c,d", [(1024, 16, 768), (128, 128, 768), (1024, 256, 16)])
def test_tensor_core_assignment_model_matches_reference(n, c, d):
    rng = np.random.default_rng(n + c + d)
    x, cent = _mixture(rng, n, c, d)
    ref_a, ref_d = ref_ops.kmeans_assign(x, cent)
    want = (torch.from_numpy(np.asarray(ref_a)), torch.from_numpy(np.asarray(ref_d, np.float32)))
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    got = testing.assign_tf32(xt, ct)
    assert_assign_close(got, want, xt, ct, *SCORE_TOL["l2"])
    # the same as the port's plain version, which the card's answers are held to
    assert_assign_close(got, km_mod.kmeans_assign_plain(xt, ct), xt, ct, *SCORE_TOL["l2"])


@pytest.mark.parametrize("c,d", [(32, 768), (256, 16)])
def test_tensor_core_assignment_model_holds_float64_on_near_rows(c, d):
    """Rows 0.1 sigma from their centroid: d2 ~ 0.01 d against norms ~ d,
    where the expansion cancels; the model stays within the score tolerance
    of float64 (and of the float64 nearest centroid)."""
    rng = np.random.default_rng(c + d)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    x = cent[rng.integers(0, c, 256)] + 0.1 * rng.standard_normal((256, d)).astype(np.float32)
    xt, ct = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(cent)
    testing.assign_error_float64(testing.assign_tf32(xt, ct), xt, ct, *SCORE_TOL["l2"])


def test_tensor_core_assignment_model_takes_the_earliest_copy():
    """Centroids 0..149 again at 150..299, so copies sit on both sides of
    the 128-centroid tile edges: they tie exactly, and the earliest wins,
    as in the reference."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((150, 64)).astype(np.float32)
    cent = np.concatenate([base, base])
    x = base[rng.integers(0, 150, 300)] + 0.1 * rng.standard_normal((300, 64)).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    got_a, got_d = testing.assign_tf32(xt, ct)
    ref_a, _ = ref_ops.kmeans_assign(x, cent)
    assert bool((got_a < 150).all())
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))


def test_kmeans_assign_on_the_cpu_ignores_the_path_threshold():
    rng = np.random.default_rng(8)
    x, cent = (torch.from_numpy(a) for a in _mixture(rng, 300, 20, 32))
    want = km_mod.kmeans_assign_plain(x, cent)
    for small_c in (None, 0, 32):
        got = km_mod.kmeans_assign(x, cent, small_c=small_c)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nq,m,ksub,group", [
    (100, 48, 256, 4), (3, 48, 256, 4), (2, 48, 256, 2), (1, 48, 256, 1),
    (100, 100, 256, 2), (100, 227, 256, 1), (5, 8, 16, 4),
])
def test_query_group_fits_one_block(nq, m, ksub, group):
    g = pq_mod.query_group(nq, m, ksub)
    assert g == group
    assert g * 4 * m * ksub <= pq_mod.MAX_LUT_BYTES


@pytest.mark.parametrize("code_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("nq,m,ksub", [(1, 48, 256), (3, 20, 16), (5, 8, 256), (8, 48, 16)])
def test_grouped_adc_scores_are_bit_exact(nq, m, ksub, code_dtype):
    """The interleaved layout summed per group, over every group size the
    kernel may take, equals the plain sums and the reference's top-k bit
    for bit; ids differ only among exactly tied scores (ties planted; the
    reference's argpartition does not order them by row)."""
    rng = np.random.default_rng(nq * 100 + m + ksub)
    n, k = 3000, 100
    luts = rng.standard_normal((nq, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(code_dtype)
    codes[:30] = codes[0]
    valid = rng.random(n) > 0.1
    lt, ct = torch.from_numpy(luts), torch.from_numpy(codes)
    plain = pq_mod.adc_scores_plain(lt, ct)
    ref_v, ref_i = ref_ops.pq_adc_topk(luts, codes, k, valid=valid)
    for group in (1, 2, 4):
        scores = testing.adc_scores_grouped(lt, ct, group)
        assert torch.equal(scores, plain), group
        scores = scores.masked_fill(~torch.from_numpy(valid)[None, :], float("inf"))
        vals, idx = torch.sort(scores, dim=1, stable=True)
        want = (torch.from_numpy(np.asarray(ref_v)), torch.from_numpy(np.asarray(ref_i, np.int64)))
        assert torch.equal(vals[:, :k], want[0]), group
        assert_topk_near_tie((vals[:, :k], idx[:, :k]), want, 0.0, 0.0)
