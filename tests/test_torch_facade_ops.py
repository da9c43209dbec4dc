"""The ops the proxy, the loggers and the IVF-SQ norms use, on the CPU,
against ``repro.kernels.ops``: ``sq_decode`` bit-exact against the host
decode, ``shard_split`` exact, ``normalized_similarity`` / ``hybrid_fuse``
with exact pks and scores within 4 float32 ulps (numpy's and torch's
float32 ``exp`` may round differently, and the division after it doubles
that).  ``sq_decode`` against the Pallas kernel in interpret mode is held
to 4 ulps of ``|code * scale| + |vmin|``: XLA compiles the kernel's
``c * scale + vmin`` with one rounding where the host decode has two."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's import order)
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.sq_codec import sq_decode_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sq_codec as sq_mod  # noqa: E402

ULP = 1.2e-7  # one float32 ulp relative to 1


def _codec(rng, n, d):
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    vmin = rng.normal(size=d).astype(np.float32) * 3
    vmax = vmin + rng.random(d).astype(np.float32) * 5
    vmax[0] = vmin[0]  # a constant column: scale from the 1e-12 floor
    return codes, vmin, vmax


@pytest.mark.parametrize("n,d", [(1, 1), (1, 768), (37, 19), (513, 32), (1030, 48)])
def test_sq_decode_bit_exact_against_reference(n, d):
    codes, vmin, vmax = _codec(np.random.default_rng(n * 1000 + d), n, d)
    got = ops.sq_decode(torch.from_numpy(codes), torch.from_numpy(vmin), torch.from_numpy(vmax))
    want = ref_ops.sq_decode(codes, vmin, vmax)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_sq_decode_matches_pallas_interpret():
    codes, vmin, vmax = _codec(np.random.default_rng(3), 256, 24)
    got = ops.sq_decode(torch.from_numpy(codes), torch.from_numpy(vmin), torch.from_numpy(vmax))
    want = np.asarray(sq_decode_pallas(
        jnp.asarray(codes.astype(np.int32)), jnp.asarray(vmin), jnp.asarray(vmax),
        tn=128, interpret=True,
    ))
    scale = np.maximum(vmax - vmin, 1e-12) / 255.0
    bound = 4 * ULP * (np.abs(codes * scale) + np.abs(vmin))
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_sq_decode_rejects_what_the_kernel_does_not_take():
    codes, vmin, vmax = _codec(np.random.default_rng(4), 8, 16)
    c, lo, hi = torch.from_numpy(codes), torch.from_numpy(vmin), torch.from_numpy(vmax)
    with pytest.raises(ValueError):
        sq_mod.sq_decode(c.to(torch.int32), lo, hi)  # not uint8
    with pytest.raises(ValueError):
        sq_mod.sq_decode(c.T, lo, hi)  # not contiguous
    with pytest.raises(ValueError):
        sq_mod.sq_decode(c, lo[:8], hi[:8])  # range of the wrong width


@pytest.mark.parametrize("num_shards", [1, 2, 5])
def test_shard_split_matches_reference(num_shards):
    rng = np.random.default_rng(num_shards)
    shards = rng.integers(0, num_shards, 300)
    order, offsets = ops.shard_split(shards, num_shards)
    want_order, want_offsets = ref_ops.shard_split(shards, num_shards)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_normalized_similarity_matches_reference(metric):
    s = (np.random.default_rng(5).standard_normal((6, 40)) * 4).astype(np.float32)
    s[0, :3] = [-1e-6, 0.0, np.inf]
    got = ops.normalized_similarity(torch.from_numpy(s), metric).numpy()
    np.testing.assert_allclose(got, ref_ops.normalized_similarity(s, metric), rtol=4 * ULP, atol=0)


@pytest.mark.parametrize("kind", ["weighted", "rrf"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_hybrid_fuse_matches_reference(kind, metric):
    rng = np.random.default_rng(len(kind) * 7 + len(metric))
    scores = [np.sort(rng.standard_normal((5, m)).astype(np.float32) ** 2, 1) for m in (8, 6, 9)]
    pks = [rng.integers(-1, 14, s.shape) for s in scores]  # overlaps, empty slots
    scores[1][2, :] = np.inf  # a row with nothing live in one field
    for k in (4, 30):  # fewer candidates than k pads with (-inf, -1)
        got_s, got_p = ops.hybrid_fuse(
            [torch.from_numpy(s) for s in scores], [torch.from_numpy(p) for p in pks], k,
            metrics=metric, weights=[0.5, 0.3, 0.2], kind=kind,
        )
        want_s, want_p = ref_ops.hybrid_fuse(
            scores, pks, k, metrics=metric, weights=[0.5, 0.3, 0.2], kind=kind
        )
        np.testing.assert_array_equal(got_p.numpy(), want_p)
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=4 * ULP, atol=0)
