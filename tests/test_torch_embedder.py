"""The port's embedder against ``repro.models.embedder`` on the CPU, and
the slice as a whole: ``examples/serve_embedder.py``'s flow through both
packages.

Weights: the reference's ``init_params`` tree carried across by
``params_from_jax``.  Tolerances:
- an embedding within EMBED_ATOL = 5e-3 per component and EMBED_L2 = 0.02
  in L2 norm of the reference's (bf16 models; measured 2.0e-3 and 6.4e-3 at
  the example's sizes, yi-9b reduced to d 128, 2 layers, vocab 512);
- a search score is an inner product of unit rows, so two packages' scores
  of one pair differ by at most 2 * EMBED_L2 (|q'.x' - q.x| <= |q' - q| +
  |x' - x|): top-5 pks must match except where the reference's scores of
  the two pks lie within TIE_TOL = 2 * EMBED_L2 of each other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from _torch_model_refs import DEPTH_SCALE, FAMILIES, carried, inputs  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.embedder import Embedder as RefEmbedder  # noqa: E402
from repro.models.embedder import embed_tokens as ref_embed_tokens  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.embedder import Embedder, embed_tokens  # noqa: E402

EMBED_ATOL = 5e-3
EMBED_L2 = 0.02
TIE_TOL = 2 * EMBED_L2
EXAMPLE = dict(d_model=128, num_layers=2, vocab_size=512)


def _models(**overrides):
    cfg = REF_ARCHS["yi-9b"].reduced(**overrides)
    params = RM.init_params(cfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return cfg, params, params_from_jax(ARCHS["yi-9b"].reduced(**overrides), tree, device="cpu")


@pytest.fixture(scope="module")
def small():
    return _models()


def _assert_embeddings_close(got: np.ndarray, want: np.ndarray, scale: float = 1.0) -> None:
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * EMBED_ATOL)
    assert np.linalg.norm(got - want, axis=1).max(initial=0.0) <= scale * EMBED_L2


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_embed_tokens_matches_reference(small, masked):
    cfg, params, model = small
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((3, 10), np.int32)
        mask[0, 6:] = 0
        mask[2, 1:] = 0
        mask[1, :] = 0  # no token counts: the pooled row stays finite
    want = np.asarray(ref_embed_tokens(cfg, params, jnp.asarray(tok),
                                       None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = embed_tokens(model.cfg, model, torch.from_numpy(tok).long(),
                           None if mask is None else torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    _assert_embeddings_close(got.numpy(), want)
    norms = np.linalg.norm(got.numpy(), axis=1)
    live = [0, 2] if masked else [0, 1, 2]
    np.testing.assert_allclose(norms[live], 1.0, rtol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 7, 16, 21])
def test_embedder_micro_batches_like_reference(small, n):
    cfg, params, model = small
    tok = np.random.default_rng(n).integers(0, cfg.vocab_size, (n, 9)).astype(np.int32)
    want = RefEmbedder(cfg, params, max_batch=8).embed(tok)
    emb = Embedder(model.cfg, model, max_batch=8)
    got = emb.embed(tok)
    assert emb.dim == cfg.d_model and got.device == model.device
    assert tuple(got.shape) == (n, cfg.d_model) and got.dtype == torch.float32
    _assert_embeddings_close(got.numpy(), want)
    # a row's embedding does not depend on the micro-batch it rode in
    one = Embedder(model.cfg, model, max_batch=1).embed(tok)
    np.testing.assert_array_equal(one.numpy(), got.numpy())


def test_embedder_takes_a_mask_and_tensors(small):
    cfg, params, model = small
    rng = np.random.default_rng(9)
    tok = rng.integers(0, cfg.vocab_size, (5, 8)).astype(np.int32)
    mask = (rng.random((5, 8)) < 0.7).astype(np.int32)
    mask[:, 0] = 1
    want = RefEmbedder(cfg, params, max_batch=2).embed(tok, mask)
    got = Embedder(model.cfg, model, max_batch=2).embed(torch.from_numpy(tok), torch.from_numpy(mask))
    _assert_embeddings_close(got.numpy(), want)


# ------------------------------------------------- the slice as a whole --
def synth_docs(rng, n, seq_len, vocab, n_topics=16):
    """``examples/serve_embedder.py``'s topic-biased token streams."""
    topics = rng.integers(0, n_topics, n)
    toks = np.empty((n, seq_len), np.int32)
    for i, t in enumerate(topics):
        lo = (t * vocab) // n_topics
        hi = ((t + 1) * vocab) // n_topics
        toks[i] = rng.integers(lo, hi, seq_len)
    return toks, topics


def _serve(pkg, embedder, vocab, requests=64, batch=16, docs=512):
    """The example's flow: embed the corpus, ingest and flush, then per
    request batch embed and insert 8 fresh documents and search 16 queries
    at staleness 200 ms.  IVF-FLAT at nlist 8 probing all 8 lists (the
    example probes 4): the answers are then exact top-k, so the comparison
    holds the embeddings, not a clustering boundary they straddle.
    Returns every embedded row in insertion order, each request's query
    rows, pks and scores."""
    rng = np.random.default_rng(0)
    kw = {"device": "cpu"} if pkg is port_core else {}
    manu = pkg.ManuSystem(pkg.ManuConfig(num_query_nodes=2, seal_rows=256), **kw)
    coll = manu.create_collection("docs", dim=embedder.dim, metric=pkg.Metric.IP)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 8, "nprobe": 8})
    toks, _topics = synth_docs(rng, docs, 32, vocab)
    rows = [embedder.embed(toks)]
    coll.insert({"vector": rows[0]})
    coll.flush()
    out = []
    for _ in range(0, requests, batch):
        fresh, _ = synth_docs(rng, 8, 32, vocab)
        rows.append(embedder.embed(fresh))
        coll.insert({"vector": rows[-1]})
        q_toks, _ = synth_docs(rng, batch, 32, vocab)
        q = embedder.embed(q_toks)
        res = coll.search(q, limit=5, staleness_ms=200.0)
        out.append((q, res.pks, res.scores))
    as_np = lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
    return (np.concatenate([as_np(r) for r in rows]),
            [(as_np(q), as_np(p), as_np(s)) for q, p, s in out], manu.stats())


@pytest.fixture(scope="module")
def served():
    cfg, params, model = _models(**EXAMPLE)
    ref = _serve(ref_core, RefEmbedder(cfg, params, max_batch=16), cfg.vocab_size)
    port = _serve(port_core, Embedder(model.cfg, model, max_batch=16), cfg.vocab_size)
    return ref, port


def test_serve_embedder_flow_embeddings_match(served):
    (ref_rows, ref_out, _), (port_rows, port_out, _) = served
    assert len(ref_rows) == len(port_rows) == 512 + 4 * 8
    _assert_embeddings_close(port_rows, ref_rows)
    for (rq, _, _), (pq, _, _) in zip(ref_out, port_out):
        _assert_embeddings_close(pq, rq)


def test_serve_embedder_flow_top5_matches_reference(served):
    (ref_rows, ref_out, _), (_, port_out, _) = served
    for (rq, rp, rs), (_pq, pp, ps) in zip(ref_out, port_out):
        assert pp.shape == rp.shape == (16, 5) and (pp >= 0).all() and (rp >= 0).all()
        np.testing.assert_allclose(ps, rs, rtol=0, atol=TIE_TOL)
        # the reference's score of every pk the port returned, by the
        # reference's own embeddings (pks are the insertion order)
        got_ref_scores = np.einsum("qd,qkd->qk", rq, ref_rows[pp])
        diff = pp != rp
        assert np.abs(got_ref_scores[diff] - rs[diff]).max(initial=0.0) <= TIE_TOL
        # and every returned pk is a top-5 row of the reference's data
        exact = np.sort(rq @ ref_rows[: int(max(rp.max(), pp.max())) + 1].T, axis=1)[:, ::-1][:, :5]
        np.testing.assert_allclose(rs, exact, rtol=0, atol=1e-5)


def test_serve_embedder_flow_system_state_matches(served):
    (_, _, ref_stats), (_, _, port_stats) = served
    assert port_stats["index_builds"] == ref_stats["index_builds"] > 0
    for node, st in ref_stats["query_nodes"].items():
        assert port_stats["query_nodes"][node]["rows"] == st["rows"], node


@pytest.mark.parametrize("name", [n for n in FAMILIES if n != "paligemma-3b"])
def test_embed_tokens_takes_every_family(name):
    """The MLA, MoE, SSM, hybrid and audio-stub configurations embed as the
    reference's (weights carried across with every vector leaf perturbed;
    reduced jamba's 8 layers at ``DEPTH_SCALE`` times the bounds)."""
    cfg, params, model = carried(name)
    tok, _ = inputs(cfg, 3, 10, seed=6)
    mask = np.ones((3, 10), np.int32)
    mask[1, 4:] = 0
    want = np.asarray(ref_embed_tokens(cfg, params, jnp.asarray(tok), jnp.asarray(mask)))
    with torch.no_grad():
        got = embed_tokens(model.cfg, model, torch.from_numpy(tok).long(), torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    _assert_embeddings_close(got.numpy(), want, DEPTH_SCALE.get(name, 1.0))


def test_embedder_raises_the_references_error_for_the_vlm_stub():
    cfg, params, model = carried("paligemma-3b")
    tok, _ = inputs(cfg, 2, 6)
    with pytest.raises(ValueError, match="needs prefix patch embeddings"):
        ref_embed_tokens(cfg, params, jnp.asarray(tok))
    with pytest.raises(ValueError, match="needs prefix patch embeddings"):
        Embedder(model.cfg, model).embed(tok)
