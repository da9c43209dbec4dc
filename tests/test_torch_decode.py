"""The port's caches, ``prefill`` and ``decode_step`` against
``repro.models.model`` on the CPU, for all ten configurations at the
reduced sizes, with the reference's weights carried across
(``_torch_model_refs.carried``).

B=2, an 8-token prompt (after paligemma's 8 patch embeddings), a cache of
P + 8 + 4 positions, three decode steps.  Tolerances (bf16 models):
- logits (prefill and each decode step) within LOGIT_ATOL = 2e-2 of the
  reference's, as ``test_torch_models.py``'s forward;
- bf16 cache rows (GQA k / v, MLA c, SSM conv) and the float32 SSM state
  within rtol 2^-6, atol 2^-4 (the hidden-state bound: each is a
  projection of a layer's input, which carries that layer's rounding);
- reduced jamba (8 layers) at ``DEPTH_SCALE`` times both
  (``_torch_model_refs``);
- the port's own decode against its own forward over the whole sequence
  at the reference's ``test_prefill_decode_parity`` bounds (prefill
  rtol = atol = 3e-2, decode steps below 0.15).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_model_refs import ALL, DEPTH_SCALE, carried, f32, inputs, j, t  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402

LOGIT_ATOL = 2e-2
CACHE_TOL = dict(rtol=2.0**-6, atol=2.0**-4)
B, S, STEPS = 2, 8, 3


def _scale(name):
    return DEPTH_SCALE.get(name, 1.0)


@pytest.fixture(scope="module", params=ALL)
def run(request):
    """Both packages through init_cache, prefill and three decode steps on
    the same weights and tokens; the reference's caches after prefill."""
    name = request.param
    cfg, params, model = carried(name)
    tok, prefix = inputs(cfg, B, S + STEPS)
    p = 0 if prefix is None else prefix.shape[1]
    out = {"name": name, "cfg": cfg, "model": model, "tok": tok, "prefix": prefix, "P": p,
           "shape": RM.cache_shape(cfg, B, p + S + 4)}
    cache = RM.init_cache(cfg, B, p + S + 4)
    logits, cache = RM.prefill(cfg, params, j(tok[:, :S]), cache, j(prefix), remat=False)
    out["ref_prefill"], out["ref_cache"] = f32(logits), jax.tree_util.tree_map(np.asarray, cache)
    out["ref_steps"] = []
    for step in range(STEPS):
        logits, cache = RM.decode_step(cfg, params, cache, j(tok[:, S + step:S + step + 1]))
        out["ref_steps"].append(f32(logits))
    with torch.no_grad():
        pc = PM.init_cache(model.cfg, B, p + S + 4, device="cpu")
        out["port_init"] = {"length": pc["length"],
                            "layers": [{k: v.clone() for k, v in lc.items()} for lc in pc["layers"]]}
        logits, pc = PM.prefill(model.cfg, model, t(tok[:, :S]).long(), pc, t(prefix))
        out["port_prefill"] = logits
        out["port_cache"] = {"length": pc["length"],
                             "layers": [{k: v.clone() for k, v in lc.items()} for lc in pc["layers"]]}
        out["port_steps"] = []
        for step in range(STEPS):
            logits, pc = PM.decode_step(model.cfg, model, pc, t(tok[:, S + step:S + step + 1]).long())
            out["port_steps"].append(logits)
        out["port_length"] = pc["length"]
        out["port_forward"] = PM.forward(model.cfg, model, t(tok).long(), t(prefix))
    return out


def _layer_slots(cfg):
    """(layer, slot, period) over depth: layer period * len(pattern) + slot."""
    n = len(RM.effective_pattern(cfg))
    return [(li, li % n, li // n) for li in range(cfg.num_layers)]


def test_init_cache_matches_reference_cache_shape(run):
    cfg, shape, got = run["cfg"], run["shape"], run["port_init"]
    meta = PM.cache_shape(run["model"].cfg, B, run["P"] + S + 4)
    assert got["length"] == 0 and meta["length"] == 0
    assert len(got["layers"]) == len(meta["layers"]) == cfg.num_layers
    for li, slot, _period in _layer_slots(cfg):
        want = shape[f"slot{slot}"]
        assert set(got["layers"][li]) == set(want) == set(meta["layers"][li])
        for key, spec in want.items():
            for tensor in (got["layers"][li][key], meta["layers"][li][key]):
                assert tuple(tensor.shape) == tuple(spec.shape[1:]), (li, key)
                assert str(tensor.dtype).split(".")[-1] == str(spec.dtype), (li, key)
            assert not got["layers"][li][key].any()
            assert meta["layers"][li][key].device.type == "meta"


def test_prefill_logits_and_caches_match_reference(run):
    cfg, scale = run["cfg"], _scale(run["name"])
    got, want = run["port_prefill"], run["ref_prefill"]
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, run["P"] + S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=scale * LOGIT_ATOL)
    assert run["port_cache"]["length"] == int(run["ref_cache"]["length"]) == run["P"] + S
    for li, slot, period in _layer_slots(cfg):
        for key, ref in run["ref_cache"][f"slot{slot}"].items():
            np.testing.assert_allclose(f32(run["port_cache"]["layers"][li][key]), f32(ref[period]),
                                       rtol=scale * CACHE_TOL["rtol"], atol=scale * CACHE_TOL["atol"],
                                       err_msg=f"layer {li} {key}")


def test_decode_steps_match_reference(run):
    scale = _scale(run["name"])
    assert run["port_length"] == run["P"] + S + STEPS
    for step, (got, want) in enumerate(zip(run["port_steps"], run["ref_steps"])):
        assert got.dtype == torch.float32 and got.shape == want.shape == (B, 1, run["cfg"].vocab_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=scale * LOGIT_ATOL,
                                   err_msg=f"step {step}")


def test_decode_continues_own_forward(run):
    """``test_prefill_decode_parity``'s bounds, port against port."""
    p, full = run["P"], run["port_forward"]
    np.testing.assert_allclose(run["port_prefill"][:, p:].numpy(), full[:, p:p + S].numpy(),
                               rtol=3e-2, atol=3e-2)
    for step, got in enumerate(run["port_steps"]):
        err = (got[:, 0] - full[:, p + S + step]).abs().max().item()
        assert err < 0.15, f"{run['name']} decode step {step}: err {err}"


@pytest.mark.parametrize("name", ["yi-9b", "minicpm3-4b", "mamba2-370m", "paligemma-3b"])
def test_last_only_keeps_the_last_position(name):
    _cfg, _params, model = carried(name)
    tok, prefix = inputs(model.cfg, B, S)
    p = 0 if prefix is None else prefix.shape[1]
    with torch.no_grad():
        full, c1 = PM.prefill(model.cfg, model, t(tok).long(), PM.init_cache(model.cfg, B, p + S + 1, device="cpu"),
                              t(prefix))
        last, c2 = PM.prefill(model.cfg, model, t(tok).long(), PM.init_cache(model.cfg, B, p + S + 1, device="cpu"),
                              t(prefix), last_only=True)
    assert last.shape == (B, 1, model.cfg.vocab_size)
    torch.testing.assert_close(last, full[:, -1:], rtol=0, atol=0)
    for a, b in zip(c1["layers"], c2["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_vlm_prefix_is_projected_in_front():
    """paligemma: the patch embeddings, through ``vision_proj``, take the
    first P positions; without them ``embed_inputs`` raises the reference's
    ValueError; ``audio_stub`` (musicgen) embeds tokens only."""
    cfg, params, model = carried("paligemma-3b")
    tok, prefix = inputs(cfg, B, S)
    with torch.no_grad():
        x = PM.embed_inputs(model.cfg, model, t(tok).long(), t(prefix))
        want = RM.embed_inputs(cfg, params, j(tok), j(prefix))
        np.testing.assert_allclose(f32(x), f32(want), rtol=2.0**-6, atol=2.0**-6)
        assert x.shape == (B, cfg.num_prefix_embeddings + S, cfg.d_model) and x.dtype == torch.bfloat16
        torch.testing.assert_close(x[:, cfg.num_prefix_embeddings:], model.embed[t(tok).long()])
        other = PM.forward(model.cfg, model, t(tok).long(), t(prefix) + 1.0)
        assert not torch.allclose(other, PM.forward(model.cfg, model, t(tok).long(), t(prefix)))
    for fn in (lambda: PM.embed_inputs(model.cfg, model, t(tok).long()),
               lambda: PM.prefill(model.cfg, model, t(tok).long(),
                                  PM.init_cache(model.cfg, B, 64, device="cpu"))):
        with pytest.raises(ValueError, match="needs prefix patch embeddings"):
            fn()
    cfg_a, _params_a, model_a = carried("musicgen-medium")
    tok_a, _ = inputs(cfg_a, B, S)
    with torch.no_grad():
        torch.testing.assert_close(PM.embed_inputs(model_a.cfg, model_a, t(tok_a).long()),
                                   model_a.embed[t(tok_a).long()])


@pytest.mark.parametrize("name", ["yi-9b", "minicpm3-4b"])
def test_decode_attention_is_injectable(name):
    """``gqa_attn_impl`` / ``mla_attn_impl`` are called once per attention
    layer and step with the reference's arguments; wrapping the dense
    defaults changes nothing."""
    _cfg, _params, model = carried(name)
    cfg = model.cfg
    tok, _ = inputs(cfg, B, S + 2)
    calls = []

    def gqa(q, k_new, v_new, k_cache, v_cache, pos):
        calls.append(("gqa", tuple(q.shape), tuple(k_new.shape), tuple(k_cache.shape), pos))
        return PM.dense_gqa_decode_attn(q, k_new, v_new, k_cache, v_cache, pos)

    def mla(q_c, q_rope, payload, c_cache, pos, r, scale_dim):
        calls.append(("mla", tuple(q_c.shape), tuple(payload.shape), tuple(c_cache.shape), pos, r, scale_dim))
        return PM.dense_mla_decode_attn(q_c, q_rope, payload, c_cache, pos, r, scale_dim)

    with torch.no_grad():
        outs = []
        for kwargs in ({}, {"gqa_attn_impl": gqa, "mla_attn_impl": mla}):
            cache = PM.init_cache(cfg, B, S + 2, device="cpu")
            _, cache = PM.prefill(cfg, model, t(tok[:, :S]).long(), cache)
            steps = [PM.decode_step(cfg, model, cache, t(tok[:, S + i:S + i + 1]).long(), **kwargs)[0]
                     for i in range(2)]
            outs.append(torch.cat(steps, 1))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    assert len(calls) == 2 * cfg.num_layers
    if cfg.attn_type == "mla":
        r = cfg.kv_lora_rank
        assert calls[0] == ("mla", (B, 1, cfg.num_heads, r), (B, 1, r + cfg.qk_rope_head_dim),
                            (B, S + 2, r + cfg.qk_rope_head_dim), S, r,
                            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    else:
        assert calls[0] == ("gqa", (B, 1, cfg.num_heads, cfg.head_dim), (B, 1, cfg.num_kv_heads, cfg.head_dim),
                            (B, S + 2, cfg.num_kv_heads, cfg.head_dim), S)
    assert [c[-1] if c[0] == "gqa" else c[4] for c in calls] == [S] * cfg.num_layers + [S + 1] * cfg.num_layers


def test_cache_bounds_raise():
    """Prefill longer than the cache, or a step past its end, raises (the
    reference's dynamic slices clamp the write position instead)."""
    _cfg, _params, model = carried("yi-9b")
    tok, _ = inputs(model.cfg, B, S)
    with torch.no_grad():
        with pytest.raises(ValueError, match="prefill of 8 positions into a cache of 4"):
            PM.prefill(model.cfg, model, t(tok).long(), PM.init_cache(model.cfg, B, 4, device="cpu"))
        cache = PM.init_cache(model.cfg, B, S, device="cpu")
        _, cache = PM.prefill(model.cfg, model, t(tok).long(), cache)
        with pytest.raises(ValueError, match="decode at position 8 past a cache of 8"):
            PM.decode_step(model.cfg, model, cache, t(tok[:, :1]).long())
