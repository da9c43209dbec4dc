"""The port's MLA, MoE, SSM / hybrid and stub-frontend families against
``repro.models`` on the CPU, at the reduced sizes, with the reference's
weights carried across (``_torch_model_refs.carried``: every vector leaf
perturbed so that norms and biases count).

Tolerances:
- hidden states and logits at ``test_torch_models.py``'s bounds (hidden
  rtol 2^-6, atol 2^-4; logits atol 2e-2) for the 2-layer configurations.
  Reduced jamba (one full 8-layer period) is held to ``DEPTH_SCALE``
  times those bounds end to end and to the 2-layer bounds layer by layer,
  each layer fed the reference's input (``_torch_model_refs``).
- bf16 projections (``mla_qkv``, SSM blocks): rtol 2^-6, atol 2^-6 (one
  bf16 ulp at |x| in [1, 2)).  ``moe_block`` adds the shared expert's row
  to the gated experts' rows, each of magnitude up to ~4 (one ulp 2^-6),
  and the sum can cancel: atol 2^-5 (measured 0.020 on deepseek, where the
  output is -0.11).
- float32 (``ssd_chunked``, the SSM state): rtol 1e-5, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_model_refs import DEPTH_SCALE, FAMILIES, carried, f32, inputs, j, t  # noqa: E402
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import moe as PMoE  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402

HIDDEN_TOL = dict(rtol=2.0**-6, atol=2.0**-4)
LOGIT_ATOL = 2e-2
BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-6)
MOE_TOL = dict(rtol=2.0**-6, atol=2.0**-5)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    cfg, params, model = carried(name)
    tok, prefix = inputs(cfg, 2, 12)
    return name, cfg, params, model, tok, prefix


def test_every_configuration_is_supported():
    for name, cfg in ARCHS.items():
        PM.check_supported(cfg)
        PM.check_supported(cfg.reduced())
    assert not hasattr(PM, "NOT_PORTED")  # lm_loss too: nothing of the model raises


def test_hidden_states_and_logits_match_reference(family):
    name, cfg, params, model, tok, prefix = family
    scale = DEPTH_SCALE.get(name, 1.0)
    want_h = f32(RM.hidden_states(cfg, params, j(tok), j(prefix), remat=False))
    want_l = f32(RM.forward(cfg, params, j(tok), j(prefix), remat=False))
    with torch.no_grad():
        got_h = PM.hidden_states(model.cfg, model, t(tok).long(), t(prefix))
        got_l = model(t(tok).long(), t(prefix))
    total = tok.shape[1] + (0 if prefix is None else prefix.shape[1])
    assert got_h.dtype == torch.bfloat16 and got_l.dtype == torch.float32
    assert got_l.shape == (2, total, cfg.vocab_size) and torch.isfinite(got_l).all()
    np.testing.assert_allclose(f32(got_h), want_h, rtol=scale * HIDDEN_TOL["rtol"],
                               atol=scale * HIDDEN_TOL["atol"])
    np.testing.assert_allclose(f32(got_l), want_l, rtol=0, atol=scale * LOGIT_ATOL)


def test_each_layer_matches_reference(family):
    """Each layer fed the reference's input gives the reference's output."""
    name, cfg, params, model, tok, prefix = family
    x = RM.embed_inputs(cfg, params, j(tok), j(prefix))
    b, s = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    pattern = RM.effective_pattern(cfg)
    assert [(lay.kind, lay.is_moe) for lay in model.layers] == pattern * RM.num_periods(cfg)
    for li, layer in enumerate(model.layers):
        kind, is_moe = pattern[li % len(pattern)]
        lp = jax.tree_util.tree_map(lambda a: a[li // len(pattern)],
                                    params["layers"][f"slot{li % len(pattern)}"])
        want = RM._layer_forward(cfg, kind, is_moe, lp, x, pos)
        with torch.no_grad():
            got = layer(model.cfg, t(f32(x), torch.bfloat16), t(np.asarray(pos)).long())
        np.testing.assert_allclose(f32(got), f32(want), **HIDDEN_TOL, err_msg=f"{name} layer {li}")
        x = want


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_matches_reference_shapes_dtypes_and_scales(name):
    cfg = ARCHS[name].reduced()
    ref = RM.init_params(REF_ARCHS[name].reduced(), jax.random.key(0))
    model = PM.init_params(cfg, seed=0, device="cpu")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":  # layer p * len(pattern) + slot is row p of slot<slot>
            slot = int(keys[1][4:])
            want[".".join(["layers", str(slot)] + keys[2:])] = leaf[0]
        else:
            want[".".join(keys)] = leaf
    got = dict(model.named_parameters())
    assert len(model.layers) == cfg.num_layers
    assert {k for k in got if not k.startswith("layers.") or int(k.split(".")[1]) < len(RM.effective_pattern(cfg))} == set(want)
    for key, leaf in want.items():
        p, w = got[key], np.asarray(leaf, np.float32)
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), key
        assert tuple(p.shape) == tuple(leaf.shape), key
        ws, gs = float(w.std()), float(p.float().std())
        if ws == 0.0 or key.endswith("a_log"):  # constants and linspace: equal
            np.testing.assert_allclose(f32(p), w, rtol=1e-6, err_msg=key)
        else:  # the same distribution: standard deviations within 15%
            assert abs(gs - ws) <= 0.15 * ws, (key, gs, ws)


def test_float32_leaves_stay_float32():
    """The router, a_log, d_skip and dt_bias are float32 in the reference:
    carried across unrounded (their perturbed values are not bf16)."""
    cfg, params, model = carried("jamba-v0.1-52b")
    checked = 0
    for li, layer in enumerate(model.layers):
        slot = params["layers"][f"slot{li}"]
        for sub, names in (("ssm", ("a_log", "d_skip", "dt_bias")), ("moe", ("router",))):
            if sub not in slot:
                continue
            for leaf in names:
                p = getattr(getattr(layer, sub), leaf)
                want = np.asarray(slot[sub][leaf][0])
                assert want.dtype == np.float32 and p.dtype == torch.float32, leaf
                np.testing.assert_array_equal(p.numpy(), want)
                assert not np.array_equal(want, np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32))
                checked += 1
    assert checked == 7 * 3 + 4
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters()
               if n.split(".")[-1] not in ("router", "a_log", "d_skip", "dt_bias"))


# ----------------------------------------------------------------- MLA --
def test_mla_qkv_matches_reference():
    cfg, params, model = carried("minicpm3-4b")
    lp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["slot0"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 12), (2, 9)).copy()  # not starting at 0
    want = RL.mla_qkv(cfg, lp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    with torch.no_grad():
        got = PL.mla_qkv(model.cfg, model.layers[0].attn, t(x, torch.bfloat16), t(pos).long())
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    shapes = [(2, 9, 4, 16), (2, 9, 4, 16), (2, 9, 4, 16), (2, 9, r + rope)]
    for name, g, w, shp in zip(("q", "k", "v", "payload"), got, want, shapes):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == shp, name
        np.testing.assert_allclose(f32(g), f32(w), **BF16_TOL, err_msg=name)
    # the payload's rope part is the key after RoPE, shared by every head
    np.testing.assert_array_equal(f32(got[3][..., r:]), f32(got[1][:, :, 0, cfg.qk_nope_head_dim:]))


# ----------------------------------------------------------------- MoE --
def _reference_kept(cfg, p, x):
    """The slots ``_moe_block_dense`` keeps (its lines 76-88)."""
    b, s, _ = x.shape
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _gate, idx = jax.lax.top_k(probs, cfg.moe_top_k)
    e_flat = idx.reshape(b, s * cfg.moe_top_k)
    pos_all = jnp.cumsum(jax.nn.one_hot(e_flat, cfg.moe_num_experts, dtype=jnp.int32), axis=1) - 1
    pos = jnp.take_along_axis(pos_all, e_flat[..., None], axis=-1)[..., 0]
    return np.asarray(e_flat), np.asarray(pos < RMoE.moe_capacity(cfg, s))


def _moe_pair(name: str, capacity_factor=None, tie: bool = False):
    ref_cfg = REF_ARCHS[name].reduced()
    cfg = ARCHS[name].reduced()
    if capacity_factor is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe_capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    p = RMoE.init_moe_params(ref_cfg, jax.random.key(0))
    if tie:  # experts 1 and 2 route identically: every token ties them
        p["router"] = p["router"].at[:, 2].set(p["router"][:, 1])
    mod = PMoE.MoE(cfg, device="meta")
    state = {}
    for key, leaf in p.items():
        if isinstance(leaf, dict):
            state.update({f"{key}.{k}": v for k, v in leaf.items()})
        else:
            state[key] = leaf
    dtypes = {k: v.dtype for k, v in mod.state_dict().items()}
    mod.load_state_dict({k: t(f32(v)).to(dtypes[k]) for k, v in state.items()}, assign=True)
    return ref_cfg, cfg, p, mod


@pytest.mark.parametrize("name,cf,tie", [
    ("qwen3-moe-30b-a3b", None, False),        # reduced: capacity factor 4, no drop
    ("deepseek-moe-16b", None, False),         # shared experts, gates not renormalized
    ("qwen3-moe-30b-a3b", 1.25, False),        # the published factor
    ("qwen3-moe-30b-a3b", 0.01, False),        # test_moe_capacity_drop_semantics' shape
    ("jamba-v0.1-52b", 0.01, True),            # tied router columns
], ids=["qwen3-moe", "deepseek", "cf1.25", "cf0.01", "tie-cf0.01"])
def test_moe_block_matches_reference_and_drops_its_slots(name, cf, tie):
    ref_cfg, cfg, p, mod = _moe_pair(name, cf, tie)
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = RMoE._moe_block_dense(ref_cfg, p, xb)
    with torch.no_grad():
        got = PMoE.moe_block(cfg, mod, t(x, torch.bfloat16))
        _gate, e_flat, _pos, kept = PMoE.route(cfg, mod, t(x, torch.bfloat16))
        drops = (~kept).sum(1)
    want_e, want_kept = _reference_kept(ref_cfg, p, xb)
    np.testing.assert_array_equal(e_flat.numpy(), want_e)  # ties to the lower expert
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    np.testing.assert_array_equal(drops.numpy(), (~want_kept).sum(1))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(f32(got), f32(want), **MOE_TOL)
    if cf == 0.01:  # capacity 8 of 32 slots per expert and row: most drop
        assert drops.min().item() > 0 and PMoE.moe_capacity(cfg, 16) == 8
    else:
        assert drops.sum().item() == 0 or cf == 1.25
    if tie:
        assert (e_flat.reshape(2, 16, 2) == torch.tensor([1, 2])).all(-1).any()


def test_moe_capacity_matches_reference():
    for name in ("qwen3-moe-30b-a3b", "deepseek-moe-16b", "jamba-v0.1-52b"):
        for s in (1, 8, 24, 1024, 4096):
            for cfg, ref in ((ARCHS[name], REF_ARCHS[name]), (ARCHS[name].reduced(), REF_ARCHS[name].reduced())):
                assert PMoE.moe_capacity(cfg, s) == RMoE.moe_capacity(ref, s)


# ----------------------------------------------------------------- SSM --
def _ssm_pair(name: str = "mamba2-370m", seed: int = 0):
    cfg, pcfg = REF_ARCHS[name].reduced(), ARCHS[name].reduced()
    p = RS.init_ssm_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 5)
    for key in ("conv_b", "a_log", "d_skip", "dt_bias", "norm"):
        p[key] = jnp.asarray(f32(p[key]) + 0.1 * rng.standard_normal(p[key].shape), p[key].dtype)
    mod = PS.SSM(pcfg, device="meta")
    mod.load_state_dict({k: t(f32(v)).to(getattr(mod, k).dtype) for k, v in p.items()}, assign=True)
    return cfg, pcfg, p, mod


@pytest.mark.parametrize("s,chunk,with_h", [(37, 16, False), (37, 16, True), (8, 16, True), (48, 16, False)],
                         ids=["ragged", "ragged-h_init", "one-short-chunk", "whole-chunks"])
def test_ssd_chunked_matches_reference(s, chunk, with_h):
    rng = np.random.default_rng(s + chunk)
    b, h, hd, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, 2.8, h)).astype(np.float32)
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, hd, n)).astype(np.float32) if with_h else None
    want_y, want_h = RS.ssd_chunked(j(x), j(dt), j(a), j(bi), j(ci), chunk, j(h0))
    got_y, got_h = PS.ssd_chunked(t(x), t(dt), t(a), t(bi), t(ci), chunk, t(h0))
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **F32_TOL)


@pytest.mark.parametrize("s", [2, 20], ids=["S<conv-1", "S>chunk"])
def test_ssm_block_with_state_matches_reference(s):
    cfg, pcfg, p, mod = _ssm_pair()
    x = (0.5 * np.random.default_rng(s).standard_normal((2, s, cfg.d_model))).astype(np.float32)
    want_y, want_st = RS.ssm_block_with_state(cfg, p, jnp.asarray(x, jnp.bfloat16), {})
    with torch.no_grad():
        got_y, got_st = PS.ssm_block_with_state(pcfg, mod, t(x, torch.bfloat16), {})
        full = PS.ssm_block(pcfg, mod, t(x, torch.bfloat16))
    assert got_st["conv"].shape == (2, cfg.ssm_conv - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state)
    assert got_st["conv"].dtype == torch.bfloat16 and got_st["h"].dtype == torch.float32
    np.testing.assert_allclose(f32(got_y), f32(want_y), **BF16_TOL)
    np.testing.assert_array_equal(f32(got_y), f32(full))
    np.testing.assert_allclose(got_st["h"].numpy(), f32(want_st["h"]), rtol=2.0**-6, atol=2.0**-6)
    # the pre-conv inputs, zero-padded on the left when S < conv - 1
    np.testing.assert_allclose(f32(got_st["conv"]), f32(want_st["conv"]), **BF16_TOL)
    if s < cfg.ssm_conv - 1:
        assert not got_st["conv"][:, : cfg.ssm_conv - 1 - s].any()


def test_ssm_decode_continues_prefill():
    """Prefill state -> decode steps continue like one longer prefill
    (``test_ssm_state_continuity``), and equal the reference's steps."""
    cfg, pcfg, p, mod = _ssm_pair()
    x = (0.1 * np.random.default_rng(7).standard_normal((2, 19, cfg.d_model))).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = t(x, torch.bfloat16)
    _, ref_state = RS.ssm_block_with_state(cfg, p, xb[:, :16], {})
    with torch.no_grad():
        full = PS.ssm_block(pcfg, mod, xt)
        _, state = PS.ssm_block_with_state(pcfg, mod, xt[:, :16], {})
        for step in range(16, 19):
            want, ref_state = RS.ssm_decode_step(cfg, p, xb[:, step:step + 1], ref_state)
            got, state = PS.ssm_decode_step(pcfg, mod, xt[:, step:step + 1], state)
            assert got.shape == (2, 1, cfg.d_model) and got.dtype == torch.bfloat16
            assert np.abs(f32(got) - f32(full[:, step:step + 1])).max() < 0.05
            np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
            np.testing.assert_allclose(state["h"].numpy(), f32(ref_state["h"]), rtol=2.0**-6, atol=2.0**-6)
            np.testing.assert_array_equal(f32(state["conv"]), f32(ref_state["conv"]))
