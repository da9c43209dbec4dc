"""The port's dense decoder against ``repro.models`` on the CPU (the other
families: ``test_torch_model_families.py``; caches and decode:
``test_torch_decode.py``).

The same seeded numpy inputs go through both packages; weights are the
reference's ``init_params`` tree carried across by
``repro_torch.models.convert.params_from_jax`` (bf16 leaves widened to
float32 on the way, exact both ways).

Tolerances:
- ``flash_attention``, ``rms_norm`` and ``apply_rope`` at float32:
  rtol=atol=1e-5 (two float32 summation orders; measured below 2e-6).
- bf16 models (yi-9b, qwen1.5-4b with qkv bias, qwen3-32b with qk-norm,
  reduced): hidden states within rtol=2^-6, atol=2^-4 (the packages round
  their bf16 products and residual sums in different places; the residual
  stream reaches |h| ~ 4, where one bf16 ulp is 2^-5, and near-zero
  elements carry that absolute error: measured 0.047), float32 logits
  within atol=2e-2 (measured 6.2e-3 on |logits| <= 0.56).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import cells as ref_cells  # noqa: E402
from repro.configs import skipped_cells as ref_skipped_cells  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cells, get_arch, skipped_cells  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import moe as PMoE  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN_TOL = dict(rtol=2.0**-6, atol=2.0**-4)
LOGIT_ATOL = 2e-2
DENSE = ("yi-9b", "qwen1.5-4b", "qwen3-32b")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ attention --
FLASH_CASES = [
    # (B, Sq, Sk, H, KVH, hd, causal_offset, kv_block, q_block)
    (2, 16, 16, 4, 4, 8, 0, 1024, 2048),      # H/KVH 1 (MHA), one block
    (2, 16, 16, 4, 2, 8, 0, 4, 2048),         # H/KVH 2, kv_block < S
    (1, 13, 13, 8, 1, 16, 0, 4, 2048),        # H/KVH 8 (MQA), S not a block multiple
    (2, 11, 11, 8, 4, 8, 0, 3, 4),            # q and kv both blocked, ragged
    (2, 5, 12, 4, 2, 8, 7, 4, 2048),          # causal offset Sk - Sq > 0
    (1, 9, 9, 8, 2, 8, None, 4, 2048),        # no causal mask
    (1, 6, 10, 4, 1, 8, None, 3, 4),          # no mask, ragged blocks
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_attention_matches_reference(case):
    b, sq, sk, h, kvh, hd, off, kvb, qb = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, hd)).astype(np.float32)
    want = np.asarray(RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal_offset=off, kv_block=kvb, q_block=qb))
    got = PL.flash_attention(_t(q), _t(k), _t(v), causal_offset=off, kv_block=kvb, q_block=qb)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_attention_never_repeats_kv_and_equals_repeated_softmax():
    """The grouped contraction equals plain softmax attention over
    ``repeat_kv``'d heads (float64 reference), causal."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 7, 8, 4)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 7, 2, 4)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 7, 2, 4)).astype(np.float32))
    got = PL.flash_attention(q, k, v, causal_offset=0, kv_block=3)
    kr, vr = PL.repeat_kv(k, 8).double(), PL.repeat_kv(v, 8).double()
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) / 2.0
    s = s.masked_fill(torch.ones(7, 7, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vr)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), **F32_TOL)
    np.testing.assert_array_equal(PL.repeat_kv(k, 8).numpy(),
                                  np.asarray(RL.repeat_kv(jnp.asarray(k.numpy()), 8)))


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(PL.rms_norm(_t(x), _t(scale), 1e-6).numpy(),
                               np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
                               **F32_TOL)
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    for theta in (1e4, 5e6):
        np.testing.assert_allclose(
            PL.apply_rope(_t(x), _t(pos), theta).numpy(),
            np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **F32_TOL)
    np.testing.assert_allclose(PL.rope_freqs(16, 1e4).numpy(), np.asarray(RL.rope_freqs(16, 1e4)),
                               rtol=1e-6)
    # bf16 in, bf16 out, the arithmetic in float32
    xb = _t(x).to(torch.bfloat16)
    assert PL.rms_norm(xb, _t(scale), 1e-6).dtype == torch.bfloat16
    assert PL.apply_rope(xb, _t(pos), 1e4).dtype == torch.bfloat16


# ---------------------------------------------------------------- models --
def _carried(name: str, seed: int = 0):
    """Reference params for the reduced config, with the qkv biases and qk
    norms (zeros and ones at init) drawn at random so they count, and the
    port's model from the same tree."""
    cfg = REF_ARCHS[name].reduced()
    params = RM.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 10)
    attn = params["layers"]["slot0"]["attn"]
    for key in ("b_q", "b_k", "b_v", "q_head_norm", "k_head_norm"):
        if key in attn:
            base = 1.0 if key.endswith("norm") else 0.0
            attn[key] = jnp.asarray(base + 0.1 * rng.standard_normal(attn[key].shape), jnp.bfloat16)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return cfg, params, params_from_jax(ARCHS[name].reduced(), tree, device="cpu")


@pytest.mark.parametrize("name", DENSE)
def test_hidden_states_and_logits_match_reference(name):
    cfg, params, model = _carried(name)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want_h = np.asarray(RM.hidden_states(cfg, params, jnp.asarray(tok), remat=False), np.float32)
    want_l = np.asarray(RM.forward(cfg, params, jnp.asarray(tok), remat=False), np.float32)
    with torch.no_grad():
        got_h = PM.hidden_states(model.cfg, model, _t(tok).long())
        got_l = model(_t(tok).long())
    assert got_h.dtype == torch.bfloat16 and got_l.dtype == torch.float32
    assert got_l.shape == (2, 12, cfg.vocab_size) and torch.isfinite(got_l).all()
    np.testing.assert_allclose(got_h.float().numpy(), want_h, **HIDDEN_TOL)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=LOGIT_ATOL)


def test_carried_weights_are_exact_and_per_layer():
    cfg, params, model = _carried("yi-9b")
    assert len(model.layers) == cfg.num_layers
    stack = params["layers"]["slot0"]
    for layer in range(cfg.num_layers):
        np.testing.assert_array_equal(
            model.layers[layer].attn.w_q.float().numpy(),
            np.asarray(stack["attn"]["w_q"][layer], np.float32))
        np.testing.assert_array_equal(
            model.layers[layer].mlp.w_down.float().numpy(),
            np.asarray(stack["mlp"]["w_down"][layer], np.float32))
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("name", DENSE)
def test_init_params_matches_reference_shapes_dtypes_and_scales(name):
    cfg = ARCHS[name].reduced(d_model=128, d_ff=256)
    ref = RM.init_params(REF_ARCHS[name].reduced(d_model=128, d_ff=256), jax.random.key(0))
    model = PM.init_params(cfg, seed=0, device="cpu")
    assert PM.effective_pattern(cfg) == RM.effective_pattern(cfg)
    assert PM.num_periods(cfg) == RM.num_periods(cfg) == cfg.num_layers
    got = dict(model.named_parameters())
    want = {"embed": ref["embed"], "ln_final": ref["ln_final"], "lm_head": ref["lm_head"]}
    for name_, leaf in jax.tree_util.tree_flatten_with_path(ref["layers"]["slot0"])[0]:
        path = ".".join(k.key for k in name_)
        want[f"layers.0.{path}"] = leaf[0]
    assert set(want) <= set(got)
    for key, leaf in want.items():
        p = got[key]
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == tuple(leaf.shape), key
        # the same distribution: standard deviations within 15%
        ws, gs = float(np.asarray(leaf, np.float32).std()), float(p.float().std())
        assert (ws == 0.0 and gs == 0.0) or abs(gs - ws) <= 0.15 * ws, (key, gs, ws)
    # seeded: the same seed gives the same weights
    again = PM.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# --------------------------------------------------------------- configs --
def _reference_fields(cfg):
    """The port's config as the reference's fields; the port's own fields
    (the leading dense layers, YaRN, dropless routing) hold their defaults,
    which are the reference's behaviour."""
    import dataclasses

    from repro.models.config import ModelConfig as RefModelConfig

    ref_names = {f.name for f in dataclasses.fields(RefModelConfig)}
    own = [f for f in dataclasses.fields(cfg) if f.name not in ref_names]
    assert own and all(getattr(cfg, f.name) == f.default for f in own)
    return {k: v for k, v in cfg.__dict__.items() if k in ref_names}


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_configs_match_reference(name):
    got, want = get_arch(name), REF_ARCHS[name]
    assert _reference_fields(got) == want.__dict__
    assert got.num_params() == want.num_params()
    assert got.active_params() == want.active_params()
    assert _reference_fields(got.reduced()) == want.reduced().__dict__
    assert got.reduced().num_params() == want.reduced().num_params()
    assert got.layer_kinds() == want.layer_kinds()
    assert got.sub_quadratic() == want.sub_quadratic()


def test_registry_cells_and_shapes_match_reference():
    from repro.models.config import SHAPES as REF_SHAPES

    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert cells() == ref_cells()
    assert skipped_cells() == ref_skipped_cells()
    assert {k: v.__dict__ for k, v in SHAPES.items()} == {k: v.__dict__ for k, v in REF_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_params_shape_and_opt_state_shape_on_meta():
    """The meta-device analogues of the reference's ``params_shape`` /
    ``opt_state_shape``: qwen3-32b at its published widths (32.76 B
    parameters) with no memory; ``init_params`` refuses the meta device."""
    from repro_torch.train.optimizer import opt_state_shape

    cfg = ARCHS["qwen3-32b"]
    shape = PM.params_shape(cfg)
    params = dict(shape.named_parameters())
    assert all(p.device.type == "meta" for p in params.values())
    count = sum(p.numel() for p in params.values())
    assert round(count / 1e9, 2) == 32.76
    # the analytic count leaves out the qk-norm scales and the final norm
    assert count - cfg.num_params() == cfg.num_layers * 2 * cfg.head_dim + cfg.d_model
    opt = opt_state_shape(params)
    assert opt["step"] == 0
    for k, p in params.items():
        assert opt["m"][k].shape == p.shape and opt["m"][k].dtype == torch.float32
        assert opt["v"][k].device.type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        PM.init_params(cfg, device="meta")


class _CacheTensors:
    """A cache's tensors behind ``parameters()``, as the modules' weights."""

    def __init__(self, cache):
        self.tensors = [v for layer in cache["layers"] for v in layer.values()]

    def parameters(self):
        return iter(self.tensors)


@pytest.mark.parametrize("build", ["Transformer", "DecoderLayer", "Attention", "MLP", "init_params",
                                   "MLA", "MoE", "SSM", "init_cache"])
def test_model_constructors_default_to_the_card(build, monkeypatch):
    """Every model constructor, like every entry point of the port, places
    its weights on the card unless the caller asks for the CPU: with no
    GPU visible the default raises instead of building on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("yi-9b").reduced(d_model=64, num_layers=1, vocab_size=64)
    make = {
        "Transformer": lambda **kw: PM.Transformer(cfg, **kw),
        "DecoderLayer": lambda **kw: PM.DecoderLayer(cfg, **kw),
        "Attention": lambda **kw: PL.Attention(cfg, **kw),
        "MLP": lambda **kw: PL.MLP(cfg.d_model, cfg.d_ff, **kw),
        "init_params": lambda **kw: PM.init_params(cfg, **kw),
        "MLA": lambda **kw: PL.Attention(get_arch("minicpm3-4b").reduced(), **kw),
        "MoE": lambda **kw: PMoE.MoE(get_arch("qwen3-moe-30b-a3b").reduced(), **kw),
        "SSM": lambda **kw: PS.SSM(get_arch("mamba2-370m").reduced(), **kw),
        "init_cache": lambda **kw: _CacheTensors(PM.init_cache(get_arch("jamba-v0.1-52b").reduced(), 1, 4, **kw)),
    }[build]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    on_cpu = make(device="cpu")
    assert {p.device.type for p in on_cpu.parameters()} == {"cpu"}
    if build != "init_params":  # shape only, as params_from_jax fills and cache_shape gives
        assert {p.device.type for p in make(device="meta").parameters()} == {"meta"}
