"""DeepSeek-V2-Lite's mechanisms in the port against the plain float32
reference ``bench/reference/mla_moe_decoder.py`` (no JAX: the reference
package has none of them), on the CPU at small widths with the weights the
benchmark draws from a seed: the direct-query MLA with YaRN, the dropless
MoE layer, the leading dense layer, whole embeddings, the cache, the spans
and counters; the published widths on the meta device.  The ``cuda`` cases
hold the grouped expert products to a per-expert loop on the card and run
a dropless layer with every readback refused.

Tolerances (bf16 program against a float32 reference on the same bf16
weights): a sublayer's output within 3% of its largest magnitude (each
projection rounds its activations to bf16, 2^-8 relative, and a few such
roundings stack); whole embeddings within 0.02 in L2 (a unit vector after
three layers of such roundings, mean-pooled over 16 positions).  Each
check also holds the reference's fp8 control (e4m3 inputs to every
product) at least three times farther away, so computing in the next
lower precision fails it.
"""

import dataclasses
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from bench.lib import inputs  # noqa: E402
from bench.reference import mla_moe_decoder as ref  # noqa: E402
from repro_torch.core.telemetry import MetricsRegistry, TraceContext  # noqa: E402
from repro_torch.distributed import act_sharding  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import probe as P  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.embedder import Embedder  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "bench/configs/dsv2lite-embed-rag.json").read_text())
SEED = 2**31 + 123
YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096, "type": "yarn"}
# DeepSeek-V2-Lite's published keys at small widths (3 layers: the dense
# layer 0 and two MoE layers; 8 experts, top 3, 2 shared).
TINY = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, q_lora_rank=None,
            intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=3,
            n_shared_experts=2, first_k_dense_replace=1, norm_topk_prob=False, routed_scaling_factor=1,
            rope_theta=10000, rope_scaling=YARN, rms_norm_eps=1e-6, vocab_size=512)
SUBLAYER_TOL = 0.03
EMBED_TOL = 0.02


def port_config(model: dict, **over) -> ModelConfig:
    """The port's ``ModelConfig`` of DeepSeek-V2's published keys (the
    benchmark's ``port_model``, written out there)."""
    y = model["rope_scaling"]
    kw = dict(family="moe", num_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
              num_heads=model["num_attention_heads"], num_kv_heads=model["num_key_value_heads"],
              head_dim=model["v_head_dim"], d_ff=model["intermediate_size"], vocab_size=model["vocab_size"],
              attn_type="mla", rope_theta=float(model["rope_theta"]), q_lora_rank=model["q_lora_rank"] or 0,
              kv_lora_rank=model["kv_lora_rank"], qk_rope_head_dim=model["qk_rope_head_dim"],
              qk_nope_head_dim=model["qk_nope_head_dim"], v_head_dim=model["v_head_dim"],
              moe_num_experts=model["n_routed_experts"], moe_top_k=model["num_experts_per_tok"],
              moe_d_ff=model["moe_intermediate_size"], moe_num_shared=model["n_shared_experts"],
              moe_norm_topk=model["norm_topk_prob"], moe_dropless=True,
              first_k_dense_replace=model["first_k_dense_replace"], rope_yarn_factor=float(y["factor"]),
              rope_yarn_original_max_positions=y["original_max_position_embeddings"],
              rope_yarn_beta_fast=float(y["beta_fast"]), rope_yarn_beta_slow=float(y["beta_slow"]),
              rope_yarn_mscale=y["mscale"], rope_yarn_mscale_all_dim=y["mscale_all_dim"],
              norm_eps=model["rms_norm_eps"])
    kw.update(over)
    return ModelConfig(name="dsv2-test", **kw)


def drawn_model(model: dict, cfg: ModelConfig | None = None) -> M.Transformer:
    """The port's model holding the weights the benchmark draws from SEED
    for the reference's parameter list (cast to the port's dtypes)."""
    cfg = cfg or port_config(model)
    m = M.params_shape(cfg)
    want = m.state_dict(keep_vars=True)
    state = inputs.model_weights(model, ref.layer_parameters, cfg.num_layers, "cpu", SEED)
    assert set(want) - set(state) == {"lm_head"} and set(state) <= set(want)
    m.load_state_dict({n: t.to(want[n].dtype) for n, t in state.items()}, strict=False, assign=True)
    return m


def layer_weights(model: dict, layer: int) -> dict:
    return {n: t.float() for n, t in
            inputs.layer_weights(ref.layer_parameters(model, layer), layer, "cpu", SEED).items()}


def hidden(b: int, s: int, d: int, seed: int = 5) -> torch.Tensor:
    return torch.randn(b, s, d, generator=torch.Generator().manual_seed(seed)).bfloat16()


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


# ------------------------------------------------------------------ YaRN --
def test_yarn_frequencies_and_scale_take_the_closed_form():
    cfg = port_config(PUBLISHED["model"])
    assert cfg == ModelConfig(name="dsv2-test", **PUBLISHED["port_model"])
    assert L.yarn_ramp_bounds(cfg, 64) == (10, 23)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert L.softmax_scale(cfg, 192) * math.sqrt(192) == pytest.approx(m * m, rel=1e-12)
    assert m * m == pytest.approx(1.5896, abs=5e-5)
    i = torch.arange(32, dtype=torch.float64)
    base = 10000.0 ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = base * (1 - ramp) + base / 40 * ramp
    got = L.yarn_inv_freqs(cfg, 64)
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=0)
    assert torch.equal(got[:10], L.rope_freqs(64, 10000.0)[:10])  # below the ramp: plain rope
    inv, cos_scale, scale = ref.yarn(PUBLISHED["model"], "cpu")
    assert torch.allclose(inv, got, rtol=1e-6) and cos_scale == 1.0
    assert scale == pytest.approx(L.softmax_scale(cfg, 192), rel=1e-12)
    # Without YaRN the scale is the default and rope takes the plain path.
    plain = dataclasses.replace(cfg, rope_yarn_factor=0.0)
    assert L.softmax_scale(plain, 192) is None
    x, pos = hidden(1, 6, 64).view(1, 6, 1, 64), torch.arange(6)[None]
    assert torch.equal(L.rope(plain, x, pos), L.apply_rope(x, pos, 10000.0))


# ------------------------------------------------------------ attention --
@pytest.mark.parametrize("yarn", [True, False], ids=["yarn", "plain_rope"])
def test_direct_query_mla_matches_reference(yarn):
    model = dict(TINY) if yarn else dict(TINY, rope_scaling={**YARN, "factor": 1, "mscale_all_dim": 0})
    cfg = port_config(model, rope_yarn_factor=0.0, rope_yarn_mscale_all_dim=0.0) if not yarn else port_config(model)
    m = drawn_model(model, cfg)
    attn = m.layers[1].attn
    assert hasattr(attn, "w_q") and not hasattr(attn, "w_dq") and not hasattr(attn, "q_norm")
    x = hidden(2, 24, 64)
    with torch.no_grad():
        got = L.attention_block(cfg, attn, x, torch.arange(24).expand(2, 24))
    w = layer_weights(model, 1)
    want = ref.attention(x.float(), w, model, "float32")
    control = ref.attention(x.float(), w, model, "fp8")
    assert rel(got, want) < SUBLAYER_TOL
    assert rel(control, want) > 3 * rel(got, want)


# ------------------------------------------------------------------ MoE --
def _rig_router(w: dict, x: torch.Tensor, k: int):
    """Every token to experts 0..k-1: a large first feature and a router
    whose first row favours those experts, in distinct steps (no ties)."""
    x = x.clone()
    x[..., 0] = 8.0
    w["moe.router"][0] = torch.cat([torch.linspace(6.0, 5.0, k), torch.full((w["moe.router"].shape[1] - k,), -6.0)])
    return x


@pytest.mark.parametrize("rigged", [False, True], ids=["router", "all_to_the_same_experts"])
def test_dropless_moe_matches_reference(rigged):
    cfg = port_config(TINY)
    m = drawn_model(TINY, cfg)
    p = m.layers[1].moe
    w = layer_weights(TINY, 1)
    x = hidden(2, 32, 64, seed=9)
    k = TINY["num_experts_per_tok"]
    if rigged:
        x = _rig_router(w, x, k)
        p.router.data.copy_(w["moe.router"])
    with torch.no_grad():
        got = MoE.moe_block(cfg, p, x)
        _gate, idx = MoE.top_k(cfg, p, x)
        capped = MoE.route(dataclasses.replace(cfg, moe_dropless=False, moe_capacity_factor=1.25), p, x)
    _g, ref_idx = ref.routing(x.float().reshape(-1, 64), w, TINY)
    assert torch.equal(idx.reshape(-1, k).sort(-1).values, ref_idx.sort(-1).values)
    want = ref.moe(x.float(), w, TINY, "float32")
    control = ref.moe(x.float(), w, TINY, "fp8")
    assert rel(got, want) < SUBLAYER_TOL
    assert rel(control, want) > 3 * rel(got, want)
    kept = capped[3].float().mean()
    if rigged:
        assert set(idx.unique().tolist()) == set(range(k))
        # the capacity path keeps 16 of each rigged expert's 32 slots a row
        # (ceil(32 * 3 / 8 * 1.25) rounded up to 8) and drops the rest
        assert kept == 0.5
    else:
        assert kept > 0.5


def expert_mlp_plain(rows, offsets, w_gate, w_up, w_down, row_scale):
    """``moe.expert_mlp`` one expert at a time: float32 products of the
    bf16 operands, each step's output rounded to the rows' dtype where the
    grouped path rounds its own."""
    y = rows.new_zeros((rows.shape[0], w_down.shape[2]))
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            r = rows[lo:hi].float()
            g, u = ((r @ w[e].float()).to(rows.dtype) for w in (w_gate, w_up))
            h = torch.nn.functional.silu(g) * u * row_scale[lo:hi, None].to(rows.dtype)
            y[lo:hi] = (h.float() @ w_down[e].float()).to(rows.dtype)
    return y


def counted_grouped_mm(monkeypatch) -> list:
    """Patch ``torch._grouped_mm`` to record each call's operand shapes."""
    calls, grouped_mm = [], torch._grouped_mm

    def counted(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return grouped_mm(a, b, **kw)

    monkeypatch.setattr(torch, "_grouped_mm", counted)
    return calls


@pytest.mark.parametrize("counts", [[3, 0, 7, 1, 9], [20, 0, 0, 0, 0], [0, 0, 0, 0, 20]])
def test_expert_mlp_matches_per_row_products(monkeypatch, counts):
    gen = torch.Generator().manual_seed(4)
    e, d, f = 5, 32, 16
    counts = torch.tensor(counts)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)])
    rows = torch.randn(20, d, generator=gen).bfloat16()
    wg, wu = (torch.randn(e, d, f, generator=gen).bfloat16() for _ in range(2))
    wd = torch.randn(e, f, d, generator=gen).bfloat16()
    scale = torch.rand(20, generator=gen)
    calls = counted_grouped_mm(monkeypatch)
    y = MoE.expert_mlp(rows, offsets, wg, wu, wd, scale)
    # one grouped product a projection, whatever the load
    assert calls == [((20, d), (e, d, f))] * 2 + [((20, f), (e, f, d))]
    owner = torch.repeat_interleave(torch.arange(e), counts)
    r = rows.float()
    h = (torch.nn.functional.silu(torch.einsum("td,tdf->tf", r, wg[owner].float()))
         * torch.einsum("td,tdf->tf", r, wu[owner].float())).bfloat16()
    want = torch.einsum("tf,tfd->td", h.float(), wd[owner].float()) * scale[:, None]
    assert y.dtype == torch.bfloat16
    # gate and up come out of their products in bf16 before the SwiGLU, and
    # the SwiGLU and its scale in bf16 before the down product: within one
    # bf16 ulp of the largest output of the float32 chain, and two of the
    # plain loop's
    assert float((y.float() - want).abs().max()) <= 2**-7 * float(want.abs().max())
    plain = expert_mlp_plain(rows, offsets, wg, wu, wd, scale)
    assert float((y.float() - plain.float()).abs().max()) <= 2 * 2**-7 * float(plain.float().abs().max())


def test_dropless_routing_has_no_expert_parallel_path(monkeypatch):
    cfg = port_config(TINY)
    m = drawn_model(TINY, cfg)
    monkeypatch.setattr(act_sharding, "current_policy", lambda: {"sharded": False})
    monkeypatch.setattr(act_sharding, "expert_parallel", lambda: True)
    with pytest.raises(ValueError, match="dsv2-test"):
        MoE.moe_block(cfg, m.layers[1].moe, hidden(1, 4, 64))


# ---------------------------------------------------------- the layers --
def test_leading_dense_layer_stands_before_the_moe_layers():
    cfg = port_config(PUBLISHED["model"])
    assert M.layer_kinds(cfg) == [("attn", False)] + [("attn", True)] * 26
    assert M.effective_pattern(cfg) == [("attn", True)] and M.num_periods(cfg) == 26
    m = M.params_shape(cfg)
    assert tuple(m.layers[0].mlp.w_gate.shape) == (2048, 10944) and not hasattr(m.layers[0], "moe")
    assert all(tuple(lay.moe.w_gate.shape) == (64, 2048, 1408) for lay in m.layers[1:])
    assert tuple(m.layers[1].moe.shared.w_gate.shape) == (2048, 2816)
    for i, lay in enumerate(m.layers):
        listed = {n: tuple(s) for n, s, _init in ref.layer_parameters(PUBLISHED["model"], i)}
        assert listed == {n: tuple(p.shape) for n, p in lay.state_dict(keep_vars=True).items()}
    # The MoE pattern applies from the leading layers on.
    every2 = dataclasses.replace(cfg, num_layers=5, moe_every=2)
    assert [moe for _k, moe in M.layer_kinds(every2)] == [False, True, False, True, False]
    with pytest.raises(ValueError, match="not divisible"):
        M.layer_kinds(dataclasses.replace(cfg, num_layers=4, moe_every=2))
    with pytest.raises(ValueError, match="no leading dense layers"):
        convert.params_to_jax(cfg, {})


def test_remat_recomputes_the_leading_layer_and_each_period():
    cfg = port_config(TINY)
    m = drawn_model(TINY, cfg)
    for p in m.parameters():
        p.requires_grad_(p.dtype.is_floating_point)
    tok = torch.randint(0, 512, (2, 8), generator=torch.Generator().manual_seed(2))
    outs = {}
    for remat in (True, False):
        m.zero_grad(set_to_none=True)
        h = M.hidden_states(cfg, m, tok, remat=remat)
        h.float().square().mean().backward()
        outs[remat] = (h.detach(), m.layers[0].mlp.w_up.grad.clone(), m.layers[2].attn.w_q.grad.clone())
    assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))


def test_whole_embeddings_match_reference():
    tokens = torch.randint(0, 512, (6, 16), generator=torch.Generator().manual_seed(1))
    got = Embedder(port_config(TINY), drawn_model(TINY), max_batch=4).embed(tokens)
    want = ref.embed(tokens, TINY, SEED, "cpu", block=4)
    control = ref.embed(tokens, TINY, SEED, "cpu", precision="fp8", block=4)
    gap = float(torch.linalg.vector_norm(got - want, dim=1).max())
    assert gap < EMBED_TOL
    assert float(torch.linalg.vector_norm(control - want, dim=1).max()) > 3 * gap


def test_prefill_and_decode_through_the_mla_cache_of_a_direct_query_model():
    """The port's bounds for its own decode against its own forward over
    the whole sequence (``test_torch_decode.py``): prefill within rtol =
    atol = 3e-2, each decode step within 0.15."""
    cfg = port_config(TINY)
    m = drawn_model(TINY, cfg)
    gen = torch.Generator().manual_seed(6)
    m.lm_head = torch.nn.Parameter((torch.randn(64, 512, generator=gen) * 0.02).bfloat16(), requires_grad=False)
    tok = torch.randint(0, 512, (2, 11), generator=gen)
    cache = M.init_cache(cfg, 2, 12, device="cpu")
    assert [tuple(c["c"].shape) for c in cache["layers"]] == [(2, 12, 32 + 8)] * 3
    with torch.no_grad():
        full = M.forward(cfg, m, tok, remat=False)
        logits, cache = M.prefill(cfg, m, tok[:, :8], cache, remat=False)
        assert torch.allclose(logits, full[:, :8], rtol=3e-2, atol=3e-2)
        for step in range(3):
            logits, cache = M.decode_step(cfg, m, cache, tok[:, 8 + step:9 + step])
            assert float((logits[:, 0] - full[:, 8 + step]).abs().max()) < 0.15
    assert cache["length"] == 11


# --------------------------------------------------- spans and counters --
def test_embed_spans_and_counters():
    cfg = port_config(TINY)
    emb = Embedder(cfg, drawn_model(TINY, cfg), max_batch=2)
    tokens = torch.randint(0, 512, (3, 16), generator=torch.Generator().manual_seed(7))
    trace, reg = TraceContext("embed"), MetricsRegistry()
    traced = emb.embed(tokens, trace=trace, metrics=reg)
    assert torch.equal(traced, emb.embed(tokens))
    batches = trace.finish().root.children
    assert [s.name for s in batches] == ["micro_batch", "micro_batch"]
    for b in batches:
        names = [(s.name, s.detail) for s in b.children]
        assert names == [("attention", "layer=0"), ("mlp", "layer=0")] + [
            (n, f"layer={i}") for i in (1, 2)
            for n in ("attention", "moe_route", "moe_experts", "moe_combine", "mlp")]
        assert all(s.device_us is None and s.duration_us > 0 for s in b.children)  # host-timed on the CPU
    slots = [reg.counter_value(P.SLOTS, {"expert": str(e)}) for e in range(8)]
    assert sum(slots) == 3 * 16 * 3 * 2 and min(slots) > 0
    assert reg.counter_value(P.DROPPED) == 0.0
    assert P.DROPPED in reg.export()


def test_capacity_path_counts_its_drops_with_a_registry(monkeypatch):
    cfg = port_config(TINY, moe_dropless=False, moe_capacity_factor=0.5)
    m = drawn_model(TINY, cfg)
    tokens = torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(8))
    route, dropped = MoE.route, []

    def counted(*args):
        routing = route(*args)
        dropped.append(int((~routing[3]).sum()))
        return routing

    monkeypatch.setattr(MoE, "route", counted)
    reg = MetricsRegistry()
    Embedder(cfg, m, max_batch=2).embed(tokens, metrics=reg)
    assert len(dropped) == 2 and sum(dropped) > 0
    assert reg.counter_value(P.DROPPED) == sum(dropped)
    assert sum(reg.counter_value(P.SLOTS, {"expert": str(e)}) for e in range(8)) == 2 * 16 * 3 * 2


def test_untraced_embed_makes_no_span_and_no_series(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the untraced path touched telemetry")

    for cls, names in ((TraceContext, ("span", "timed")), (MetricsRegistry, ("inc", "inc_device")),
                       (P.ForwardProbe, ("__init__",))):
        for name in names:
            monkeypatch.setattr(cls, name, refuse)
    cfg = port_config(TINY)
    rows = Embedder(cfg, drawn_model(TINY, cfg), max_batch=2).embed(torch.zeros((3, 8), dtype=torch.int64))
    assert rows.shape == (3, 64)


# ------------------------------------------------------ published sizes --
def test_deepseek_v2_lite_parameters_and_flops():
    cfg = port_config(PUBLISHED["model"])
    published = PUBLISHED["model"]
    count = sum(p.numel() for p in M.params_shape(cfg).parameters())
    assert count == 15_706_484_224  # with the LM head: the published 15.7 B
    # the analytic count leaves out the kv_norm scales and the final norm
    assert count - cfg.num_params() == 27 * 512 + 2048
    routed_idle = 26 * (64 - 6) * 3 * 2048 * 1408
    assert cfg.active_params() == cfg.num_params() - routed_idle
    layers_active = cfg.active_params() - 2 * 102400 * 2048 - 27 * 2 * 2048  # less embed, head, norms
    products = 27 * 2 * 16 * (128 + 64 + 128) * (512 + 1) / 2
    assert ref.flops_per_token(published, 512) == pytest.approx(2 * layers_active + products, rel=1e-12)
    assert ref.flops_per_token(published, 512) == pytest.approx(4.55e9, rel=0.005)
    assert ref.routed_expert_flops_per_token(published) == 26 * 6 * 3 * 2 * 2048 * 1408


# ---------------------------------------------------------------- card --
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("load", ["router", "one_expert", "half_empty"])
def test_expert_mlp_matches_plain_on_the_card(dev, monkeypatch, load):
    gen = torch.Generator(device=dev).manual_seed(11)
    e, d, f, t = 64, 2048, 1408, 6 * 2048
    if load == "router":
        idx = torch.randint(0, e, (t,), device=dev, generator=gen)
    elif load == "one_expert":
        idx = torch.full((t,), 13, device=dev)
    else:
        idx = torch.randint(0, e // 2, (t,), device=dev, generator=gen) * 2
    experts, _order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(experts, torch.arange(e + 1, device=dev))
    rows = torch.randn(t, d, device=dev, generator=gen).bfloat16()
    wg, wu = ((torch.randn(e, d, f, device=dev, generator=gen) / d ** 0.5).bfloat16() for _ in range(2))
    wd = (torch.randn(e, f, d, device=dev, generator=gen) / f ** 0.5).bfloat16()
    scale = torch.rand(t, device=dev, generator=gen)
    calls = counted_grouped_mm(monkeypatch)
    y = MoE.expert_mlp(rows, offsets, wg, wu, wd, scale)
    assert len(calls) == 3
    want = expert_mlp_plain(rows, offsets, wg, wu, wd, scale)
    # bf16 outputs of float32 sums taken in another order, rounded twice
    # before the down product: within two bf16 ulps of the largest output
    assert float((y.float() - want.float()).abs().max()) <= 2 * 2**-7 * float(want.float().abs().max())


@pytest.mark.cuda
def test_dropless_layer_reads_nothing_back_on_the_card(dev):
    model = dict(PUBLISHED["model"], num_hidden_layers=2)
    cfg = port_config(model)
    gen = torch.Generator(device=dev).manual_seed(12)
    p = MoE.MoE(cfg, gen, dev)
    x = torch.randn(4, 512, 2048, device=dev, generator=gen).bfloat16()
    with torch.no_grad():
        warm = MoE.moe_block(cfg, p, x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = MoE.moe_block(cfg, p, x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, warm)
