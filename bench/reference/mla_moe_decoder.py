"""Plain float32 DeepSeek-V2 embedder: the reference the embeddings of an
MLA + MoE configuration (DeepSeek-V2-Lite) are held to.

The published layer (arXiv:2405.04434; the model's ``config.json`` keys,
as ``model`` holds them): pre-norm RMSNorm; multi-head latent attention
with a direct query projection (``q_proj``, ``q_lora_rank`` null), the
joint ``kv_a_proj_with_mqa`` to the 512-wide latent and the 64-wide shared
rope key, ``kv_a_layernorm``, ``kv_b_proj`` to each head's 128 no-rope key
and 128 value; YaRN RoPE (``rope_scaling``: inverse frequencies ramped
between the original and the stretched ones, cos and sin times mscale /
mscale_all_dim) on the rope parts, and the softmax scale
(nope + rope)^-1/2 times mscale(factor, mscale_all_dim)^2; then the
first ``first_k_dense_replace`` layers a dense SwiGLU of
``intermediate_size``, the others a softmax router over
``n_routed_experts``, greedy top ``num_experts_per_tok`` by ``torch.topk``
on the float32 scores, the gates not renormalized
(``norm_topk_prob`` false) and times ``routed_scaling_factor``, each
expert's SwiGLU of ``moe_intermediate_size`` applied to its own tokens,
plus the ``n_shared_experts`` shared experts as one SwiGLU; a final
RMSNorm; the embedding is the hidden states' mean over the sequence,
scaled to unit length.  Float32 with TF32 off, one layer at a time, each
layer's weights drawn again from the seed (``decoder.pooled_embeddings``);
``precision="fp8"`` rounds every matrix product's inputs to float8 e4m3
(the control).  It imports nothing of the program.

Departures, each equivalent at load or outside what an embedder computes:
- RoPE rotates halves of the rope channels as drawn.  DeepSeek-V2's code
  first de-interleaves them (``view(..., d // 2, 2).transpose``): on drawn
  weights that is a fixed permutation of the rope columns of ``q_proj``
  and ``kv_a_proj_with_mqa``, which a published checkpoint would take once
  at load.
- The weights are the port's names and layouts (``x @ w``): ``attn.w_q``
  is ``q_proj`` transposed, ``attn.w_dkv`` ``kv_a_proj_with_mqa``,
  ``attn.kv_norm`` ``kv_a_layernorm``, ``attn.w_ukv`` ``kv_b_proj``,
  ``attn.w_o`` ``o_proj``; ``moe.router`` the gate, ``moe.w_gate`` /
  ``w_up`` / ``w_down`` the routed experts stacked, ``moe.shared.*`` the
  shared experts as one MLP of twice the width.
- The router's auxiliary loss (``seq_aux``) trains only; the LM head is
  not computed.
"""

from __future__ import annotations

import math

import torch

from bench.reference import decoder


def _dims(model: dict):
    return (model["hidden_size"], model["num_attention_heads"], model["qk_nope_head_dim"],
            model["qk_rope_head_dim"], model["v_head_dim"], model["kv_lora_rank"])


def layer_parameters(model: dict, layer: int) -> list[tuple[str, tuple[int, ...], float | str]]:
    """(name under ``layers.<layer>.`` in the port's state dict, shape,
    init) of one layer, in the order they are drawn: the matrices at
    1/sqrt(fan-in) (attention, then the dense MLP of a leading layer or the
    router, the stacked routed experts and the shared MLP), then the
    RMSNorm scales."""
    d, h, nope, rope_d, vd, r = _dims(model)
    out = [
        ("attn.w_q", (d, h * (nope + rope_d)), 1 / math.sqrt(d)),
        ("attn.w_dkv", (d, r + rope_d), 1 / math.sqrt(d)),
        ("attn.w_ukv", (r, h * (nope + vd)), 1 / math.sqrt(r)),
        ("attn.w_o", (h * vd, d), 1 / math.sqrt(h * vd)),
    ]
    if layer < model["first_k_dense_replace"]:
        f = model["intermediate_size"]
        out += [("mlp.w_gate", (d, f), 1 / math.sqrt(d)), ("mlp.w_up", (d, f), 1 / math.sqrt(d)),
                ("mlp.w_down", (f, d), 1 / math.sqrt(f))]
    else:
        e, f = model["n_routed_experts"], model["moe_intermediate_size"]
        fs = f * model["n_shared_experts"]
        out += [("moe.router", (d, e), 1 / math.sqrt(d)),
                ("moe.w_gate", (e, d, f), 1 / math.sqrt(d)), ("moe.w_up", (e, d, f), 1 / math.sqrt(d)),
                ("moe.w_down", (e, f, d), 1 / math.sqrt(f)),
                ("moe.shared.w_gate", (d, fs), 1 / math.sqrt(d)), ("moe.shared.w_up", (d, fs), 1 / math.sqrt(d)),
                ("moe.shared.w_down", (fs, d), 1 / math.sqrt(fs))]
    return out + [("attn.kv_norm", (r,), "norm"), ("ln_attn", (d,), "norm"), ("ln_mlp", (d,), "norm")]


def yarn_mscale(scale: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if scale <= 1.0 else 0.1 * mscale * math.log(scale) + 1.0


def yarn(model: dict, device) -> tuple[torch.Tensor, float, float]:
    """(inverse frequencies [rope/2], the cos / sin factor, the softmax
    scale) of ``rope_scaling`` as ``DeepseekV2YarnRotaryEmbedding`` and
    ``DeepseekV2Attention`` compute them."""
    y = model["rope_scaling"]
    dim, base, factor = model["qk_rope_head_dim"], model["rope_theta"], y["factor"]
    orig = y["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(y["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(y["beta_slow"])), dim - 1)
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    extra, inter = 1.0 / pos_freqs, 1.0 / (factor * pos_freqs)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    mask = 1.0 - ramp
    inv_freq = inter * (1 - mask) + extra * mask
    cos_scale = yarn_mscale(factor, y["mscale"]) / yarn_mscale(factor, y["mscale_all_dim"])
    softmax = (model["qk_nope_head_dim"] + dim) ** -0.5
    if y.get("mscale_all_dim"):
        softmax *= yarn_mscale(factor, y["mscale_all_dim"]) ** 2
    return inv_freq, cos_scale, softmax


def rope(x: torch.Tensor, inv_freq: torch.Tensor, cos_scale: float) -> torch.Tensor:
    """x [B, S, H, dim]: rotate-half rotary embedding at positions 0..S-1."""
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    cos = (torch.cos(ang) * cos_scale)[None, :, None, :]
    sin = (torch.sin(ang) * cos_scale)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(a: torch.Tensor, w: dict, model: dict, precision: str) -> torch.Tensor:
    """MLA over the normed input a [B, S, D]: the output projection's
    result [B, S, D]."""
    b, s, _ = a.shape
    _d, h, nope, rope_d, vd, r = _dims(model)
    inv_freq, cos_scale, scale = yarn(model, a.device)
    q = decoder.mm(a, w["attn.w_q"], precision).view(b, s, h, nope + rope_d)
    kv_a = decoder.mm(a, w["attn.w_dkv"], precision)
    c = decoder.rms(kv_a[..., :r], w["attn.kv_norm"], model["rms_norm_eps"])
    kv = decoder.mm(c, w["attn.w_ukv"], precision).view(b, s, h, nope + vd)
    k_pe = rope(kv_a[..., r:].reshape(b, s, 1, rope_d), inv_freq, cos_scale).expand(b, s, h, rope_d)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], inv_freq, cos_scale)], -1)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=a.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, kv[..., nope:]).reshape(b, s, h * vd)
    return decoder.mm(out, w["attn.w_o"], precision)


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, precision: str):
    return decoder.mm(torch.nn.functional.silu(decoder.mm(x, gate, precision)) * decoder.mm(x, up, precision),
                      down, precision)


def routing(x: torch.Tensor, w: dict, model: dict, precision: str = "float32"):
    """(gates [N, k], experts [N, k]) of the tokens x [N, D]: the softmax
    of the float32 router scores, greedy top k by ``torch.topk``, times
    ``routed_scaling_factor`` (renormalized first where ``norm_topk_prob``)."""
    probs = torch.softmax(decoder.mm(x, w["moe.router"], precision), dim=-1)
    gate, idx = torch.topk(probs, model["num_experts_per_tok"], dim=-1)
    if model.get("norm_topk_prob"):
        gate = gate / gate.sum(-1, keepdim=True)
    return gate * model.get("routed_scaling_factor", 1.0), idx


def moe(x: torch.Tensor, w: dict, model: dict, precision: str) -> torch.Tensor:
    """The MoE FFN of the normed x [B, S, D]: each routed expert applied to
    the tokens that chose it, weighed by their gates, plus the shared
    experts."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    gate, idx = routing(flat, w, model, precision)
    out = torch.zeros_like(flat)
    for e in range(model["n_routed_experts"]):
        tok, rank = (idx == e).nonzero(as_tuple=True)
        if len(tok):
            y = _swiglu(flat[tok], w["moe.w_gate"][e], w["moe.w_up"][e], w["moe.w_down"][e], precision)
            out.index_add_(0, tok, y * gate[tok, rank, None])
    shared = _swiglu(flat, w["moe.shared.w_gate"], w["moe.shared.w_up"], w["moe.shared.w_down"], precision)
    return (out + shared).view(b, s, d)


def _layer(x: torch.Tensor, w: dict, model: dict, precision: str) -> torch.Tensor:
    eps = model["rms_norm_eps"]
    x = x + attention(decoder.rms(x, w["ln_attn"], eps), w, model, precision)
    h = decoder.rms(x, w["ln_mlp"], eps)
    if "mlp.w_gate" in w:
        return x + _swiglu(h, w["mlp.w_gate"], w["mlp.w_up"], w["mlp.w_down"], precision)
    return x + moe(h, w, model, precision)


def embed(tokens: torch.Tensor, model: dict, seed: int, device, precision: str = "float32",
          block: int = 16) -> torch.Tensor:
    """Unit-length embeddings [B, d] (float32) of ``tokens`` [B, S], in
    blocks of ``block`` documents."""
    return decoder.pooled_embeddings(tokens, model, seed, device, layer_parameters, _layer, precision, block)


def flops_per_token(model: dict, seq_len: int) -> float:
    """Model FLOPs of one token to the final norm, in
    ``yardstick.decoder_flops_per_token``'s convention: 2 per weight a
    token multiplies by (MLA's projections; the dense MLP of a leading
    layer; the router, its top k routed experts and the shared experts of
    the others), plus the causal attention products, QK over nope + rope
    and PV over the value width, over the (S + 1) / 2 keys a token sees on
    average."""
    d, h, nope, rope_d, vd, r = _dims(model)
    layers, lead = model["num_hidden_layers"], model["first_k_dense_replace"]
    attn = d * h * (nope + rope_d) + d * (r + rope_d) + r * h * (nope + vd) + h * vd * d
    dense = 3 * d * model["intermediate_size"]
    f = model["moe_intermediate_size"]
    routed = d * model["n_routed_experts"] + 3 * d * f * (model["num_experts_per_tok"] + model["n_shared_experts"])
    products = 2 * h * (nope + rope_d + vd) * (seq_len + 1) / 2
    return layers * (2.0 * attn + products) + lead * 2.0 * dense + (layers - lead) * 2.0 * routed


def routed_expert_flops_per_token(model: dict) -> float:
    """The FLOPs of one token's routed experts, every MoE layer: 2 per
    weight of its top k experts' three projections (what the grouped
    products compute)."""
    layers = model["num_hidden_layers"] - model["first_k_dense_replace"]
    return layers * model["num_experts_per_tok"] * 3 * 2.0 * model["hidden_size"] * model["moe_intermediate_size"]
