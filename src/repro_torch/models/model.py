"""The decoder-only model in PyTorch for all ten architectures; mirrors
``repro.models.model``.

Layer kinds come from ``cfg.layer_pattern`` (attn / ssm) repeated over
depth, with MoE FFNs on the layers ``cfg.is_moe_layer`` picks and no MLP
where ``d_ff == 0`` (mamba2).  The ``cfg.first_k_dense_replace`` leading
layers (the port's own field; 0 in every configuration the reference has)
carry the dense MLP and stand before the first period.  The reference
stacks equal-structure layers along a ``periods`` axis and scans over it;
here each layer is an ``nn.Module`` in an ``nn.ModuleList`` and the passes
are loops over it (``models/convert.py`` unstacks a reference parameter
tree into it).
Parameters are bf16 (the reference's ``PARAM_DTYPE``; the MoE router and
the SSM's ``a_log`` / ``d_skip`` / ``dt_bias`` float32, as there) on an
explicit device, drawn from an explicit ``torch.Generator`` at the
reference's scales; the bytes differ from the reference's, whose RNG is
JAX's.

Entry points: ``init_params``, ``embed_inputs`` (with the VLM stub's
projected patch prefix; the audio stub changes nothing, as in the
reference), ``hidden_states``, ``forward``, ``init_cache`` /
``cache_shape``, ``prefill`` and ``decode_step`` (GQA caches k / v, MLA
the compressed c_kv ‖ k_rope payload with the absorbed decode, SSM the
recurrent state) and ``lm_loss`` (sequence-chunked cross entropy).

The cache is a dict ``{"length": int, "layers": [per-layer dict]}``, one
entry per layer rather than stacked over periods; ``prefill`` and
``decode_step`` write the attention caches in place and replace each SSM
state, and return the same dict.

``remat`` (``hidden_states``, ``forward``, ``lm_loss``) recomputes each
effective period's activations in the backward pass
(``act_sharding.checkpoint``, ``torch.utils.checkpoint`` in the
forward's policy, as the reference wraps its period body in
``jax.checkpoint``) when autograd records; serving runs under
``torch.no_grad`` and builds no graph.  ``cache_mode`` is the reference's
XLA memory device (carry vs. ys): taken for call-site parity, it changes
nothing here.

Under a mesh policy (``distributed.act_sharding``, the cells of
``launch.steps``) the model holds local shards and runs on them: the
embedding and the LM head split the vocabulary over ``model`` (each rank
looks up the ids in its range and the ranks sum; the loss takes its max
and its sum of exponentials over ``model`` and the label's logit from the
rank that owns it), the blocks as ``layers`` describes, the loss a mean
over every batch rank's labelled positions.  A cache may hold a slice of
the sequence (``cache["seq_shards"]`` ranks of ``model``, each
``S / seq_shards`` positions): ``prefill`` writes this rank's positions,
and ``decode_step`` needs a flash-decode hook over ``model``.  ``params_shape``
is the model on the meta device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from .._device import resolve_device
from ..distributed import act_sharding as shd
from .config import ModelConfig
from .layers import (
    ACT_DTYPE,
    MLP,
    PARAM_DTYPE,
    Attention,
    _normal,
    attention_block,
    attention_out,
    flash_attention,
    gqa_qkv,
    mla_query,
    mla_qkv,
    mlp_block,
    model_device,
    rms_norm,
    rope,
    softmax_scale,
)
from .moe import MoE, moe_block
from .probe import span as _span
from .ssm import SSM, init_ssm_state, ssm_block, ssm_block_with_state, ssm_decode_step

def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def effective_pattern(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """Per-slot (kind, is_moe) over one effective period of the layers
    after the leading dense ones."""
    pat = cfg.pattern()
    lead = cfg.first_k_dense_replace
    period = _lcm(len(pat), cfg.moe_every if cfg.moe_num_experts else 1)
    if (cfg.num_layers - lead) % period != 0:
        raise ValueError(
            f"{cfg.name}: layers {cfg.num_layers} after {lead} leading not divisible by period {period}"
        )
    return [(pat[(lead + s) % len(pat)], cfg.is_moe_layer(lead + s)) for s in range(period)]


def num_periods(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_k_dense_replace) // len(effective_pattern(cfg))


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(kind, is_moe) of every layer: the leading dense layers, then the
    effective pattern over the rest of the depth."""
    pat = cfg.pattern()
    lead = [(pat[l % len(pat)], False) for l in range(cfg.first_k_dense_replace)]
    return lead + effective_pattern(cfg) * num_periods(cfg)


def check_supported(cfg: ModelConfig) -> None:
    """Every family of ``repro_torch.configs`` is ported: this raises only
    what ``effective_pattern`` raises (a depth that is not a whole number
    of periods)."""
    effective_pattern(cfg)


def _ones(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=PARAM_DTYPE, device=device), requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm layer (``_init_layer``): attention or an SSM block,
    then a MoE FFN, the SwiGLU MLP, or nothing where ``d_ff == 0``."""

    def __init__(self, cfg: ModelConfig, kind: str = "attn", is_moe: bool = False,
                 generator=None, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.kind, self.is_moe = kind, is_moe
        self.ln_attn = _ones(cfg.d_model, device)
        if kind == "attn":
            self.attn = Attention(cfg, generator, device)
        else:
            self.ssm = SSM(cfg, generator, device)
        self.has_ffn = is_moe or cfg.d_ff > 0
        if self.has_ffn:
            self.ln_mlp = _ones(cfg.d_model, device)
        if is_moe:
            self.moe = MoE(cfg, generator, device)
        elif cfg.d_ff > 0:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, generator, device)

    def ffn(self, cfg: ModelConfig, x: torch.Tensor, probe=None) -> torch.Tensor:
        """The residual FFN sublayer (identity without one)."""
        if not self.has_ffn:
            return x
        h = rms_norm(x, self.ln_mlp, cfg.norm_eps)
        if self.is_moe:
            return x + moe_block(cfg, self.moe, h, probe)
        with _span(probe, "mlp"):
            return x + mlp_block(self.mlp, h)

    def forward(self, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, probe=None) -> torch.Tensor:
        """``repro.models.model._layer_forward``.  ``probe`` (a
        ``probe.ForwardProbe``, or None) times the sublayers and counts the
        routing."""
        if probe is not None:
            probe.next_layer()
        h = rms_norm(x, self.ln_attn, cfg.norm_eps)
        if self.kind == "attn":
            with _span(probe, "attention"):
                x = x + attention_block(cfg, self.attn, h, positions)
        else:
            x = x + ssm_block(cfg, self.ssm, h)
        return self.ffn(cfg, x, probe)


class Transformer(nn.Module):
    """The token embedding, the layers, the final norm, the LM head (absent
    with ``tie_embeddings``) and, for the VLM stub, ``vision_proj``."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = model_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = _normal((v, d), 0.02, generator, device)
        self.ln_final = _ones(d, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, kind, is_moe, generator, device)
                                    for kind, is_moe in layer_kinds(cfg))
        self.lm_head = None if cfg.tie_embeddings else _normal((d, v), 0.02, generator, device)
        self.vision_proj = None
        if cfg.frontend == "vlm_stub":  # applied to precomputed patch embeddings (SigLIP stub)
            self.vision_proj = _normal((d, d), 1.0 / math.sqrt(d), generator, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
        return forward(self.cfg, self, tokens, prefix_embeds)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    """A model with the reference's initial distributions (normal weights
    scaled by 1/sqrt(fan-in), embeddings and head by 0.02, the SSM conv by
    0.1, norms at one, biases at zero, ``a_log`` = log(linspace(1, 16))),
    drawn on ``device`` from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, gen, dev)


def params_shape(cfg: ModelConfig) -> Transformer:
    """The model on the meta device: shapes and dtypes, no memory."""
    return Transformer(cfg, device="meta")


def _head(cfg: ModelConfig, params: Transformer) -> torch.Tensor:
    """The LM head [D, V] (this rank's [D, V / tp] when the vocabulary is
    split over ``model``)."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _vocab_split(cfg: ModelConfig, params: Transformer) -> bool:
    return shd.is_split(params, "embed" if cfg.tie_embeddings else "lm_head")


def _logits(cfg: ModelConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """float32 logits of bf16 hidden states: bf16 products (exact in
    float32), float32 sums; every rank gets the whole vocabulary."""
    if not _vocab_split(cfg, params):
        return x.float() @ _head(cfg, params).float()
    local = shd.copy_to(x).float() @ _head(cfg, params).float()
    return shd.gather(local, "model", -1, "slice")


def _embed_tokens(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; with the vocabulary split over ``model`` each rank
    looks up the ids in its range (zero elsewhere) and the ranks sum."""
    if not shd.is_split(params, "embed"):
        return params.embed[tokens]
    v_l = params.embed.shape[0]
    local = tokens - shd.axis_rank("model") * v_l
    own = (local >= 0) & (local < v_l)
    x = params.embed[local.clamp(0, v_l - 1)] * own[..., None].to(params.embed.dtype)
    return shd.reduce_from(x)


def embed_inputs(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                 prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings [B, S, D]; the VLM stub puts its projected patch
    embeddings in front (and raises ``ValueError`` without them)."""
    x = _embed_tokens(params, tokens).to(ACT_DTYPE)
    if cfg.frontend == "vlm_stub":
        if prefix_embeds is None:
            raise ValueError(f"{cfg.name} needs prefix patch embeddings")
        pe = prefix_embeds.to(ACT_DTYPE) @ shd.weight(params, "vision_proj")
        x = torch.cat([pe, x], 1)
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _period_forward(cfg: ModelConfig, layers, x: torch.Tensor, positions: torch.Tensor,
                    probe=None) -> torch.Tensor:
    for layer in layers:
        x = layer(cfg, x, positions, probe)
    return x


def hidden_states(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                  prefix_embeds: torch.Tensor | None = None, remat: bool = True,
                  probe=None) -> torch.Tensor:
    """Final-norm hidden states [B, S_total, D] (no LM head).  With
    ``remat`` and autograd recording, the leading dense layers and then
    each effective period keep only their input and are recomputed in the
    backward pass.  ``probe``: see ``DecoderLayer.forward``."""
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    period = len(effective_pattern(cfg))
    lead = cfg.first_k_dense_replace
    groups = ([params.layers[:lead]] if lead else []) + [
        params.layers[lo:lo + period] for lo in range(lead, len(params.layers), period)]
    recompute = remat and torch.is_grad_enabled()
    for layers in groups:
        if recompute:
            x = shd.checkpoint(_period_forward, cfg, layers, x, positions, probe)
        else:
            x = _period_forward(cfg, layers, x, positions, probe)
    return rms_norm(x, params.ln_final, cfg.norm_eps)


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, remat: bool = True) -> torch.Tensor:
    """Causal LM logits [B, S_total, V] in float32."""
    return _logits(cfg, params, hidden_states(cfg, params, tokens, prefix_embeds, remat=remat))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=ACT_DTYPE, device="cuda") -> dict:
    """A zeroed decode cache, one entry per layer: GQA ``k`` / ``v``
    [B, max_seq, KVH, hd] and MLA ``c`` [B, max_seq, kv_lora+rope] in
    ``dtype``; SSM ``h`` [B, H, hd, N] float32 and ``conv``
    [B, conv-1, di+2N] bf16.  ``device="meta"`` gives shapes only."""
    device = model_device(device)
    layers = []
    for kind, _moe in layer_kinds(cfg):
        if kind != "attn":
            layers.append(init_ssm_state(cfg, batch, device=device))
        elif cfg.attn_type == "mla":
            payload = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            layers.append({"c": torch.zeros((batch, max_seq, payload), dtype=dtype, device=device)})
        else:
            shp = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
            layers.append({"k": torch.zeros(shp, dtype=dtype, device=device),
                           "v": torch.zeros(shp, dtype=dtype, device=device)})
    return {"length": 0, "layers": layers}


def cache_shape(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """``init_cache`` on the meta device: shapes and dtypes, no memory."""
    return init_cache(cfg, batch, max_seq, device="meta")


def _cache_max_seq(cfg: ModelConfig, cache: dict) -> int:
    for (kind, _moe), lc in zip(layer_kinds(cfg), cache["layers"]):
        if kind == "attn":
            return (lc["c"] if cfg.attn_type == "mla" else lc["k"]).shape[1]
    return 0


# ---------------------------------------------------------------------------
# Prefill: logits for all positions + populated cache
# ---------------------------------------------------------------------------


def _cache_write(dst: torch.Tensor, src: torch.Tensor, offset: int) -> None:
    """Positions [offset, offset + S_local) of ``src`` into the cache slice
    ``dst`` (as many as ``src`` has)."""
    n = max(0, min(dst.shape[1], src.shape[1] - offset))
    if n:
        dst[:, :n] = src[:, offset:offset + n]


def _all_kv_heads(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """Every KV head [B, S, KVH, hd] from this rank's ones under a
    head-parallel policy (each KV head once, where it was repeated)."""
    tp = shd.head_parallel(cfg)
    if tp <= 1:
        return k
    k = shd.gather_nograd(k, "model", 2)
    return k[:, :, ::tp // cfg.num_kv_heads] if cfg.num_kv_heads % tp else k


def _attn_prefill(cfg: ModelConfig, p: Attention, h: torch.Tensor, positions: torch.Tensor,
                  slot_cache: dict, offset: int = 0) -> torch.Tensor:
    """Attention over the prompt; writes the prompt's cache rows (from
    position ``offset``, where the cache holds a slice of the sequence)."""
    b, s, _ = h.shape
    if cfg.attn_type == "mla":
        q, k, v, payload = mla_qkv(cfg, p, h, positions)
        _cache_write(slot_cache["c"], payload, offset)
    else:
        q, k, v = gqa_qkv(cfg, p, h, positions)
        _cache_write(slot_cache["k"], _all_kv_heads(cfg, k), offset)
        _cache_write(slot_cache["v"], _all_kv_heads(cfg, v), offset)
    out = flash_attention(q, k, v, causal_offset=0, scale=softmax_scale(cfg, q.shape[-1]))
    return attention_out(cfg, p, out.reshape(b, s, -1))


def _seq_offset(cfg: ModelConfig, cache: dict) -> int:
    """The first position of this rank's slice of a sequence-sharded cache."""
    if cache.get("seq_shards", 1) <= 1:
        return 0
    return shd.axis_rank("model") * _cache_max_seq(cfg, cache)


def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, cache: dict,
            prefix_embeds: torch.Tensor | None = None, remat: bool = True,
            last_only: bool = False, cache_mode: str = "carry") -> tuple[torch.Tensor, dict]:
    """Logits [B, S_total, V] float32 (only the last position's with
    ``last_only``) and the cache filled with the prompt; every SSM state
    starts from zero."""
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    b, s, _ = x.shape
    capacity = _cache_max_seq(cfg, cache) * cache.get("seq_shards", 1)
    if s > capacity > 0:
        raise ValueError(f"prefill of {s} positions into a cache of {capacity}")
    positions = _positions(b, s, x.device)
    offset = _seq_offset(cfg, cache)
    for layer, lc in zip(params.layers, cache["layers"]):
        h = rms_norm(x, layer.ln_attn, cfg.norm_eps)
        if layer.kind == "attn":
            x = x + _attn_prefill(cfg, layer.attn, h, positions, lc, offset)
        else:
            out, state = ssm_block_with_state(cfg, layer.ssm, h, {})
            lc["h"], lc["conv"] = state["h"].to(lc["h"].dtype), state["conv"].to(lc["conv"].dtype)
            x = x + out
        x = layer.ffn(cfg, x)
    x = rms_norm(x, params.ln_final, cfg.norm_eps)
    if last_only:  # serving needs only the next-token distribution
        x = x[:, -1:]
    cache["length"] = s
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

# Decode attention is injectable: the distributed layer's flash-decode over
# sequence-sharded caches plugs in here; the dense defaults below are the
# single-device reference.  Signatures:
#   gqa: (q, k_new, v_new, k_cache, v_cache, pos) -> (out, k_cache, v_cache)
#   mla: (q_c, q_rope, payload, c_cache, pos, r, scale_dim) -> (ctx, c_cache)
DecodeAttnFn = Callable[..., tuple]


def dense_gqa_decode_attn(q, k_new, v_new, k_cache, v_cache, pos: int):
    """Writes row ``pos`` of the caches in place and attends over the whole
    cache: float32 scores, -1e30 past ``pos``, float32 softmax."""
    b, _one, h, hd = q.shape
    k_cache[:, pos:pos + 1] = k_new
    v_cache[:, pos:pos + 1] = v_new
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    q5 = q.reshape(b, 1, kvh, h // kvh, hd).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k_cache.float()) / math.sqrt(hd)
    scores = scores.masked_fill(torch.arange(s, device=q.device) > pos, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype), k_cache, v_cache


def dense_mla_decode_attn(q_c, q_rope, payload, c_cache, pos: int, r: int, scale_dim: float):
    """Absorbed MLA decode over the compressed cache: writes row ``pos`` in
    place, scores q_c · c_kv + q_rope · k_rope at 1/sqrt(scale_dim) in
    float32 (``scale_dim`` the query head width, or 1 / scale^2 where the
    softmax's scale is not the default: YaRN), -1e30 past ``pos``; returns
    the context in the latent space."""
    c_cache[:, pos:pos + 1] = payload
    s = c_cache.shape[1]
    c_kv = c_cache[..., :r].float()
    k_rope = c_cache[..., r:].float()
    scores = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c_kv)
              + torch.einsum("bqhn,bsn->bhqs", q_rope.float(), k_rope)) / math.sqrt(scale_dim)
    scores = scores.masked_fill(torch.arange(s, device=q_c.device) > pos, -1e30)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, c_kv)
    return ctx.to(q_c.dtype), c_cache


def _attn_decode(cfg: ModelConfig, p: Attention, h: torch.Tensor, slot_cache: dict, pos: int,
                 positions: torch.Tensor, gqa_attn_impl, mla_attn_impl) -> torch.Tensor:
    """One position's attention.  Under a head-parallel policy the query
    (and new KV) heads of every rank are gathered for the hook, which sees
    all heads, and each rank projects its own heads' output."""
    b = h.shape[0]
    tp = shd.head_parallel(cfg)
    if cfg.attn_type == "mla":
        nope, rope_d, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        vd, hn = cfg.v_head_dim, cfg.num_heads // tp
        keep = "keep" if tp > 1 else "slice"
        q = mla_query(cfg, p, h, tp).reshape(b, 1, hn, nope + rope_d)
        q_nope, q_rope = q[..., :nope], rope(cfg, q[..., nope:], positions)
        dkv = h @ shd.weight(p, "w_dkv")  # [B,1,r+rope]
        c_kv = rms_norm(dkv[..., :r], p.kv_norm, cfg.norm_eps)
        k_rope = rope(cfg, dkv[..., r:].reshape(b, 1, 1, rope_d), positions).reshape(b, 1, rope_d)
        # Absorbed query / value projections: score and read in the
        # compressed space.
        w_ukv = shd.weight(p, "w_ukv", keep).reshape(r, hn, nope + vd)
        q_c = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_ukv[..., :nope].float()).to(h.dtype)
        if tp > 1:
            q_c, q_rope = shd.gather_nograd(q_c, "model", 2), shd.gather_nograd(q_rope, "model", 2)
        scale = softmax_scale(cfg, nope + rope_d)
        ctx, slot_cache["c"] = mla_attn_impl(q_c, q_rope, torch.cat([c_kv, k_rope], -1), slot_cache["c"],
                                             pos, r, nope + rope_d if scale is None else scale ** -2)
        if tp > 1:
            ctx = shd.local_block(ctx, "model", 2)
        out = torch.einsum("bqhr,rhv->bqhv", ctx.float(), w_ukv[..., nope:].float()).to(h.dtype)
        return attention_out(cfg, p, out.reshape(b, 1, hn * vd))
    q, k, v = gqa_qkv(cfg, p, h, positions)
    if tp > 1:
        q, k, v = shd.gather_nograd(q, "model", 2), _all_kv_heads(cfg, k), _all_kv_heads(cfg, v)
    out, slot_cache["k"], slot_cache["v"] = gqa_attn_impl(q, k, v, slot_cache["k"], slot_cache["v"], pos)
    if tp > 1:
        out = shd.local_block(out, "model", 2)
    return attention_out(cfg, p, out.reshape(b, 1, -1))


def decode_step(cfg: ModelConfig, params: Transformer, cache: dict, tokens: torch.Tensor,
                gqa_attn_impl: DecodeAttnFn = dense_gqa_decode_attn,
                mla_attn_impl: DecodeAttnFn = dense_mla_decode_attn,
                cache_mode: str = "carry") -> tuple[torch.Tensor, dict]:
    """One decode step for tokens [B, 1] at position ``cache["length"]``:
    (logits [B, 1, V] float32, the cache advanced by one)."""
    pos = int(cache["length"])
    # a sequence-sharded cache (``distributed.decode_attn``) holds 1 / seq_shards of the positions
    impl = mla_attn_impl if cfg.attn_type == "mla" else gqa_attn_impl
    capacity = _cache_max_seq(cfg, cache) * getattr(impl, "seq_shards", 1)
    if pos >= capacity > 0:
        raise ValueError(f"decode at position {pos} past a cache of {capacity}")
    x = _embed_tokens(params, tokens).to(ACT_DTYPE)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    for layer, lc in zip(params.layers, cache["layers"]):
        h = rms_norm(x, layer.ln_attn, cfg.norm_eps)
        if layer.kind == "attn":
            x = x + _attn_decode(cfg, layer.attn, h, lc, pos, positions, gqa_attn_impl, mla_attn_impl)
        else:
            out, state = ssm_decode_step(cfg, layer.ssm, h, lc)
            lc.update(state)
            x = x + out
        x = layer.ffn(cfg, x)
    x = rms_norm(x, params.ln_final, cfg.norm_eps)
    cache["length"] = pos + 1
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _chunk_nll(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
               vocab_lo: int | None = None) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk: float32 logits of the
    bf16 hidden states, labels below 0 left out.  With ``vocab_lo`` the
    head is this rank's vocabulary slice from that id on: the log-sum-exp
    takes its max and its sum over ``model``, the label's logit comes from
    the rank that owns it."""
    z = x.float() @ head.float()
    valid = labels >= 0
    if vocab_lo is None:
        logp = torch.log_softmax(z, dim=-1)
        nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
        return (nll * valid).sum()
    v_l = z.shape[-1]
    m = shd.all_reduce(z.detach().amax(-1), "model", op=torch.distributed.ReduceOp.MAX)
    sum_exp = shd.reduce_from(torch.exp(z - m[..., None]).sum(-1))
    local = labels - vocab_lo
    own = valid & (local >= 0) & (local < v_l)
    label_logit = z.gather(-1, local.clamp(0, v_l - 1)[..., None].long())[..., 0] * own
    nll = m + torch.log(sum_exp) - shd.reduce_from(label_logit)
    return (nll * valid).sum()


def lm_loss(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, remat: bool = True,
            seq_chunk: int = 1_024) -> torch.Tensor:
    """Sequence-chunked cross entropy over next-token ``labels`` [B, S]
    (-100 = ignore): the mean over the labelled positions, a float32
    scalar.  The VLM stub's patch positions carry no label and are cut off.
    The head matmul and log-softmax run one chunk of ``seq_chunk``
    positions at a time, each recomputed in the backward pass, so the
    [B, S, V] logits are never materialized: peak memory is one chunk's
    [B, seq_chunk, V].  Under a policy whose batch is split, the mean is
    over every batch rank's labelled positions (the same on each rank)."""
    x = hidden_states(cfg, params, tokens, prefix_embeds, remat=remat)
    if cfg.frontend == "vlm_stub" and prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    head = _head(cfg, params)
    vocab_lo = None
    if _vocab_split(cfg, params):
        x = shd.copy_to(x)
        vocab_lo = shd.axis_rank("model") * head.shape[1]
    chunk = min(seq_chunk, x.shape[1])
    recompute = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[1], chunk):
        xc, lc = x[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if recompute:
            total = total + shd.checkpoint(_chunk_nll, head, xc, lc, vocab_lo)
        else:
            total = total + _chunk_nll(head, xc, lc, vocab_lo)
    count = (labels >= 0).sum()
    for axis in shd.batch_axes():
        shd.all_reduce(count, axis)
    return shd.sum_over_batch(total / count.clamp_min(1))
