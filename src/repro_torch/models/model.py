"""The decoder-only model in PyTorch; mirrors ``repro.models.model`` for
dense GQA / MQA configurations.

The reference stacks equal-structure layers along a ``periods`` axis and
scans over it; here each decoder layer is an ``nn.Module`` in an
``nn.ModuleList`` and the forward pass is a loop over it
(``models/convert.py`` unstacks a reference parameter tree into it).
Parameters are bf16 (the reference's ``PARAM_DTYPE``) on an explicit
device, drawn from an explicit ``torch.Generator`` at the reference's
scales; the bytes differ from the reference's, whose RNG is JAX's.

Ported: ``effective_pattern``, ``num_periods``, ``init_params``,
``embed_inputs``, ``hidden_states`` and ``forward`` (logits) for
``family == "dense"`` with ``attn_type == "gqa"``.  Every other family
(MLA, MoE, SSM and hybrid stacks, the VLM / audio stub frontends) raises
``NotImplementedError`` naming its ROADMAP item, as do caches, ``prefill``,
``decode_step`` and ``lm_loss``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from .config import ModelConfig
from .layers import (
    ACT_DTYPE,
    MLA_NOT_PORTED,
    MLP,
    PARAM_DTYPE,
    Attention,
    attention_block,
    mlp_block,
    model_device,
    rms_norm,
)

#: What the unported parts raise, each naming its ROADMAP item.
NOT_PORTED = {
    "mla": MLA_NOT_PORTED,
    "moe": "mixture-of-experts layers are not ported yet: ROADMAP Queue 1 item 4, step 2 (MoE)",
    "ssm": "SSM and hybrid stacks are not ported yet: ROADMAP Queue 1 item 4, step 3 (SSM / hybrid)",
    "frontend": "the VLM / audio stub frontends are not ported yet: ROADMAP Queue 1 item 4, step 4 (stub frontends)",
    "decode": "caches, prefill and decode_step are not ported yet: ROADMAP Queue 1 item 4, step 5 (caches)",
    "loss": "lm_loss is not ported yet: ROADMAP Queue 1 item 4, step 6 (lm_loss with train/)",
}


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def effective_pattern(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """Per-slot (kind, is_moe) over one effective period."""
    pat = cfg.pattern()
    period = _lcm(len(pat), cfg.moe_every if cfg.moe_num_experts else 1)
    if cfg.num_layers % period != 0:
        raise ValueError(
            f"{cfg.name}: layers {cfg.num_layers} not divisible by period {period}"
        )
    return [(pat[s % len(pat)], cfg.is_moe_layer(s)) for s in range(period)]


def num_periods(cfg: ModelConfig) -> int:
    return cfg.num_layers // len(effective_pattern(cfg))


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) unless the
    configuration is a dense GQA / MQA decoder without a frontend."""
    if cfg.attn_type == "mla":
        raise NotImplementedError(NOT_PORTED["mla"])
    if cfg.family in ("ssm", "hybrid") or "ssm" in cfg.pattern():
        raise NotImplementedError(NOT_PORTED["ssm"])
    if cfg.family == "moe" or cfg.moe_num_experts:
        raise NotImplementedError(NOT_PORTED["moe"])
    if cfg.frontend is not None or cfg.family in ("vlm", "audio"):
        raise NotImplementedError(NOT_PORTED["frontend"])


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: attention, then the SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        device = model_device(device)
        d = cfg.d_model
        self.ln_attn = nn.Parameter(torch.ones(d, dtype=PARAM_DTYPE, device=device), requires_grad=False)
        self.attn = Attention(cfg, generator, device)
        self.ln_mlp = nn.Parameter(torch.ones(d, dtype=PARAM_DTYPE, device=device), requires_grad=False)
        self.mlp = MLP(d, cfg.d_ff, generator, device)

    def forward(self, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """``repro.models.model._layer_forward`` for an attention slot."""
        h = rms_norm(x, self.ln_attn, cfg.norm_eps)
        x = x + attention_block(cfg, self.attn, h, positions)
        h = rms_norm(x, self.ln_mlp, cfg.norm_eps)
        return x + mlp_block(self.mlp, h)


class Transformer(nn.Module):
    """The token embedding, the decoder layers, the final norm and the LM
    head (absent with ``tie_embeddings``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = model_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(
            torch.randn((v, d), generator=generator, device=device, dtype=PARAM_DTYPE).mul_(0.02),
            requires_grad=False,
        )
        self.ln_final = nn.Parameter(torch.ones(d, dtype=PARAM_DTYPE, device=device), requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, generator, device) for _ in range(cfg.num_layers))
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.randn((d, v), generator=generator, device=device, dtype=PARAM_DTYPE).mul_(0.02),
                requires_grad=False,
            )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self, tokens)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    """A model with the reference's initial distributions: normal weights
    scaled by 1/sqrt(fan-in), embeddings and head by 0.02, norms at one,
    biases at zero, all bf16, drawn on ``device`` from a generator seeded
    with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, gen, dev)


def embed_inputs(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                 prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    if cfg.frontend is not None or prefix_embeds is not None:
        raise NotImplementedError(NOT_PORTED["frontend"])
    return params.embed[tokens].to(ACT_DTYPE)


def hidden_states(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                  prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Final-norm hidden states [B, S, D] (no LM head)."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, tokens, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for layer in params.layers:
        x = layer(cfg, x, positions)
    return rms_norm(x, params.ln_final, cfg.norm_eps)


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Causal LM logits [B, S, V] in float32 (bf16 products, float32 sums)."""
    x = hidden_states(cfg, params, tokens, prefix_embeds)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x.float() @ head.float()


def init_cache(*_args, **_kwargs):
    raise NotImplementedError(NOT_PORTED["decode"])


def prefill(*_args, **_kwargs):
    raise NotImplementedError(NOT_PORTED["decode"])


def decode_step(*_args, **_kwargs):
    raise NotImplementedError(NOT_PORTED["decode"])


def lm_loss(*_args, **_kwargs):
    raise NotImplementedError(NOT_PORTED["loss"])
