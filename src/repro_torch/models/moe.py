"""Mixture-of-Experts FFN with capacity-factor dispatch; mirrors
``repro.models.moe``'s dense formulation (``_moe_block_dense``).

Token-choice top-k routing (Qwen3-MoE, DeepSeekMoE).  The router runs in
float32; each batch row's slots (token-major, ``s * k + rank``) take
positions in their expert's buffer of ``moe_capacity`` rows by a running
count, so an expert's later slots are the ones dropped, and a dropped slot
contributes zero.  Expert MLPs are batched matmuls over the dense
[B, E, C, D] buffer; the combine gathers each slot's row back and weighs it
by its gate (renormalized over the top k only with ``moe_norm_topk``).
DeepSeek's shared experts are a dense MLP added unconditionally.

The reference's expert-parallel ``shard_map`` path (``_moe_local_compute``
/ ``_moe_block_shard_map``) needs a device mesh: it waits for
``distributed/`` (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, _normal, model_device


def moe_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Buffer rows per expert and batch row: ceil(S * k / E * cf), rounded
    up to a multiple of 8, at least 8."""
    cap = int(math.ceil(seq_len * cfg.moe_top_k / cfg.moe_num_experts * cfg.moe_capacity_factor))
    return max(8, -(-cap // 8) * 8)


class MoE(nn.Module):
    """Router (float32) and stacked expert weights (``init_moe_params``),
    plus ``shared`` (an ``MLP`` of ``moe_d_ff * moe_num_shared``) where the
    configuration has shared experts."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        device = model_device(device)
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
        self.router = _normal((d, e), 1.0 / math.sqrt(d), generator, device, torch.float32)
        self.w_gate = _normal((e, d, f), 1.0 / math.sqrt(d), generator, device)
        self.w_up = _normal((e, d, f), 1.0 / math.sqrt(d), generator, device)
        self.w_down = _normal((e, f, d), 1.0 / math.sqrt(f), generator, device)
        self.shared = MLP(d, f * cfg.moe_num_shared, generator, device) if cfg.moe_num_shared else None


def route(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Routing of x [B, S, D]: (gate [B, S, k] float32, expert [B, S*k],
    position in the expert's buffer [B, S*k], kept [B, S*k]).

    Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
    does: a stable descending sort."""
    b, s, _ = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    probs = torch.softmax(x.float() @ p.router, dim=-1)  # [B,S,E]
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    if cfg.moe_norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(b, s * k)
    counts = F.one_hot(e_flat, e).cumsum(1)  # [B, S*k, E]
    pos = counts.gather(-1, e_flat[..., None])[..., 0] - 1
    return gate, e_flat, pos, pos < moe_capacity(cfg, s)


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] (``_moe_block_dense``)."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    c = moe_capacity(cfg, s)
    gate, e_flat, pos, in_cap = route(cfg, p, x)
    # Scatter each kept slot's token into its (row, expert, position); the
    # dropped ones all land on one spare row past the buffer, discarded.
    # Kept slots have distinct targets, so the scatter is exact.
    rows = torch.arange(b, device=x.device)[:, None]
    target = torch.where(in_cap, (rows * e + e_flat) * c + pos, b * e * c)
    src = x[:, torch.arange(s * k, device=x.device) // k]  # [B, S*k, D]
    buffer = x.new_zeros((b * e * c + 1, d))
    buffer[target.reshape(-1)] = src.reshape(-1, d)
    buf = buffer[:-1].reshape(b, e, c, d).transpose(0, 1).reshape(e, b * c, d)
    h = F.silu(buf @ p.w_gate) * (buf @ p.w_up)
    out_buf = (h @ p.w_down).reshape(e, b, c, d).transpose(0, 1).reshape(b * e * c, d)
    gathered = out_buf[torch.where(in_cap, target, 0)]  # [B, S*k, D]
    gathered = gathered * (gate.reshape(b, s * k, 1) * in_cap[..., None]).to(x.dtype)
    out = gathered.reshape(b, s, k, d).sum(2)
    if p.shared is not None:
        sp = p.shared
        out = out + (F.silu(x @ sp.w_gate) * (x @ sp.w_up)) @ sp.w_down
    return out
