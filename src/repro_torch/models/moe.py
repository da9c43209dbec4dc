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

Inside an ``act_sharding.policy`` the block is expert parallel, as the
reference's ``shard_map`` path (``_moe_local_compute`` /
``_moe_block_shard_map``): every rank routes the whole batch (the
activations are replicated over ``model``), computes the slots of its
``E / tp`` experts into a [B, E / tp, C, D] buffer, and the ranks' float32
partial outputs are summed over ``model``.  Under a mesh policy the
module's expert weights are already this rank's shard; under a
process-group policy they are whole and the block takes its slice.  The
block trains: ``act_sharding.copy_to`` / ``reduce_from`` around it give
the replicated router, attention and embedding their whole gradient on
every rank, summed once.  Capacity positions are ranks over all experts,
so the slots kept are the dense path's.  The reference takes that path
only on a ``model`` axis of more than one device; here a policy takes it
at any world size (one card runs it at world 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import act_sharding
from .config import ModelConfig
from .layers import MLP, _normal, mlp_block, mlp_partial, mlp_split, model_device


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
    probs = torch.softmax(x.float() @ act_sharding.weight(p, "router"), dim=-1)  # [B,S,E]
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    if cfg.moe_norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(b, s * k)
    counts = F.one_hot(e_flat, e).cumsum(1)  # [B, S*k, E]
    pos = counts.gather(-1, e_flat[..., None])[..., 0] - 1
    return gate, e_flat, pos, pos < moe_capacity(cfg, s)


def _expert_slots(cfg: ModelConfig, x: torch.Tensor, routing, e0: int, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Each slot's gated expert output [B, S, k, D] for the experts
    [e0, e0 + E_l) whose stacked weights are given; zero for the other
    experts' slots and dropped ones."""
    b, s, d = x.shape
    k = cfg.moe_top_k
    c = moe_capacity(cfg, s)
    e_l = w_gate.shape[0]
    gate, e_flat, pos, in_cap = routing
    local = in_cap & (e_flat >= e0) & (e_flat < e0 + e_l)
    # Scatter each kept slot's token into its (row, expert, position); the
    # dropped ones all land on one spare row past the buffer, discarded.
    # Kept slots have distinct targets, so the scatter is exact.
    rows = torch.arange(b, device=x.device)[:, None]
    target = torch.where(local, (rows * e_l + e_flat - e0) * c + pos, b * e_l * c)
    src = x[:, torch.arange(s * k, device=x.device) // k]  # [B, S*k, D]
    buffer = x.new_zeros((b * e_l * c + 1, d))
    buffer[target.reshape(-1)] = src.reshape(-1, d)
    buf = buffer[:-1].reshape(b, e_l, c, d).transpose(0, 1).reshape(e_l, b * c, d)
    h = F.silu(buf @ w_gate) * (buf @ w_up)
    out_buf = (h @ w_down).reshape(e_l, b, c, d).transpose(0, 1).reshape(b * e_l * c, d)
    gathered = out_buf[torch.where(local, target, 0)]  # [B, S*k, D]
    gathered = gathered * (gate.reshape(b, s * k, 1) * local[..., None]).to(x.dtype)
    return gathered.reshape(b, s, k, d)


_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]: ``_moe_block_dense``, or expert parallel
    inside an ``act_sharding.policy`` (``_moe_block_shard_map``)."""
    routing = route(cfg, p, x)
    pol = act_sharding.current_policy()
    if pol is not None and act_sharding.expert_parallel():
        if not pol["sharded"]:  # whole weights: this rank's E / world of them
            world, rank = act_sharding.axis_size("model"), act_sharding.axis_rank("model")
            if cfg.moe_num_experts % world:
                raise ValueError(f"{cfg.moe_num_experts} experts do not split over {world} ranks")
            e_l = cfg.moe_num_experts // world
            return _expert_parallel(cfg, p, x, routing, rank * e_l,
                                    [getattr(p, n)[rank * e_l:(rank + 1) * e_l] for n in _EXPERT_WEIGHTS])
        if act_sharding.is_split(p, "w_gate"):
            ws = [act_sharding.weight(p, n, "keep") for n in _EXPERT_WEIGHTS]
            return _expert_parallel(cfg, p, x, routing, act_sharding.axis_rank("model") * ws[0].shape[0], ws)
    ws = [act_sharding.weight(p, n) for n in _EXPERT_WEIGHTS]
    out = _expert_slots(cfg, x, routing, 0, *ws).sum(2)
    return out if p.shared is None else out + mlp_block(p.shared, x)


def _expert_parallel(cfg: ModelConfig, p: MoE, x: torch.Tensor, routing, e0: int, ws) -> torch.Tensor:
    """This rank's experts, then the float32 sum over ``model``.  The
    activations and the routing are replicated over ``model``; each rank's
    gradient of them covers its own experts' slots, so they enter the
    region through ``copy_to`` (the gradient summed over the ranks) and
    the sum leaves it through ``reduce_from`` (the gradient passed on
    whole).  A shared MLP split over ``model`` joins the same sum."""
    gate, *rest = routing
    partial = _expert_slots(cfg, act_sharding.copy_to(x), (act_sharding.copy_to(gate), *rest),
                            e0, *ws).float().sum(2)
    shared_tp = mlp_split(p.shared) if p.shared is not None else 1
    if shared_tp > 1:
        partial = partial + mlp_partial(p.shared, x, shared_tp).float()
    out = act_sharding.reduce_from(partial).to(x.dtype)
    if p.shared is not None and shared_tp == 1:
        out = out + mlp_block(p.shared, x)
    return out
