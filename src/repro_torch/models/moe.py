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

A dropless configuration (``moe_dropless``, the port's own: DeepSeek-V2
computes every routed slot) takes neither buffer: the B*S*k slots are
sorted by expert, each expert's SwiGLU runs over its own segment in
grouped matrix products (``torch._grouped_mm``: one call a projection,
whatever the load, nothing read back to the host), each output row is
weighed by its gate, and each token sums its k rows.  It has no
expert-parallel path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import act_sharding
from .config import ModelConfig
from .layers import MLP, _normal, mlp_block, mlp_partial, mlp_split, model_device
from .probe import span as _span


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


def top_k(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """The router's top k of x [B, S, D]: (gate [B, S, k] float32, expert
    [B, S, k]); the softmax's gates, renormalized over the top k only with
    ``moe_norm_topk``.  Ties break toward the lower expert index, as
    ``jax.lax.top_k`` does: a stable descending sort."""
    k = cfg.moe_top_k
    probs = torch.softmax(x.float() @ act_sharding.weight(p, "router"), dim=-1)  # [B,S,E]
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    if cfg.moe_norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate, idx


def route(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """Routing of x [B, S, D]: (gate [B, S, k] float32, expert [B, S*k],
    position in the expert's buffer [B, S*k], kept [B, S*k])."""
    b, s, _ = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    gate, idx = top_k(cfg, p, x)
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


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor, probe=None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]: ``_moe_block_dense``, or expert parallel
    inside an ``act_sharding.policy`` (``_moe_block_shard_map``), or
    dropless (``moe_dropless``).  ``probe`` (a ``probe.ForwardProbe`` or
    None) times the dropless path's steps and counts the slots each
    expert took and, on the capacity path, the slots dropped."""
    pol = act_sharding.current_policy()
    expert_parallel = pol is not None and act_sharding.expert_parallel()
    if cfg.moe_dropless:
        if expert_parallel:
            raise ValueError(f"{cfg.name}: dropless routing has no expert-parallel path")
        return _dropless(cfg, p, x, probe)
    routing = route(cfg, p, x)
    if probe is not None and probe.metrics is not None:
        _gate, e_flat, _pos, kept = routing
        probe.count_slots(torch.zeros(cfg.moe_num_experts, dtype=torch.int64, device=x.device).scatter_add_(
            0, e_flat.reshape(-1), torch.ones_like(e_flat.reshape(-1))))
        probe.count_dropped((~kept).sum())
    if expert_parallel:
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


def expert_mlp(rows: torch.Tensor, offsets: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, row_scale: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its own segment of ``rows`` [T, D]
    (sorted by expert; expert e's rows are ``offsets[e]:offsets[e + 1]``,
    ``offsets`` [E + 1] on the rows' device), each row times its
    ``row_scale`` [T]: [T, D] in the rows' dtype.  Weights ``w_gate`` /
    ``w_up`` [E, D, F], ``w_down`` [E, F, D].  One ``torch._grouped_mm`` a
    projection (float32 sums of bf16 operands), the segment ends handed
    over on the device: nothing read back.  The scale, rounded to the rows'
    dtype, weighs the SwiGLU's output before the down product, where it is
    the same product: a pass over [T, F] in one dtype, where a float32
    scale of the [T, D] output took a slower mixed-dtype pass."""
    ends = offsets[1:].to(torch.int32)
    h = F.silu(torch._grouped_mm(rows, w_gate, offs=ends)).mul_(torch._grouped_mm(rows, w_up, offs=ends))
    return torch._grouped_mm(h.mul_(row_scale.to(h.dtype)[:, None]), w_down, offs=ends)


def _dropless(cfg: ModelConfig, p: MoE, x: torch.Tensor, probe=None) -> torch.Tensor:
    """Every routed slot computed: the B*S*k slots sorted by expert (a
    stable sort, so each expert's slots keep token order), the experts'
    SwiGLUs over their segments (``expert_mlp``), each row weighed by its
    gate, each token's k rows summed, the shared MLP added.  Fixed shapes
    throughout: no slot padded, none dropped, nothing read back."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    with _span(probe, "moe_route"):
        gate, idx = top_k(cfg, p, x)
        experts, order = torch.sort(idx.reshape(-1), stable=True)  # slot j = token * k + rank
        offsets = torch.searchsorted(experts, torch.arange(e + 1, device=x.device))
        rows = x.reshape(b * s, d)[order // k]
        scale = gate.reshape(-1)[order]
    if probe is not None:
        probe.count_slots(offsets[1:] - offsets[:-1])
    with _span(probe, "moe_experts"):
        y = expert_mlp(rows, offsets, *(act_sharding.weight(p, n) for n in _EXPERT_WEIGHTS), scale)
    with _span(probe, "moe_combine"):
        back = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=x.device))
        out = y[back].view(b * s, k, d).sum(1).view(b, s, d)
    if p.shared is None:
        return out
    with _span(probe, "mlp"):
        return out + mlp_block(p.shared, x)
