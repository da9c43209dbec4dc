"""AdamW and global-norm gradient clipping; mirrors ``repro.train.optimizer``.

Plain functions on dicts of tensors keyed by the port's ``state_dict``
names (``dict(model.named_parameters())``).  The arithmetic is the
reference's, step for step: float32 moments ``m`` / ``v``, an int ``step``,
the warm-up schedule and the bias corrections in float32, the update in
float32 and a cast back to each parameter's dtype (bf16; the MoE router and
the SSM's ``a_log`` / ``d_skip`` / ``dt_bias`` float32).  Not
``torch.optim.AdamW``, whose update order differs.  The reference returns
new trees; ``adamw_update`` writes the parameters and moments in place (the
parameters are the model's own tensors, and a second copy of the moments
would double the optimizer's memory) and returns them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Tensors = dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: Tensors) -> dict:
    """``{"step": 0, "m": zeros, "v": zeros}``, the moments float32 on each
    parameter's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": 0, "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()}}


def opt_state_shape(params: Tensors) -> dict:
    """``init_opt_state`` on the meta device: shapes and dtypes, no memory."""
    return init_opt_state({k: p.to("meta") for k, p in params.items()})


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    total = sum((g.float() ** 2).sum() for g in tree.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> tuple[Tensors, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm) (the scale cast to the
    leaf's dtype, as the reference); returns (new leaves, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def lr_schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``, in float32."""
    warm = min(np.float32(1.0), (np.float32(step) + np.float32(1.0)) / np.float32(cfg.warmup_steps))
    return np.float32(cfg.lr) * np.float32(warm)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors, opt_state: dict) -> tuple[Tensors, dict]:
    """One AdamW step with decoupled weight decay.  Writes ``params`` and
    ``opt_state``'s moments in place and advances its step; returns both."""
    step = opt_state["step"] + 1
    lr = float(lr_schedule(cfg, step))
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for name, p in params.items():
        gf = grads[name].float()
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf * (1 - b2) * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state
