"""The training step; mirrors ``repro.launch.steps.build_train_cell``.

The reference builds each (arch x shape) cell for a TPU mesh: the step
function with its input shardings, structs and donated arguments.  Here a
cell is the step function alone, on one device; the mesh, the shardings
and the prefill / decode cells wait for ROADMAP Queue 1 item 4, step 7.
"""

from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..train.optimizer import AdamWConfig, adamw_update, clip_by_global_norm


def accumulate_grads(cfg: ModelConfig, params: M.Transformer, batch: dict, microbatches: int = 1,
                     remat: bool = True, seq_chunk: int = 1_024) -> tuple[torch.Tensor, dict]:
    """``(loss, {state_dict name: gradient})`` of ``lm_loss`` over ``batch``
    (``tokens``, ``labels`` and, for the VLM stub, ``prefix_embeds``); the
    model's parameters are made trainable.

    ``microbatches`` > 1 splits the batch into that many equal slices, run
    one after another, their gradients summed in float32 as ``g / n``; the
    loss is the mean of theirs.  Live activations shrink by ~n."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())

    def loss_and_grads(mb: dict):
        loss = M.lm_loss(cfg, params, mb["tokens"], mb["labels"], mb.get("prefix_embeds"),
                         remat=remat, seq_chunk=seq_chunk)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(named.items(), grads)}

    if microbatches <= 1:
        return loss_and_grads(batch)
    n = microbatches
    rows = batch["tokens"].shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named.items()}
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    for i in range(n):
        mb = {k: v[i * rows // n:(i + 1) * rows // n] for k, v in batch.items() if v is not None}
        mb_loss, g = loss_and_grads(mb)
        for k, gi in g.items():
            grads[k] += gi.float() / n
        loss = loss + mb_loss / n
    return loss, grads


def build_train_cell(cfg: ModelConfig, adamw: AdamWConfig | None = None, remat: bool = True,
                     microbatches: int = 1, seq_chunk: int = 1_024):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``lm_loss`` and its gradients
    (``accumulate_grads``, over ``microbatches`` slices), global-norm
    clipping, one AdamW update (in place on the model's parameters and
    the moments).  ``params`` is the model (``models.model.Transformer``)."""
    adamw = adamw or AdamWConfig()

    def train_step(params: M.Transformer, opt_state: dict, batch: dict):
        loss, grads = accumulate_grads(cfg, params, batch, microbatches, remat, seq_chunk)
        grads, gnorm = clip_by_global_norm(grads, adamw.grad_clip)
        adamw_update(adamw, dict(params.named_parameters()), grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
