"""Embedding extraction: the bridge between the model zoo and Manu (the
paper's §7 "embedding generation toolbox"); mirrors
``repro.models.embedder``.

Any dense decoder doubles as an embedding model: mean-pooled final hidden
states, L2-normalized.  ``Embedder`` micro-batches requests through the
model.  Unlike the reference, which returns numpy, it returns float32
rows on the model's device; ``ManuCollection.insert`` takes them as they
are and copies them to the host once, for the log backbone
(``core/request.py``).  Given a ``TraceContext`` or a ``MetricsRegistry``,
``Embedder.embed`` times each micro-batch (a ``micro_batch`` span, its
layers' spans beneath) and counts the MoE routing (``models/probe.py``).
"""

from __future__ import annotations

import contextlib

import torch

from . import model as M
from .config import ModelConfig
from .probe import ForwardProbe


def embed_tokens(cfg: ModelConfig, params: M.Transformer, tokens: torch.Tensor,
                 mask: torch.Tensor | None = None, probe: ForwardProbe | None = None) -> torch.Tensor:
    """Mean-pooled, L2-normalized embeddings [B, d_model] (float32)."""
    h = M.hidden_states(cfg, params, tokens, probe=probe).float()
    if mask is None:
        pooled = h.mean(1)
    else:
        w = mask.float()[..., None]
        pooled = (h * w).sum(1) / w.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


class Embedder:
    def __init__(self, cfg: ModelConfig, params: M.Transformer, max_batch: int = 32):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch

    @property
    def dim(self) -> int:
        return self.cfg.d_model

    @property
    def device(self) -> torch.device:
        return self.params.device

    def embed(self, token_batches, mask=None, trace=None, metrics=None) -> torch.Tensor:
        """tokens [N, S] (numpy or a tensor) -> embeddings [N, d] on the
        model's device, in micro-batches of at most ``max_batch`` rows.
        Without a mask every token counts, as the reference's all-ones mask.
        ``trace`` (a ``TraceContext``) gets a device-timed ``micro_batch``
        span per micro-batch with its sublayers' spans beneath; ``metrics``
        (a ``MetricsRegistry``) the routing counts.  Neither reads the card
        back."""
        dev = self.device
        tokens = torch.as_tensor(token_batches).to(dev, torch.int64)
        masks = None if mask is None else torch.as_tensor(mask).to(dev)
        out = []
        with torch.no_grad():
            for lo in range(0, len(tokens), self.max_batch):
                t = tokens[lo:lo + self.max_batch]
                m = (torch.ones(t.shape, dtype=torch.int32, device=dev) if masks is None
                     else masks[lo:lo + self.max_batch])
                if trace is None and metrics is None:
                    out.append(embed_tokens(self.cfg, self.params, t, m))
                    continue
                parent = None if trace is None else trace.span("micro_batch", detail=f"rows={len(t)}")
                probe = ForwardProbe(trace, parent, metrics, dev)
                with contextlib.nullcontext() if trace is None else trace.timed(parent, dev):
                    out.append(embed_tokens(self.cfg, self.params, t, m, probe))
                probe.flush()
        if not out:
            return torch.empty((0, self.dim), dtype=torch.float32, device=dev)
        return torch.cat(out)
