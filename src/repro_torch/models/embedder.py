"""Embedding extraction: the bridge between the model zoo and Manu (the
paper's §7 "embedding generation toolbox"); mirrors
``repro.models.embedder``.

Any dense decoder doubles as an embedding model: mean-pooled final hidden
states, L2-normalized.  ``Embedder`` micro-batches requests through the
model.  Unlike the reference, which returns numpy, it returns float32
rows on the model's device; ``ManuCollection.insert`` takes them as they
are and copies them to the host once, for the log backbone
(``core/request.py``).
"""

from __future__ import annotations

import torch

from . import model as M
from .config import ModelConfig


def embed_tokens(cfg: ModelConfig, params: M.Transformer, tokens: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-pooled, L2-normalized embeddings [B, d_model] (float32)."""
    h = M.hidden_states(cfg, params, tokens).float()
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

    def embed(self, token_batches, mask=None) -> torch.Tensor:
        """tokens [N, S] (numpy or a tensor) -> embeddings [N, d] on the
        model's device, in micro-batches of at most ``max_batch`` rows.
        Without a mask every token counts, as the reference's all-ones mask."""
        dev = self.device
        tokens = torch.as_tensor(token_batches).to(dev, torch.int64)
        masks = None if mask is None else torch.as_tensor(mask).to(dev)
        out = []
        with torch.no_grad():
            for lo in range(0, len(tokens), self.max_batch):
                t = tokens[lo:lo + self.max_batch]
                m = (torch.ones(t.shape, dtype=torch.int32, device=dev) if masks is None
                     else masks[lo:lo + self.max_batch])
                out.append(embed_tokens(self.cfg, self.params, t, m))
        if not out:
            return torch.empty((0, self.dim), dtype=torch.float32, device=dev)
        return torch.cat(out)
