"""FLAT (exact brute-force) index (mirrors ``repro.index.flat.FlatIndex``).

``SQIndex`` needs the SQ kernels and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.collection import Metric
from ..kernels import ops
from .base import VectorIndex, normalize_if_cosine, scan_metric


class FlatIndex(VectorIndex):
    KIND = "flat"

    def __init__(self, metric: Metric = Metric.L2, device="cuda", **params):
        super().__init__(metric, device=device, **params)
        self.vectors: torch.Tensor | None = None

    def build(self, vectors) -> None:
        x = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        self.vectors = normalize_if_cosine(self.metric, x).contiguous()
        self.num_rows = len(self.vectors)

    def search(self, queries, k, valid=None):
        q = normalize_if_cosine(self.metric, queries.to(self.device, torch.float32)).contiguous()
        return ops.topk_scan(q, self.vectors, k, metric=scan_metric(self.metric), valid=valid)

    @classmethod
    def search_batched(cls, indexes, queries, k: int, valids=None):
        """All FLAT indexes of one spec in ONE segmented scan: block ``u``
        is exactly ``indexes[u].search(queries, k, valids[u])``."""
        if not indexes:
            return super().search_batched(indexes, queries, k, valids)
        head = indexes[0]
        q = normalize_if_cosine(head.metric, queries.to(head.device, torch.float32)).contiguous()
        s, i = ops.topk_scan_segmented(
            q, [ix.vectors for ix in indexes], k, metric=scan_metric(head.metric),
            valids=valids,
        )
        return s, i, [u * k for u in range(len(indexes) + 1)]

    def _state(self):
        return {"vectors": self.vectors.cpu().numpy()}

    def _load_state(self, state):
        self.vectors = torch.from_numpy(np.ascontiguousarray(state["vectors"], np.float32)).to(
            self.device
        )
        self.num_rows = len(self.vectors)
