"""FLAT (exact brute-force) and SQ-compressed flat indexes (mirrors
``repro.index.flat``).

FLAT scans float32 rows with the ``l2_topk`` kernel; SQ keeps uint8 codes
on the device and scans them with the ``sq_l2_topk`` kernel, which
dequantizes in registers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.collection import Metric
from ..kernels import ops
from .base import VectorIndex, device_tensor, host_array, normalize_if_cosine, scan_metric


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


class SQIndex(VectorIndex):
    """Scalar-quantized flat index: 4x fewer bytes, distances on codes."""

    KIND = "sq"

    def __init__(self, metric: Metric = Metric.L2, device="cuda", **params):
        super().__init__(metric, device=device, **params)
        self.codes: torch.Tensor | None = None  # [n, d] uint8
        self.vmin: torch.Tensor | None = None
        self.vmax: torch.Tensor | None = None

    def build(self, vectors) -> None:
        x = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        x = normalize_if_cosine(self.metric, x).contiguous()
        if len(x):
            self.vmin, self.vmax = x.min(dim=0).values, x.max(dim=0).values
        else:
            self.vmin = torch.zeros(x.shape[1], dtype=torch.float32, device=self.device)
            self.vmax = torch.ones(x.shape[1], dtype=torch.float32, device=self.device)
        self.codes = ops.sq_encode(x, self.vmin, self.vmax)
        self.num_rows = len(x)

    def search(self, queries, k, valid=None):
        q = normalize_if_cosine(self.metric, queries.to(self.device, torch.float32)).contiguous()
        return ops.sq_topk_scan(
            q, self.codes, self.vmin, self.vmax, k, metric=scan_metric(self.metric), valid=valid,
        )

    def _state(self):
        return {
            "codes": host_array(self.codes),
            "vmin": host_array(self.vmin),
            "vmax": host_array(self.vmax),
        }

    def _load_state(self, state):
        self.codes = device_tensor(state["codes"], self.device, torch.uint8)
        self.vmin = device_tensor(state["vmin"], self.device, torch.float32)
        self.vmax = device_tensor(state["vmax"], self.device, torch.float32)
        self.num_rows = len(self.codes)
