"""Product quantization (PQ) and optimized PQ (OPQ) indexes (mirrors
``repro.index.pq``).

PQ splits each d-dim vector into ``m`` sub-vectors quantized against
per-subspace codebooks of ``ksub`` centroids; search builds per-query
lookup tables and scans the codes with the ``pq_adc_topk`` kernel, which
gathers from the table in shared memory.  OPQ learns an orthogonal rotation
before PQ-encoding (alternating Procrustes / k-means); its QR and SVD run
in numpy on the host, everything else on the index's device.  Codes live on
the device as uint8 where ``ksub <= 256`` and are saved as int32, the
reference's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.collection import Metric
from ..kernels import ops
from .base import VectorIndex, device_tensor, host_array, normalize_if_cosine
from .kmeans import _as_rows, kmeans


def train_pq_codebooks(x, m: int, ksub: int, seed: int = 0, iters: int = 15) -> torch.Tensor:
    """[m, ksub, dsub] codebooks: one k-means per subspace, seeded
    ``seed + j``."""
    x = _as_rows(x)
    n, d = x.shape
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by m={m}")
    dsub = d // m
    codebooks = torch.empty((m, ksub, dsub), dtype=torch.float32, device=x.device)
    for j in range(m):
        sub = x[:, j * dsub : (j + 1) * dsub].contiguous()
        codebooks[j], _ = kmeans(sub, ksub, max_iters=iters, seed=seed + j)
    return codebooks


def pq_encode(x, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace: [n, m] int32 codes."""
    x = _as_rows(x, codebooks.device)
    m, _ksub, dsub = codebooks.shape
    codes = torch.empty((len(x), m), dtype=torch.int32, device=x.device)
    for j in range(m):
        assign, _ = ops.kmeans_assign(x[:, j * dsub : (j + 1) * dsub], codebooks[j])
        codes[:, j] = assign.to(torch.int32)
    return codes


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    m, _ksub, dsub = codebooks.shape
    codes = codes.to(torch.int64)
    out = torch.empty((len(codes), m * dsub), dtype=torch.float32, device=codebooks.device)
    for j in range(m):
        out[:, j * dsub : (j + 1) * dsub] = codebooks[j][codes[:, j]]
    return out


def adc_tables(queries: torch.Tensor, codebooks: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Per-query ADC lookup tables [nq, m, ksub]: L2 ``(|q_m|^2 - 2 q_m.c)
    + |c|^2`` per subspace; IP / cosine the negated similarity (the scan
    takes the smallest sums)."""
    m, _ksub, dsub = codebooks.shape
    q = queries.to(torch.float32).reshape(-1, m, dsub)
    dots = torch.einsum("nmd,mkd->nmk", q, codebooks)
    if metric is Metric.L2:
        q2 = (q * q).sum(-1)
        c2 = (codebooks * codebooks).sum(-1)
        return ((q2[:, :, None] - 2.0 * dots) + c2[None, :, :]).contiguous()
    return (-dots).contiguous()


def _device_codes(codes: torch.Tensor, ksub: int) -> torch.Tensor:
    """Codes as the scan reads them: uint8 when every code fits a byte."""
    return codes.to(torch.uint8 if ksub <= 256 else torch.int32).contiguous()


class PQIndex(VectorIndex):
    KIND = "pq"

    def __init__(self, metric: Metric = Metric.L2, m: int = 8, ksub: int = 256,
                 device="cuda", **params):
        super().__init__(metric, device=device, m=m, ksub=ksub, **params)
        self.m, self.ksub = m, ksub
        self.codebooks: torch.Tensor | None = None
        self.codes: torch.Tensor | None = None

    def build(self, vectors) -> None:
        x = normalize_if_cosine(self.metric, _as_rows(vectors, self.device))
        self.codebooks = train_pq_codebooks(x, self.m, self.ksub)
        self.codes = _device_codes(pq_encode(x, self.codebooks), self.ksub)
        self.num_rows = len(x)

    def _queries(self, queries) -> torch.Tensor:
        return normalize_if_cosine(self.metric, _as_rows(queries, self.device))

    def search(self, queries, k, valid=None):
        luts = adc_tables(self._queries(queries), self.codebooks, self.metric)
        vals, idx = ops.pq_adc_topk(luts, self.codes, k, valid=valid)
        if self.metric is not Metric.L2:
            vals = -vals  # back to similarity scale
        return vals, idx

    def _state(self):
        return {
            "codebooks": host_array(self.codebooks),
            "codes": host_array(self.codes).astype(np.int32),
        }

    def _load_state(self, state):
        self.codebooks = device_tensor(state["codebooks"], self.device, torch.float32)
        self.m, self.ksub = self.codebooks.shape[0], self.codebooks.shape[1]
        self.codes = _device_codes(device_tensor(state["codes"], self.device), self.ksub)
        self.num_rows = len(self.codes)


def train_opq_rotation(
    x, m: int, ksub: int, iters: int = 5, seed: int = 0
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Alternating optimization of rotation R and PQ codebooks (OPQ); the
    random start, QR and SVD are numpy on the host."""
    x = _as_rows(x)
    d = x.shape[1]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)).astype(np.float32)
    r_np, _ = np.linalg.qr(a)
    r = torch.from_numpy(np.ascontiguousarray(r_np)).to(x.device)
    codebooks = None
    for _ in range(iters):
        xr = x @ r
        codebooks = train_pq_codebooks(xr, m, ksub, seed=seed, iters=8)
        recon = pq_decode(pq_encode(xr, codebooks), codebooks)
        # Procrustes: R = argmin |xR - recon|  =>  SVD of x^T recon
        u, _s, vt = np.linalg.svd((x.T @ recon).cpu().numpy(), full_matrices=False)
        r = torch.from_numpy((u @ vt).astype(np.float32)).to(x.device)
    return r, codebooks


class OPQIndex(PQIndex):
    KIND = "opq"

    def __init__(self, metric: Metric = Metric.L2, m: int = 8, ksub: int = 256,
                 device="cuda", **params):
        super().__init__(metric, m=m, ksub=ksub, device=device, **params)
        self.rotation: torch.Tensor | None = None

    def build(self, vectors) -> None:
        x = normalize_if_cosine(self.metric, _as_rows(vectors, self.device))
        self.rotation, self.codebooks = train_opq_rotation(x, self.m, self.ksub)
        self.codes = _device_codes(pq_encode(x @ self.rotation, self.codebooks), self.ksub)
        self.num_rows = len(x)

    def _queries(self, queries) -> torch.Tensor:
        return (super()._queries(queries) @ self.rotation).contiguous()

    def _state(self):
        s = super()._state()
        s["rotation"] = host_array(self.rotation)
        return s

    def _load_state(self, state):
        super()._load_state({k: v for k, v in state.items() if k != "rotation"})
        self.rotation = device_tensor(state["rotation"], self.device, torch.float32)
