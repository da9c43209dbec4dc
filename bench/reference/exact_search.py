"""Plain exact top-k: the reference the search answers are held to.

float64 products over the rows in blocks, so it fits beside nothing else
on the card once the program's state is freed.  The rows and queries are
the benchmark's own inputs; the reference normalizes them itself for
COSINE.  ``precision="tf32"`` is the control: the same top-k from float32
inputs rounded to TF32's 10-bit mantissa (what a tensor-core TF32 product
reads), products of those exact in float32, summed in float32.  It
imports nothing of the program.
"""

from __future__ import annotations

import torch

LARGER_IS_BETTER = {"l2": False, "ip": True, "cosine": True}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _prep(x: torch.Tensor, metric: str, precision: str) -> torch.Tensor:
    if precision == "float64":
        x = x.double()
        if metric == "cosine":
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x
    x = x.float()
    if metric == "cosine":
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return to_tf32(x)


def _block_scores(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Goodness of every (query, row): the similarity for IP and COSINE,
    the squared L2 distance for L2 (smaller is better)."""
    if metric == "l2":
        return (q * q).sum(1, keepdim=True) - 2 * (q @ x.T) + (x * x).sum(1)[None, :]
    return q @ x.T


def topk(queries: torch.Tensor, rows: torch.Tensor, k: int, metric: str,
         exclude: torch.Tensor | None = None, block: int = 65_536,
         precision: str = "float64") -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``rows`` for each query, leaving out the row indices
    in ``exclude``: (scores [nq, k] in the metric's order, row indices
    [nq, k]); float64 scores, float32 for the control."""
    larger = LARGER_IS_BETTER[metric]
    q = _prep(queries, metric, precision)
    dead = None
    if exclude is not None and exclude.numel():
        dead = torch.zeros(len(rows), dtype=torch.bool, device=rows.device)
        dead[exclude] = True
    fill = float("-inf") if larger else float("inf")
    best_s = best_i = None
    for lo in range(0, len(rows), block):
        x = _prep(rows[lo:lo + block], metric, precision)
        s = _block_scores(q, x, metric)
        if dead is not None:
            s[:, dead[lo:lo + block]] = fill
        kk = min(k, s.shape[1])
        bs, bi = torch.topk(s, kk, dim=1, largest=larger)
        bi = bi + lo
        if best_s is not None:
            bs, pick = torch.topk(torch.cat([best_s, bs], 1), min(k, best_s.shape[1] + kk),
                                  dim=1, largest=larger)
            bi = torch.gather(torch.cat([best_i, bi], 1), 1, pick)
        best_s, best_i = bs, bi
    return best_s, best_i


def scores_of(queries: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor, metric: str) -> torch.Tensor:
    """float64 goodness of row ``idx[i, j]`` for query ``i`` (idx >= 0)."""
    q = _prep(queries, metric, "float64")
    x = _prep(rows[idx.clamp_min(0).reshape(-1)], metric, "float64").view(*idx.shape, -1)
    if metric == "l2":
        return ((x - q[:, None, :]) ** 2).sum(-1)
    return (x * q[:, None, :]).sum(-1)
