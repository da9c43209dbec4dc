"""Lloyd k-means on top of the ``kmeans_assign`` kernel (mirrors
``repro.index.kmeans``).

Used by the IVF coarse quantizer, PQ codebook training and the query
node's interim slice indexes.  Every random draw comes from
``np.random.default_rng(seed)`` on the host, in the reference's order, and
the k-means++ seeding runs in numpy on a <= 4,096-row host sample, so both
packages seed from the same rows.  The Lloyd iterations run on the data's
device: the E-step through ``ops.kmeans_assign``, the M-step as a one-hot
product, which (unlike ``index_add_`` on CUDA floats) is deterministic, so
two builds from one seed give the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import ops


def _as_rows(x, device=None) -> torch.Tensor:
    """Rows as a contiguous float32 tensor on ``device``; with no device
    given, a tensor stays where it is and host data goes to the card (the
    port's default), which raises when there is none."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
        device = resolve_device("cuda" if device is None else device)
    if device is not None:
        x = x.to(device)
    return x.to(torch.float32).contiguous()


def _host_rows(x: torch.Tensor, rows: np.ndarray | None = None) -> np.ndarray:
    sel = x if rows is None else x[torch.from_numpy(rows).to(x.device)]
    return sel.cpu().numpy()


def kmeanspp_seed(x, k: int, rng: np.random.Generator, sample_cap: int = 4096) -> np.ndarray:
    """D^2-weighted seeding on a subsample (full k-means++ is O(nk)); the
    sample comes to the host and the seeding is the reference's numpy."""
    n = len(x)
    if n > sample_cap:
        xs = _host_rows(x, rng.choice(n, sample_cap, replace=False))
        n = sample_cap
    else:
        xs = _host_rows(x)
    centroids = np.empty((k, xs.shape[1]), np.float32)
    centroids[0] = xs[rng.integers(n)]
    d2 = np.sum((xs - centroids[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centroids[i] = xs[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((xs - centroids[i]) ** 2, axis=1))
    return centroids


def _cluster_sums(assign: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """Per-cluster row sums as a one-hot product: [k, n] @ [n, d]."""
    onehot = (assign[None, :] == torch.arange(k, device=rows.device)[:, None]).to(rows.dtype)
    return onehot @ rows


def kmeans(
    x, k: int, max_iters: int = 25, seed: int = 0, tol: float = 1e-4,
    sample_cap: int = 100_000,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Lloyd iterations on ``x``'s device; returns (centroids [k, d]
    float32, assignments [n] int64) as tensors there.  Training runs on a
    subsample; the final assignment covers all rows."""
    x = _as_rows(x)
    n = len(x)
    if n == 0:
        raise ValueError("kmeans on empty data")
    k = min(k, n)
    rng = np.random.default_rng(seed)

    if n <= sample_cap:
        train = x
    else:
        train = x[torch.from_numpy(rng.choice(n, sample_cap, replace=False)).to(x.device)]
    centroids = torch.from_numpy(kmeanspp_seed(train, k, rng)).to(x.device)

    prev_inertia = np.inf
    for _ in range(max_iters):
        assign, d2 = ops.kmeans_assign(train, centroids)
        inertia = float(d2.sum())
        counts = torch.bincount(assign, minlength=k).to(torch.float32)
        sums = _cluster_sums(assign, train, k)
        nonempty = counts > 0
        centroids = torch.where(
            nonempty[:, None], sums / counts.clamp(min=1)[:, None], centroids
        )
        # Re-seed empty clusters from the farthest points (stable order).
        n_empty = int((~nonempty).sum())
        if n_empty:
            far = torch.sort(d2, descending=True, stable=True).indices[:n_empty]
            centroids[~nonempty] = train[far]
        centroids = centroids.contiguous()
        if prev_inertia - inertia <= tol * max(prev_inertia, 1e-12):
            break
        prev_inertia = inertia

    assign_full, _ = ops.kmeans_assign(x, centroids)
    return centroids, assign_full


def balanced_kmeans(
    x, target_cluster_size: int, max_cluster_size: int, seed: int = 0, max_depth: int = 8,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Hierarchical k-means with bounded cluster sizes: clusters larger than
    ``max_cluster_size`` are split recursively.  Returns (centroids [B, d],
    assignments [n] -> bucket id) as tensors on ``x``'s device."""
    x = _as_rows(x)
    n = len(x)
    k0 = max(1, int(round(n / max(target_cluster_size, 1))))
    centroids, assign = kmeans(x, k0, seed=seed)

    final_centroids: list[torch.Tensor] = []
    final_assign = torch.full((n,), -1, dtype=torch.int64, device=x.device)

    stack: list[tuple[torch.Tensor, int]] = []  # (row indices, depth)
    for c in range(len(centroids)):
        stack.append((torch.nonzero(assign == c).squeeze(1), 0))

    while stack:
        rows, depth = stack.pop()
        if len(rows) == 0:
            continue
        if len(rows) <= max_cluster_size or depth >= max_depth or len(rows) <= 1:
            final_assign[rows] = len(final_centroids)
            final_centroids.append(x[rows].mean(dim=0))
            continue
        sub_k = max(2, int(np.ceil(len(rows) / target_cluster_size)))
        sub_c, sub_a = kmeans(x[rows], sub_k, seed=seed + depth + len(rows))
        for c in range(len(sub_c)):
            stack.append((rows[sub_a == c], depth + 1))

    return torch.stack(final_centroids).to(torch.float32), final_assign
