"""Top-k merge with pk dedup: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``src/repro/kernels/merge_topk.py:merge_topk_pallas`` and holds to
the host merge ``src/repro/kernels/ops.py:merge_topk`` (int64 pks).  See
``csrc/merge_topk.cu`` for the kernel's design and what bounds it.  For CPU
tensors the wrapper runs :func:`merge_topk_plain`; for CUDA tensors it
launches the kernel or raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Largest pool width the kernel takes (``kMaxM`` in ``csrc/merge_topk.cu``).
MAX_M = 8192

_c_fn = None


def _kernel():
    global _c_fn
    if _c_fn is None:
        lib = _build.load("merge_topk")
        fn = lib.repro_merge_topk
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.repro_merge_topk_max_m.restype = ctypes.c_int
        if lib.repro_merge_topk_max_m() != MAX_M:
            raise RuntimeError("merge_topk: MAX_M disagrees with the compiled kernel")
        _c_fn = fn
    return _c_fn


def merge_topk(scores, pks, k: int, metric: str = "l2"):
    """Merge pooled candidates ``scores``/``pks`` [nq, M] (float32 / int64,
    pk < 0 = empty slot) into the per-query top-k, keeping each pk's best
    occurrence.  Candidates with pk < 0 or a non-finite score are dropped;
    ties break by pool column.  Returns ``(scores [nq, k], pks [nq, k])``
    with missing slots at (+inf for L2, -inf for IP, -1)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"merge_topk: unknown metric {metric!r}")
    if k < 1:
        raise ValueError(f"merge_topk: k={k} must be >= 1")
    if (
        scores.dim() != 2 or scores.shape != pks.shape
        or scores.dtype != torch.float32 or pks.dtype != torch.int64
        or not scores.is_contiguous() or not pks.is_contiguous()
        or scores.device != pks.device
    ):
        raise ValueError(
            "merge_topk: scores/pks must be contiguous [nq, M] float32/int64 "
            "tensors on one device"
        )
    nq, m = scores.shape
    if scores.device.type == "cpu":
        return merge_topk_plain(scores, pks, k, metric)
    if scores.device.type != "cuda":
        raise ValueError(f"merge_topk: unsupported device {scores.device}")
    if m > MAX_M:
        raise ValueError(f"merge_topk: pool width {m} above the kernel's limit {MAX_M}")
    dev = scores.device
    if nq == 0 or m == 0:
        fill = float("inf") if metric == "l2" else float("-inf")
        return (
            torch.full((nq, k), fill, dtype=torch.float32, device=dev),
            torch.full((nq, k), -1, dtype=torch.int64, device=dev),
        )
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, k), dtype=torch.int64, device=dev)
    rc = _kernel()(
        scores.data_ptr(), pks.data_ptr(), nq, m, k, int(metric == "ip"),
        out_v.data_ptr(), out_p.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"merge_topk: kernel launch failed with CUDA error {rc}")
    _build.count_launch(merge_topk)
    return out_v, out_p


merge_topk.launches = 0


def merge_topk_plain(scores, pks, k: int, metric: str = "l2"):
    """Plain PyTorch version of :func:`merge_topk` (same contract), built
    from stable sorts: by key, then by pk (each pk's best occurrence comes
    first in its group), then by key again over the survivors."""
    nq, m = scores.shape
    dev = scores.device
    fill = float("inf") if metric == "l2" else float("-inf")
    if nq == 0 or m == 0:
        return (
            torch.full((nq, k), fill, dtype=torch.float32, device=dev),
            torch.full((nq, k), -1, dtype=torch.int64, device=dev),
        )
    alive = (pks >= 0) & torch.isfinite(scores)
    key = torch.where(alive, scores if metric == "l2" else -scores, float("inf")) + 0.0
    by_key = torch.sort(key, dim=1, stable=True).indices
    by_pk = torch.sort(pks.gather(1, by_key), dim=1, stable=True).indices
    order = by_key.gather(1, by_pk)
    grouped = pks.gather(1, order)
    first = torch.ones_like(grouped, dtype=torch.bool)
    first[:, 1:] = grouped[:, 1:] != grouped[:, :-1]
    best = torch.zeros_like(alive).scatter_(1, order, first)
    live = alive & best
    sel = torch.sort(torch.where(live, key, float("inf")), dim=1, stable=True).indices
    sel = sel[:, : min(k, m)]
    ok = live.gather(1, sel)
    out_s = torch.where(ok, scores.gather(1, sel), fill)
    out_p = torch.where(ok, pks.gather(1, sel), -1)
    if m < k:
        out_s = torch.cat([out_s, torch.full((nq, k - m), fill, dtype=torch.float32, device=dev)], 1)
        out_p = torch.cat([out_p, torch.full((nq, k - m), -1, dtype=torch.int64, device=dev)], 1)
    return out_s, out_p
