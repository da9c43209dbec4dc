"""Segmented brute-force top-k scan: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``src/repro/kernels/l2_topk.py:l2_topk_pallas``.  One call scans
every segment of one execution class and returns a per-segment top-k
block; see ``csrc/l2_topk.cu`` and ``csrc/scan_common.cuh`` for the
kernel's design and what bounds it.
For CPU tensors the wrapper runs :func:`l2_topk_plain`; for CUDA tensors it
launches the kernel or raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: Largest k the kernel takes (``kMaxK`` in ``csrc/l2_topk.cu``).
MAX_K = 1024
_MAX_GRID_Y = 65535

_c_fn = None
_tile_rows = 0  # base rows per score tile, as the compiled kernel reports


def _kernel():
    """The launcher and the kernel's tile height (``BN``), which the segment
    table's tile offsets must use."""
    global _c_fn, _tile_rows
    if _c_fn is None:
        lib = _build.load("l2_topk")
        fn = lib.repro_l2_topk
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.repro_l2_topk_max_k.restype = ctypes.c_int
        lib.repro_l2_topk_tile_rows.restype = ctypes.c_int
        if lib.repro_l2_topk_max_k() != MAX_K:
            raise RuntimeError("l2_topk: MAX_K disagrees with the compiled kernel")
        _tile_rows = lib.repro_l2_topk_tile_rows()
        _c_fn = fn
    return _c_fn, _tile_rows


def _check(queries, bases, valids, k: int, metric: str) -> None:
    if metric not in ("l2", "ip"):
        raise ValueError(f"l2_topk: unknown metric {metric!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk: k={k} outside [1, {MAX_K}]")
    if queries.dim() != 2 or queries.dtype != torch.float32 or not queries.is_contiguous():
        raise ValueError("l2_topk: queries must be a contiguous [nq, D] float32 tensor")
    if len(valids) != len(bases):
        raise ValueError("l2_topk: one valid mask (or None) per segment")
    d = queries.shape[1]
    for b, v in zip(bases, valids):
        if b.dim() != 2 or b.shape[1] != d or b.dtype != torch.float32:
            raise ValueError(f"l2_topk: segment must be [n, {d}] float32, got {tuple(b.shape)} {b.dtype}")
        if not b.is_contiguous() or b.device != queries.device:
            raise ValueError("l2_topk: segments must be contiguous and on the queries' device")
        if b.shape[0] >= 2**31:
            raise ValueError("l2_topk: a segment holds at most 2**31 - 1 rows")
        if v is not None and (
            v.dtype != torch.bool or v.shape != (b.shape[0],)
            or not v.is_contiguous() or v.device != queries.device
        ):
            raise ValueError("l2_topk: valid masks must be contiguous [n] bool tensors")


def segment_table(bases, valids, tile_rows: int, dev):
    """The packed int64 segment table the scan kernels read (layout in
    ``csrc/scan_common.cuh``), on ``dev``, with the total row count and the
    number of ``tile_rows``-row score tiles."""
    rows = [int(b.shape[0]) for b in bases]
    col_off, tile_start, total, tiles = [], [], 0, 0
    for n in rows:
        col_off.append(total)
        tile_start.append(tiles)
        total += n
        tiles += -(-n // tile_rows)
    tile_start.append(tiles)
    table = torch.tensor(
        rows
        + [b.data_ptr() for b in bases]
        + [0 if v is None else v.data_ptr() for v in valids]
        + col_off
        + tile_start,
        dtype=torch.int64,
    ).to(dev)
    return table, total, tiles


def l2_topk(queries, bases, valids, k: int, metric: str = "l2"):
    """Per-segment top-k of one execution class.

    ``queries`` [nq, D] float32; ``bases`` a list of [n_s, D] float32
    segments; ``valids`` one [n_s] bool mask (or None = all rows) per
    segment.  Returns ``(vals [nq, S*k] float32, idx [nq, S*k] int64)``:
    block ``[:, s*k:(s+1)*k]`` holds segment ``s``'s rows in ascending L2
    distance or descending inner product, with row indices local to the
    segment.  Slots past the segment's valid rows carry (+inf for L2,
    -inf for IP, -1), and any score with ``|score| >= 1e38`` has index -1.
    """
    _check(queries, bases, valids, k, metric)
    if queries.device.type == "cpu":
        return l2_topk_plain(queries, bases, valids, k, metric)
    if queries.device.type != "cuda":
        raise ValueError(f"l2_topk: unsupported device {queries.device}")
    nq, d = queries.shape
    n_seg = len(bases)
    dev = queries.device
    if nq == 0 or n_seg == 0:
        fill = float("inf") if metric == "l2" else float("-inf")
        return (
            torch.full((nq, n_seg * k), fill, dtype=torch.float32, device=dev),
            torch.full((nq, n_seg * k), -1, dtype=torch.int64, device=dev),
        )
    if nq > _MAX_GRID_Y:
        raise ValueError(f"l2_topk: at most {_MAX_GRID_Y} queries per call, got {nq}")
    launch, tile_rows = _kernel()
    table, total, tiles = segment_table(bases, valids, tile_rows, dev)
    scores = torch.empty((nq, max(total, 1)), dtype=torch.float32, device=dev)
    out_v = torch.empty((nq, n_seg * k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_seg * k), dtype=torch.int64, device=dev)
    rc = launch(
        queries.data_ptr(), nq, d, table.data_ptr(), n_seg, tiles,
        scores.data_ptr(), max(total, 1), k, int(metric == "ip"),
        out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"l2_topk: kernel launch failed with CUDA error {rc}")
    l2_topk.launches += 1
    return out_v, out_i


l2_topk.launches = 0


def l2_topk_plain(queries, bases, valids, k: int, metric: str = "l2"):
    """Plain PyTorch version of :func:`l2_topk` (same contract).

    Scores use the host reference's expression ``(|q|^2 - 2 q.x) + |x|^2``
    in float32; a stable sort breaks ties by row index, as the kernel does.
    """
    nq = queries.shape[0]
    n_seg = len(bases)
    fill = float("inf") if metric == "l2" else float("-inf")
    out_v = torch.full((nq, n_seg * k), fill, dtype=torch.float32, device=queries.device)
    out_i = torch.full((nq, n_seg * k), -1, dtype=torch.int64, device=queries.device)
    q_norm = (queries * queries).sum(1, keepdim=True) if metric == "l2" else None
    for s, (b, v) in enumerate(zip(bases, valids)):
        n = b.shape[0]
        if n == 0 or nq == 0:
            continue
        qx = queries @ b.T
        if metric == "l2":
            scores = (q_norm - 2.0 * qx) + (b * b).sum(1)[None, :]
        else:
            scores = -qx
        if v is not None:
            scores = scores.masked_fill(~v[None, :], float("inf"))
        k_eff = min(k, n)
        vals, idx = torch.sort(scores, dim=1, stable=True)
        vals, idx = vals[:, :k_eff], idx[:, :k_eff]
        idx = torch.where(vals.abs() >= 1e38, -1, idx)
        if metric == "ip":
            vals = -vals
        out_v[:, s * k : s * k + k_eff] = vals
        out_i[:, s * k : s * k + k_eff] = idx
    return out_v, out_i
