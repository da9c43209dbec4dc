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
# (score tile rows, select chunk rows, default and largest small-nq
# threshold) of the compiled kernel
_geometry = (0, 0, 0, 0)


def _kernel():
    """The launcher and the kernel's score-tile and select-chunk heights
    (``BN``, ``kChunkRows``), which the segment table's offsets must use,
    and its small-nq path's threshold and the largest it takes
    (``kSmallQ``, ``kSmallQMax``)."""
    global _c_fn, _geometry
    if _c_fn is None:
        lib = _build.load("l2_topk")
        fn = lib.repro_l2_topk
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        names = ("tile_rows", "chunk_rows", "small_q", "small_q_max")
        for name in ("max_k",) + names:
            getattr(lib, f"repro_l2_topk_{name}").restype = ctypes.c_int
        if lib.repro_l2_topk_max_k() != MAX_K:
            raise RuntimeError("l2_topk: MAX_K disagrees with the compiled kernel")
        _geometry = tuple(getattr(lib, f"repro_l2_topk_{name}")() for name in names)
        _c_fn = fn
    return _c_fn, _geometry


def small_q_arg(name: str, small_q, default: int, largest: int, *, arg: str = "small_q") -> int:
    """The threshold of the byte-bound score path (nq for the scans, C for
    ``kmeans_assign``): the kernel's ``default`` or the caller's, at most
    ``largest``."""
    if small_q is None:
        return default
    if not 0 <= small_q <= largest:
        raise ValueError(f"{name}: {arg}={small_q} outside [0, {largest}]")
    return small_q


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


def pointer_align(tensors) -> int:
    """The largest power of two, at most 16, dividing every tensor's
    address (the scan kernels take 16-byte loads only where it is 16)."""
    a = 16
    for t in tensors:
        p = t.data_ptr()
        if p:
            a = min(a, p & -p)
    return a


def segment_table(bases, valids, tile_rows: int, chunk_rows: int, dev):
    """The packed int64 segment table the scan kernels read (layout in
    ``csrc/scan_common.cuh``), on ``dev``, and a dict with the total row
    count, the number of ``tile_rows``-row score tiles, the number of
    ``chunk_rows``-row select chunks (at least one per segment) and whether
    any segment spans more than one chunk."""
    rows = [int(b.shape[0]) for b in bases]
    col_off, tile_start, chunk_start = [], [], []
    total = tiles = chunks = 0
    for n in rows:
        col_off.append(total)
        tile_start.append(tiles)
        chunk_start.append(chunks)
        total += n
        tiles += -(-n // tile_rows)
        chunks += max(1, -(-n // chunk_rows))
    tile_start.append(tiles)
    chunk_start.append(chunks)
    host = torch.tensor(
        rows
        + [b.data_ptr() for b in bases]
        + [0 if v is None else v.data_ptr() for v in valids]
        + col_off
        + tile_start
        + chunk_start,
        dtype=torch.int64,
    )
    # From pinned memory the copy is queued behind the running kernels
    # instead of waiting for them, so back-to-back calls keep the card busy.
    table = host.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else host.to(dev)
    geo = {"rows": total, "tiles": tiles, "chunks": chunks,
           "multi_chunk": any(n > chunk_rows for n in rows)}
    return table, geo


def candidate_buffer(nq: int, geo: dict, k: int, dev) -> torch.Tensor:
    """The select's per-chunk candidate lists (uint64 words as int64), only
    where some segment spans more than one chunk."""
    width = geo["chunks"] * k if geo["multi_chunk"] else 1
    return torch.empty((nq, width), dtype=torch.int64, device=dev)


def l2_topk(queries, bases, valids, k: int, metric: str = "l2", *, small_q: int | None = None):
    """Per-segment top-k of one execution class.

    ``queries`` [nq, D] float32; ``bases`` a list of [n_s, D] float32
    segments; ``valids`` one [n_s] bool mask (or None = all rows) per
    segment.  Returns ``(vals [nq, S*k] float32, idx [nq, S*k] int64)``:
    block ``[:, s*k:(s+1)*k]`` holds segment ``s``'s rows in ascending L2
    distance or descending inner product, with row indices local to the
    segment.  Slots past the segment's valid rows carry (+inf for L2,
    -inf for IP, -1), and any score with ``|score| >= 1e38`` has index -1.

    ``small_q``: on the card, the nq at or below which the byte-bound score
    path runs instead of the tensor-core one (None: the kernel's measured
    default; up to 8), for timing the two paths against each other.  The
    answer is the same within ``SCORE_TOL`` either way.
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
    launch, (tile_rows, chunk_rows, small_default, small_max) = _kernel()
    small_q = small_q_arg("l2_topk", small_q, small_default, small_max)
    table, geo = segment_table(bases, valids, tile_rows, chunk_rows, dev)
    ld = max(geo["rows"], 1)
    scores = torch.empty((nq, ld), dtype=torch.float32, device=dev)
    cand = candidate_buffer(nq, geo, k, dev)
    out_v = torch.empty((nq, n_seg * k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_seg * k), dtype=torch.int64, device=dev)
    rc = launch(
        queries.data_ptr(), nq, d, table.data_ptr(), n_seg, geo["tiles"], geo["rows"],
        pointer_align([queries]), pointer_align(bases), small_q, scores.data_ptr(), ld, k,
        int(metric == "ip"), geo["chunks"], int(geo["multi_chunk"]), cand.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"l2_topk: kernel launch failed with CUDA error {rc}")
    _build.count_launch(l2_topk)
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
        if b.shape[0] == 0 or nq == 0:
            continue
        qx = queries @ b.T
        if metric == "l2":
            scores = (q_norm - 2.0 * qx) + (b * b).sum(1)[None, :]
        else:
            scores = -qx
        if v is not None:
            scores = scores.masked_fill(~v[None, :], float("inf"))
        out_v[:, s * k : (s + 1) * k], out_i[:, s * k : (s + 1) * k] = topk_select_plain(
            scores, k, metric
        )
    return out_v, out_i


def topk_select_plain(scores, k: int, metric: str = "l2"):
    """The select of :func:`l2_topk_plain` over one segment's ascending
    score keys ``scores`` [nq, n] (L2 distance, or minus the IP similarity):
    the k smallest by a stable sort, so ties break by row; slots past n hold
    (+inf L2 / -inf IP, -1), ``|score| >= 1e38`` has index -1, and IP
    scores are negated back."""
    nq, n = scores.shape
    fill = float("inf") if metric == "l2" else float("-inf")
    out_v = torch.full((nq, k), fill, dtype=torch.float32, device=scores.device)
    out_i = torch.full((nq, k), -1, dtype=torch.int64, device=scores.device)
    k_eff = min(k, n)
    vals, idx = torch.sort(scores, dim=1, stable=True)
    vals, idx = vals[:, :k_eff], idx[:, :k_eff]
    out_i[:, :k_eff] = torch.where(vals.abs() >= 1e38, -1, idx)
    out_v[:, :k_eff] = -vals if metric == "ip" else vals
    return out_v, out_i
