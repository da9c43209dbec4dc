"""PQ asymmetric-distance (ADC) top-k scan: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``src/repro/kernels/pq_adc.py:pq_adc_topk_pallas`` and holds to the
host path of ``src/repro/kernels/ops.py:pq_adc_topk``; see
``csrc/pq_adc.cu`` for the kernel's design and what bounds it.  For CPU
tensors the wrapper runs :func:`pq_adc_topk_plain`; for CUDA tensors it
launches the kernel or raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .l2_topk import _MAX_GRID_Y, candidate_buffer, pointer_align, segment_table

#: Largest k the scan takes (``kMaxK`` in ``csrc/scan_common.cuh``).
MAX_K = 1024
#: Largest per-query table (m * ksub * 4 bytes) one block holds in shared
#: memory on sm_90.
MAX_LUT_BYTES = 232_448

_c_fn = None
_chunk_rows = 0  # select chunk height of the compiled kernel


def _kernel():
    global _c_fn, _chunk_rows
    if _c_fn is None:
        lib = _build.load("pq_adc")
        fn = lib.repro_pq_adc_topk
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.repro_pq_adc_max_k.restype = ctypes.c_int
        lib.repro_pq_adc_max_lut_bytes.restype = ctypes.c_int
        lib.repro_pq_adc_chunk_rows.restype = ctypes.c_int
        if lib.repro_pq_adc_max_k() != MAX_K or lib.repro_pq_adc_max_lut_bytes() != MAX_LUT_BYTES:
            raise RuntimeError("pq_adc_topk: limits disagree with the compiled kernel")
        _chunk_rows = lib.repro_pq_adc_chunk_rows()
        _c_fn = fn
    return _c_fn, _chunk_rows


def query_group(nq: int, m: int, ksub: int) -> int:
    """Queries one block of the score pass serves: the G in 4, 2, 1 whose G
    tables (G * m * ksub * 4 bytes) fit in ``MAX_LUT_BYTES`` of shared
    memory, and no more than ``nq`` rounded up to a power of two needs."""
    for g in (4, 2):
        if g < 2 * nq and g * 4 * m * ksub <= MAX_LUT_BYTES:
            return g
    return 1


def pq_adc_topk(luts, codes, k: int, valid=None):
    """ADC top-k: ``dist[q, r] = sum_m luts[q, m, codes[r, m]]``, summed over
    m = 0..M-1 in order.  ``luts`` [nq, M, KSUB] float32; ``codes`` [n, M]
    uint8 or int32 with values in [0, KSUB); ``valid`` [n] bool or None.
    Returns ``(vals [nq, k] float32 ascending, idx [nq, k] int64)``; slots
    past the valid rows carry (+inf, -1) and ``|dist| >= 1e38`` has index
    -1."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pq_adc_topk: k={k} outside [1, {MAX_K}]")
    if luts.dim() != 3 or luts.dtype != torch.float32 or not luts.is_contiguous():
        raise ValueError("pq_adc_topk: luts must be a contiguous [nq, M, KSUB] float32 tensor")
    nq, m, ksub = luts.shape
    if (
        codes.dim() != 2 or codes.shape[1] != m
        or codes.dtype not in (torch.uint8, torch.int32)
        or not codes.is_contiguous() or codes.device != luts.device
    ):
        raise ValueError(f"pq_adc_topk: codes must be a contiguous [n, {m}] uint8/int32 tensor")
    if codes.shape[0] >= 2**31:
        raise ValueError("pq_adc_topk: at most 2**31 - 1 rows")
    if valid is not None and (
        valid.dtype != torch.bool or valid.shape != (codes.shape[0],)
        or not valid.is_contiguous() or valid.device != luts.device
    ):
        raise ValueError("pq_adc_topk: valid must be a contiguous [n] bool tensor")
    if luts.device.type == "cpu":
        return pq_adc_topk_plain(luts, codes, k, valid)
    if luts.device.type != "cuda":
        raise ValueError(f"pq_adc_topk: unsupported device {luts.device}")
    if 4 * m * ksub > MAX_LUT_BYTES:
        raise ValueError(f"pq_adc_topk: a {m} x {ksub} table exceeds {MAX_LUT_BYTES} bytes")
    dev = luts.device
    n = codes.shape[0]
    if nq == 0:
        return (
            torch.empty((0, k), dtype=torch.float32, device=dev),
            torch.empty((0, k), dtype=torch.int64, device=dev),
        )
    if nq > _MAX_GRID_Y:
        raise ValueError(f"pq_adc_topk: at most {_MAX_GRID_Y} queries per call, got {nq}")
    launch, chunk_rows = _kernel()
    # One-segment table for the select (the codes' pointer and the score
    # tiles are not read by it).
    table, geo = segment_table([codes], [None], chunk_rows, chunk_rows, dev)
    scores = torch.empty((nq, max(n, 1)), dtype=torch.float32, device=dev)
    cand = candidate_buffer(nq, geo, k, dev)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int64, device=dev)
    rc = launch(
        luts.data_ptr(), nq, m, ksub, query_group(nq, m, ksub), pointer_align([luts]),
        codes.data_ptr(), codes.element_size(), pointer_align([codes]),
        0 if valid is None else valid.data_ptr(), n, table.data_ptr(), k, scores.data_ptr(),
        geo["chunks"], int(geo["multi_chunk"]), cand.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"pq_adc_topk: kernel launch failed with CUDA error {rc}")
    _build.count_launch(pq_adc_topk)
    return out_v, out_i


pq_adc_topk.launches = 0


def adc_scores_plain(luts, codes) -> torch.Tensor:
    """``[nq, n]`` table sums, added over m in order (bit-exact against the
    kernel's score pass)."""
    nq, m, _ = luts.shape
    codes = codes.to(torch.int64)
    scores = torch.zeros((nq, codes.shape[0]), dtype=torch.float32, device=luts.device)
    for j in range(m):
        scores += luts[:, j, :].index_select(1, codes[:, j])
    return scores


def pq_adc_topk_plain(luts, codes, k: int, valid=None):
    """Plain PyTorch version of :func:`pq_adc_topk` (same contract): a
    stable sort breaks ties by row index, as the kernel does."""
    nq = luts.shape[0]
    n = codes.shape[0]
    dev = luts.device
    out_v = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    if n == 0 or nq == 0:
        return out_v, out_i
    scores = adc_scores_plain(luts, codes)
    if valid is not None:
        scores = scores.masked_fill(~valid[None, :], float("inf"))
    k_eff = min(k, n)
    vals, idx = torch.sort(scores, dim=1, stable=True)
    vals, idx = vals[:, :k_eff], idx[:, :k_eff]
    out_v[:, :k_eff] = vals
    out_i[:, :k_eff] = torch.where(vals.abs() >= 1e38, -1, idx)
    return out_v, out_i
