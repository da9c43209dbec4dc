"""Scalar-quantization codec: the encoder, the decoder and the scan over
uint8 codes with fused dequantization, the CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces ``src/repro/kernels/sq_codec.py:sq_encode_pallas``,
``sq_decode_pallas`` and ``sq_l2_topk_pallas`` and holds to the host paths
of ``src/repro/kernels/ops.py:sq_encode`` / ``sq_decode`` / ``sq_topk_scan``; see
``csrc/sq_codec.cu`` for the kernels' design and what bounds them.  For CPU
tensors the wrappers run the plain versions; for CUDA tensors they launch
the kernels or raise -- there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .l2_topk import (
    _MAX_GRID_Y,
    candidate_buffer,
    l2_topk_plain,
    pointer_align,
    segment_table,
    small_q_arg,
)

#: Largest k the scan takes (``kMaxK`` in ``csrc/scan_common.cuh``).
MAX_K = 1024

_fns: dict[str, object] = {}


def _kernels():
    if not _fns:
        lib = _build.load("sq_codec")
        enc = lib.repro_sq_encode
        enc.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        enc.restype = ctypes.c_int
        dec = lib.repro_sq_decode
        dec.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        dec.restype = ctypes.c_int
        scan = lib.repro_sq_l2_topk
        scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        scan.restype = ctypes.c_int
        names = ("tile_rows", "chunk_rows", "small_q", "small_q_max")
        for name in ("max_k",) + names:
            getattr(lib, f"repro_sq_l2_topk_{name}").restype = ctypes.c_int
        if lib.repro_sq_l2_topk_max_k() != MAX_K:
            raise RuntimeError("sq_l2_topk: MAX_K disagrees with the compiled kernel")
        _fns.update(encode=enc, decode=dec, scan=scan)
        _fns.update({name: getattr(lib, f"repro_sq_l2_topk_{name}")() for name in names})
    return _fns


def sq_scale(vmin, vmax) -> torch.Tensor:
    """The codec's per-dimension quantization step,
    ``max(vmax - vmin, 1e-12) / 255`` in float32, for the plain versions
    and the host paths.  The encode and decode kernels and the fused scan
    compute the same expression, with the same roundings, in CUDA
    (``sq_scale_of`` in ``csrc/sq_codec.cu``), so that a call costs no
    launch for it.  The divisor is a tensor: PyTorch on CUDA multiplies by
    the reciprocal of a Python-number divisor, which rounds differently
    from the IEEE division of the reference (numpy) and of the kernels."""
    span = torch.clamp_min(vmax.to(torch.float32) - vmin.to(torch.float32), 1e-12)
    return span / span.new_full((), 255.0)


def _check_range(name: str, x, vmin, vmax) -> None:
    d = x.shape[1]
    for v in (vmin, vmax):
        if v.shape != (d,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"{name}: vmin/vmax must be [{d}] float32 on the data's device")


def sq_encode(x, vmin, vmax) -> torch.Tensor:
    """``x`` [n, D] float32 -> uint8 codes ``clip(round((x - vmin) /
    scale), 0, 255)``, rounding half to even; bit-exact against
    :func:`sq_encode_plain`.  On the card one launch: the kernel computes
    the scale from ``vmin`` / ``vmax``."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("sq_encode: x must be a contiguous [n, D] float32 tensor")
    _check_range("sq_encode", x, vmin, vmax)
    if x.device.type == "cpu":
        return sq_encode_plain(x, vmin, vmax)
    if x.device.type != "cuda":
        raise ValueError(f"sq_encode: unsupported device {x.device}")
    n, d = x.shape
    out = torch.empty((n, d), dtype=torch.uint8, device=x.device)
    if n == 0 or d == 0:
        return out
    vmin_c, vmax_c = vmin.contiguous(), vmax.contiguous()
    rc = _kernels()["encode"](
        x.data_ptr(), vmin_c.data_ptr(), vmax_c.data_ptr(), out.data_ptr(), n, d,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sq_encode: kernel launch failed with CUDA error {rc}")
    _build.count_launch(sq_encode)
    return out


sq_encode.launches = 0


def sq_encode_plain(x, vmin, vmax) -> torch.Tensor:
    """Plain PyTorch version of :func:`sq_encode` (``torch.round`` rounds
    half to even)."""
    q = torch.round((x - vmin[None, :]) / sq_scale(vmin, vmax)[None, :])
    return torch.clamp(q, 0, 255).to(torch.uint8)


def sq_decode(codes, vmin, vmax) -> torch.Tensor:
    """uint8 ``codes`` [n, D] -> float32 rows ``code * scale + vmin``,
    bit-exact against :func:`sq_decode_plain` (two roundings, no FMA).  On
    the card one launch: the kernel computes the scale from ``vmin`` /
    ``vmax``."""
    if codes.dim() != 2 or codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("sq_decode: codes must be a contiguous [n, D] uint8 tensor")
    _check_range("sq_decode", codes, vmin, vmax)
    if codes.device.type == "cpu":
        return sq_decode_plain(codes, vmin, vmax)
    if codes.device.type != "cuda":
        raise ValueError(f"sq_decode: unsupported device {codes.device}")
    n, d = codes.shape
    out = torch.empty((n, d), dtype=torch.float32, device=codes.device)
    if n == 0 or d == 0:
        return out
    vmin_c, vmax_c = vmin.contiguous(), vmax.contiguous()
    rc = _kernels()["decode"](
        codes.data_ptr(), vmin_c.data_ptr(), vmax_c.data_ptr(), out.data_ptr(), n, d,
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sq_decode: kernel launch failed with CUDA error {rc}")
    _build.count_launch(sq_decode)
    return out


sq_decode.launches = 0


def sq_decode_plain(codes, vmin, vmax) -> torch.Tensor:
    """``code * scale + vmin`` in float32 (two roundings, as the host decode
    and the scan kernel's row loader)."""
    return codes.to(torch.float32) * sq_scale(vmin, vmax)[None, :] + vmin[None, :]


def sq_l2_topk(queries, codes, vmin, vmax, valid, k: int, metric: str = "l2", *,
               small_q: int | None = None):
    """Top-k of ``queries`` [nq, D] float32 against uint8 SQ ``codes``
    [n, D] decoded as ``code * scale + vmin``, with the ``l2_topk``
    contract for one segment: ``(vals [nq, k] float32, idx [nq, k] int64)``,
    ascending L2 distance or descending inner product; slots past the valid
    rows carry (+inf L2 / -inf IP, -1) and ``|score| >= 1e38`` has index -1.
    ``small_q`` as in :func:`~repro_torch.kernels.l2_topk.l2_topk`."""
    return sq_l2_topk_segmented(queries, [codes], vmin, vmax, [valid], k, metric,
                                small_q=small_q)


def sq_l2_topk_segmented(queries, codes, vmin, vmax, valids, k: int, metric: str = "l2", *,
                         small_q: int | None = None):
    """:func:`sq_l2_topk` over a list of code segments that share ``vmin`` /
    ``vmax``, in one launch: ``(vals [nq, S*k], idx [nq, S*k])``, block
    ``[:, s*k:(s+1)*k]`` segment ``s``'s answer with row indices local to
    it.  Each block equals that segment's own :func:`sq_l2_topk` bit for
    bit: a row's score depends on the row and the queries alone, and each
    segment is selected apart."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"sq_l2_topk: unknown metric {metric!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sq_l2_topk: k={k} outside [1, {MAX_K}]")
    if queries.dim() != 2 or queries.dtype != torch.float32 or not queries.is_contiguous():
        raise ValueError("sq_l2_topk: queries must be a contiguous [nq, D] float32 tensor")
    if len(valids) != len(codes):
        raise ValueError("sq_l2_topk: one valid mask (or None) per segment")
    d = queries.shape[1]
    for c, valid in zip(codes, valids):
        if (
            c.dim() != 2 or c.shape[1] != d or c.dtype != torch.uint8
            or not c.is_contiguous() or c.device != queries.device
        ):
            raise ValueError(f"sq_l2_topk: codes must be a contiguous [n, {d}] uint8 tensor")
        if c.shape[0] >= 2**31:
            raise ValueError("sq_l2_topk: at most 2**31 - 1 rows")
        if valid is not None and (
            valid.dtype != torch.bool or valid.shape != (c.shape[0],)
            or not valid.is_contiguous() or valid.device != queries.device
        ):
            raise ValueError("sq_l2_topk: valid must be a contiguous [n] bool tensor")
    _check_range("sq_l2_topk", queries, vmin, vmax)
    if queries.device.type == "cpu":
        return sq_l2_topk_plain_segmented(queries, codes, vmin, vmax, valids, k, metric)
    if queries.device.type != "cuda":
        raise ValueError(f"sq_l2_topk: unsupported device {queries.device}")
    nq, n_seg = queries.shape[0], len(codes)
    dev = queries.device
    if nq == 0 or n_seg == 0:
        fill = float("inf") if metric == "l2" else float("-inf")
        return (
            torch.full((nq, n_seg * k), fill, dtype=torch.float32, device=dev),
            torch.full((nq, n_seg * k), -1, dtype=torch.int64, device=dev),
        )
    if nq > _MAX_GRID_Y:
        raise ValueError(f"sq_l2_topk: at most {_MAX_GRID_Y} queries per call, got {nq}")
    fns = _kernels()
    small_q = small_q_arg("sq_l2_topk", small_q, fns["small_q"], fns["small_q_max"])
    table, geo = segment_table(codes, valids, fns["tile_rows"], fns["chunk_rows"], dev)
    vmin_c, vmax_c = vmin.contiguous(), vmax.contiguous()
    ld = max(geo["rows"], 1)
    scores = torch.empty((nq, ld), dtype=torch.float32, device=dev)
    cand = candidate_buffer(nq, geo, k, dev)
    out_v = torch.empty((nq, n_seg * k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, n_seg * k), dtype=torch.int64, device=dev)
    rc = fns["scan"](
        queries.data_ptr(), nq, d, table.data_ptr(), n_seg, geo["tiles"], geo["rows"],
        pointer_align([queries]), pointer_align(codes), pointer_align([vmin_c, vmax_c]),
        small_q, vmin_c.data_ptr(), vmax_c.data_ptr(),
        scores.data_ptr(), ld, k, int(metric == "ip"), geo["chunks"], int(geo["multi_chunk"]),
        cand.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sq_l2_topk: kernel launch failed with CUDA error {rc}")
    _build.count_launch(sq_l2_topk)
    return out_v, out_i


sq_l2_topk.launches = 0


def sq_l2_topk_plain(queries, codes, vmin, vmax, valid, k: int, metric: str = "l2"):
    """Plain PyTorch version of :func:`sq_l2_topk`: decode, then the plain
    brute-force scan."""
    return sq_l2_topk_plain_segmented(queries, [codes], vmin, vmax, [valid], k, metric)


def sq_l2_topk_plain_segmented(queries, codes, vmin, vmax, valids, k: int, metric: str = "l2"):
    """Plain PyTorch version of :func:`sq_l2_topk_segmented`."""
    decoded = [sq_decode_plain(c, vmin, vmax) for c in codes]
    return l2_topk_plain(queries, decoded, list(valids), k, metric)
