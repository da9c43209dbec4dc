"""Nearest-centroid assignment: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``src/repro/kernels/kmeans_assign.py:kmeans_assign_pallas`` and
holds to the host path of ``src/repro/kernels/ops.py:kmeans_assign``; see
``csrc/kmeans_assign.cu`` for the kernel's design (the score passes of
``csrc/scan_common.cuh`` with an argmin epilogue) and what bounds it.  For
CPU tensors the wrapper runs :func:`kmeans_assign_plain`; for CUDA tensors
it launches the kernel or raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .l2_topk import pointer_align, small_q_arg

#: Largest C the byte-bound score path is built for (``kSmallCMax`` in
#: ``csrc/kmeans_assign.cu``), and the widest rows the narrow-row path takes,
#: at any C (``kNarrowD``).
SMALL_C_MAX = 32
NARROW_D = 16
_ANY_C = 2**31 - 1

_c_fn = None
_small_c = (0, 0)  # the byte-bound path's default C threshold and row floats per centroid


def _kernel():
    """The launcher, and the byte-bound path's default C threshold and the
    row floats per centroid it needs (``kSmallC``, ``kRowFloatsPerC``)."""
    global _c_fn, _small_c
    if _c_fn is None:
        lib = _build.load("kmeans_assign")
        fn = lib.repro_kmeans_assign
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        names = ("small_c", "row_floats_per_c", "small_c_max", "narrow_d")
        for name in names:
            getattr(lib, f"repro_kmeans_assign_{name}").restype = ctypes.c_int
        if (lib.repro_kmeans_assign_small_c_max(), lib.repro_kmeans_assign_narrow_d()) != (
            SMALL_C_MAX, NARROW_D
        ):
            raise RuntimeError("kmeans_assign: SMALL_C_MAX / NARROW_D disagree with the compiled kernel")
        _small_c = (lib.repro_kmeans_assign_small_c(), lib.repro_kmeans_assign_row_floats_per_c())
        _c_fn = fn
    return _c_fn, _small_c


def kmeans_assign(x, centroids, *, small_c: int | None = None):
    """Nearest centroid per row of ``x`` [n, D] among ``centroids`` [C, D]
    (both float32, contiguous, C >= 1): ``(assign [n] int64, min_d2 [n]
    float32)`` with d2 = (|x|^2 - 2 x.c) + |c|^2 in float32; the earliest
    centroid wins ties, as ``np.argmin`` does.

    ``small_c``: on the card, the C at or below which a CUDA-core path runs
    instead of the tensor cores (None: :func:`default_small_c`): the
    narrow-row path on rows of at most ``NARROW_D`` floats, else the
    byte-bound path, built for C up to ``SMALL_C_MAX``; for timing the paths
    against each other.  Every answer agrees with the plain version within
    ``SCORE_TOL``."""
    if (
        x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]
        or x.dtype != torch.float32 or centroids.dtype != torch.float32
        or not x.is_contiguous() or not centroids.is_contiguous()
        or x.device != centroids.device
    ):
        raise ValueError(
            "kmeans_assign: x [n, D] and centroids [C, D] must be contiguous float32 "
            "tensors on one device"
        )
    if centroids.shape[0] < 1:
        raise ValueError("kmeans_assign: needs at least one centroid")
    if x.shape[0] >= 2**31 or centroids.shape[0] >= 2**31:
        raise ValueError("kmeans_assign: at most 2**31 - 1 rows and centroids")
    if x.device.type == "cpu":
        return kmeans_assign_plain(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign: unsupported device {x.device}")
    launch, _ = _kernel()
    n, d = x.shape
    small_c = small_q_arg("kmeans_assign", small_c, default_small_c(d),
                          _ANY_C if d <= NARROW_D else SMALL_C_MAX, arg="small_c")
    assign = torch.empty(n, dtype=torch.int64, device=x.device)
    min_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, min_d2
    rc = launch(
        x.data_ptr(), n, d, centroids.data_ptr(), centroids.shape[0], pointer_align([x]),
        pointer_align([centroids]), small_c, assign.data_ptr(), min_d2.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"kmeans_assign: kernel launch failed with CUDA error {rc}")
    path = "tensor_cores" if centroids.shape[0] > small_c else "narrow_rows" if d <= NARROW_D else "byte_bound"
    _build.count_launch(kmeans_assign, path)
    return assign, min_d2


kmeans_assign.launches = 0
#: The launches split by the score path they took.
kmeans_assign.path_launches = {"tensor_cores": 0, "byte_bound": 0, "narrow_rows": 0}


def default_small_c(d: int) -> int:
    """The C at or below which :func:`kmeans_assign` takes a CUDA-core path
    on the card by default, for rows of ``d`` floats: every C on rows of at
    most ``NARROW_D`` floats, else the kernel's ``kSmallC`` but no more than
    d / ``kRowFloatsPerC`` (both measured, see ``csrc/kmeans_assign.cu``).
    Loads the kernel."""
    small_c, per_c = _kernel()[1]
    return _ANY_C if d <= NARROW_D else min(small_c, d // per_c)


def kmeans_assign_plain(x, centroids):
    """Plain PyTorch version of :func:`kmeans_assign` (same contract): the
    host reference's expression, ``argmin`` taking the first minimum."""
    d2 = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ centroids.T)) + (
        centroids * centroids
    ).sum(1)[None, :]
    min_d2, assign = torch.min(d2, dim=1)
    return assign, min_d2
