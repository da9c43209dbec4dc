"""Nearest-centroid assignment: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``src/repro/kernels/kmeans_assign.py:kmeans_assign_pallas`` and
holds to the host path of ``src/repro/kernels/ops.py:kmeans_assign``; see
``csrc/kmeans_assign.cu`` for the kernel's design and what bounds it.  For
CPU tensors the wrapper runs :func:`kmeans_assign_plain`; for CUDA tensors
it launches the kernel or raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_c_fn = None


def _kernel():
    global _c_fn
    if _c_fn is None:
        fn = _build.load("kmeans_assign").repro_kmeans_assign
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _c_fn = fn
    return _c_fn


def kmeans_assign(x, centroids):
    """Nearest centroid per row of ``x`` [n, D] among ``centroids`` [C, D]
    (both float32, contiguous, C >= 1): ``(assign [n] int64, min_d2 [n]
    float32)`` with d2 = (|x|^2 - 2 x.c) + |c|^2 in float32; the earliest
    centroid wins ties, as ``np.argmin`` does."""
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
    n, d = x.shape
    assign = torch.empty(n, dtype=torch.int64, device=x.device)
    min_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, min_d2
    rc = _kernel()(
        x.data_ptr(), n, d, centroids.data_ptr(), centroids.shape[0], assign.data_ptr(),
        min_d2.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"kmeans_assign: kernel launch failed with CUDA error {rc}")
    kmeans_assign.launches += 1
    return assign, min_d2


kmeans_assign.launches = 0


def kmeans_assign_plain(x, centroids):
    """Plain PyTorch version of :func:`kmeans_assign` (same contract): the
    host reference's expression, ``argmin`` taking the first minimum."""
    d2 = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ centroids.T)) + (
        centroids * centroids
    ).sum(1)[None, :]
    min_d2, assign = torch.min(d2, dim=1)
    return assign, min_d2
