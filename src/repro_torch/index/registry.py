"""Index factory keyed by kind string (mirrors ``repro.index.registry``)."""

from __future__ import annotations

from .base import IndexSpec, VectorIndex
from .bucket import BucketIndex
from .flat import FlatIndex, SQIndex
from .hnsw import HNSWIndex
from .ivf import IVFFlatIndex, IVFPQIndex, IVFSQIndex
from .pq import OPQIndex, PQIndex

INDEX_KINDS: dict[str, type[VectorIndex]] = {
    cls.KIND: cls
    for cls in (FlatIndex, SQIndex, PQIndex, OPQIndex, IVFFlatIndex, IVFSQIndex, IVFPQIndex,
                HNSWIndex, BucketIndex)
}


def create_index(spec: IndexSpec, device="cuda") -> VectorIndex:
    cls = INDEX_KINDS.get(spec.kind)
    if cls is None:
        raise KeyError(f"unknown index kind '{spec.kind}'; have {sorted(INDEX_KINDS)}")
    return cls(metric=spec.metric, device=device, **spec.normalized_params())
