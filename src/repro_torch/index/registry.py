"""Index factory keyed by kind string (mirrors ``repro.index.registry``)."""

from __future__ import annotations

from .base import IndexSpec, VectorIndex
from .flat import FlatIndex, SQIndex
from .ivf import IVFFlatIndex, IVFPQIndex, IVFSQIndex
from .pq import OPQIndex, PQIndex

INDEX_KINDS: dict[str, type[VectorIndex]] = {
    cls.KIND: cls
    for cls in (FlatIndex, SQIndex, PQIndex, OPQIndex, IVFFlatIndex, IVFSQIndex, IVFPQIndex)
}

#: Kinds the reference builds that the port does not have yet, with the
#: ROADMAP item that ports them.
NOT_PORTED = {
    "hnsw": "Queue 1: the rest of the index family (HNSW)",
    "bucket": "Queue 1: the rest of the index family (bucket index)",
}


def create_index(spec: IndexSpec, device="cuda") -> VectorIndex:
    cls = INDEX_KINDS.get(spec.kind)
    if cls is None:
        if spec.kind in NOT_PORTED:
            raise NotImplementedError(
                f"index kind '{spec.kind}' is not ported yet: ROADMAP {NOT_PORTED[spec.kind]}"
            )
        raise KeyError(f"unknown index kind '{spec.kind}'; have {sorted(INDEX_KINDS)}")
    return cls(metric=spec.metric, device=device, **spec.normalized_params())
