"""Declarative search requests (mirrors the read half of
``repro.core.request``).

A :class:`SearchRequest` is what a client hands the proxy; the proxy
(not ported yet) resolves it into one :class:`NodeSearchRequest` per query
node.  Queries may be numpy arrays or tensors; query nodes move them to
their device.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .collection import Metric, Schema
from .consistency import ConsistencyLevel, GuaranteeTs

#: Segment column name of the first (primary) vector field.
PRIMARY_VECTOR_COLUMN = "vector"


def vector_column_of(schema: Schema, field: str | None) -> str:
    """Map a schema vector-field name to its segment column name."""
    if field is None or field == schema.vector_fields()[0].name:
        return PRIMARY_VECTOR_COLUMN
    return field


@dataclass
class AnnsQuery:
    """One per-vector-field sub-request; ``queries`` is [nq, dim] float32
    (a 1-D vector is one query)."""

    field: str | None
    queries: "np.ndarray | torch.Tensor"
    weight: float = 1.0
    params: dict = dc_field(default_factory=dict)

    def __post_init__(self):
        q = torch.as_tensor(self.queries, dtype=torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2:
            raise ValueError(f"queries must be [nq, dim], got shape {tuple(q.shape)}")
        self.queries = q


@dataclass(frozen=True)
class Ranker:
    """Hybrid fusion strategy: ``weighted`` or ``rrf``."""

    kind: str = "weighted"
    rrf_k: float = 60.0

    def __post_init__(self):
        if self.kind not in ("weighted", "rrf"):
            raise ValueError(f"unknown ranker kind '{self.kind}'")


@dataclass
class SearchRequest:
    """The full declarative read request (client -> proxy)."""

    anns: list[AnnsQuery]
    k: int = 10
    consistency: ConsistencyLevel | None = None
    staleness_ms: float | None = None
    session_ts: int = 0
    filter: object | None = None
    filter_strategy: str | None = None
    radius: float | None = None
    range_filter: float | None = None
    output_fields: tuple[str, ...] = ()
    partition_names: tuple[str, ...] = ()
    time_travel_ts: int | None = None
    ranker: Ranker = dc_field(default_factory=Ranker)
    trace: bool = False

    def __post_init__(self):
        if isinstance(self.anns, AnnsQuery):
            self.anns = [self.anns]
        self.anns = list(self.anns)
        if not self.anns:
            raise ValueError("SearchRequest needs at least one AnnsQuery")
        self.output_fields = tuple(self.output_fields)
        if isinstance(self.partition_names, str):
            self.partition_names = (self.partition_names,)
        self.partition_names = tuple(self.partition_names)
        nqs = {len(a.queries) for a in self.anns}
        if len(nqs) != 1:
            raise ValueError(f"sub-requests disagree on query count: {sorted(nqs)}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.filter_strategy not in (None, "pre", "post", "brute"):
            raise ValueError(f"unknown filter_strategy '{self.filter_strategy}'")

    @property
    def nq(self) -> int:
        return len(self.anns[0].queries)


@dataclass
class NodeSearchRequest:
    """What travels proxy -> query node: field names resolved to segment
    column names, consistency resolved to a pinned guarantee.  See
    ``repro.core.request.NodeSearchRequest`` for each field's meaning."""

    collection: str
    k: int
    metric: Metric
    guarantee: GuaranteeTs
    anns: list[AnnsQuery]
    filter: object | None = None
    filter_strategy: str | None = None
    filter_masks: "dict[int, torch.Tensor] | None" = None
    partitions: tuple[str, ...] | None = None
    segments: tuple[int, ...] | None = None
    channels: tuple[str, ...] | None = None
    trace: tuple | None = None
    hedged: bool = False
