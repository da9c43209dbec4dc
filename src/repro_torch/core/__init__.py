"""Data model, nodes, coordinators and the system facade of the port
(mirrors ``repro.core``; what is not ported yet is not exported).

The facade (``ManuSystem`` and friends) loads on first access: it imports
the query node, which imports ``repro_torch.index``, whose modules import
this package, so an eager import here would make the import order matter.
"""

import importlib

from .collection import FieldSchema, FieldType, Metric, Schema
from .consistency import ConsistencyLevel, GuaranteeTs
from .request import (
    AnnsQuery,
    ClusterState,
    DeleteRequest,
    DescribeCollection,
    HistogramRow,
    IndexDescription,
    InsertRequest,
    MetricsSnapshot,
    MutationRequest,
    MutationResult,
    NodeStatus,
    Ranker,
    SearchRequest,
    SegmentPlacement,
    UpsertRequest,
)
from .scheduler import (
    AdmissionRejected,
    BatchingProxy,
    MutationTicket,
    RequestScheduler,
    SearchTicket,
)
from .segment import DEFAULT_PARTITION
from .telemetry import (
    Event,
    EventLog,
    Histogram,
    MetricsRegistry,
    RequestTrace,
    Span,
    TraceContext,
)
from .timestamp import TSO, Clock, ManualClock

__all__ = [
    "DEFAULT_PARTITION",
    "DeleteRequest",
    "InsertRequest",
    "MutationRequest",
    "MutationResult",
    "UpsertRequest",
    "FieldSchema",
    "FieldType",
    "Metric",
    "Schema",
    "ConsistencyLevel",
    "GuaranteeTs",
    "AnnsQuery",
    "Ranker",
    "SearchRequest",
    "ClusterState",
    "NodeStatus",
    "SegmentPlacement",
    "DescribeCollection",
    "HistogramRow",
    "IndexDescription",
    "MetricsSnapshot",
    "ManuCollection",
    "ManuConfig",
    "ManuSystem",
    "AdmissionRejected",
    "BatchingProxy",
    "MutationTicket",
    "RequestScheduler",
    "SearchTicket",
    "Event",
    "EventLog",
    "Histogram",
    "MetricsRegistry",
    "RequestTrace",
    "Span",
    "TraceContext",
    "TSO",
    "Clock",
    "ManualClock",
]

_LAZY = {"ManuCollection": ".manu", "ManuConfig": ".manu", "ManuSystem": ".manu"}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
