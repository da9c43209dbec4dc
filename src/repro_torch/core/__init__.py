"""Data model, nodes, coordinators and the system facade of the port
(mirrors ``repro.core``; what is not ported yet is not exported).

The facade (``ManuSystem`` and friends) and the compaction services load on
first access: the facade imports
the query node, which imports ``repro_torch.index``, whose modules import
this package, so an eager import here would make the import order matter.
"""

import importlib

from .collection import FieldSchema, FieldType, Metric, Schema
from .consistency import ConsistencyLevel, GuaranteeTs
from .faults import (
    Crash,
    FaultInjector,
    FaultRule,
    FaultyLogBroker,
    FaultyMetaStore,
    FaultyObjectStore,
)
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
from .retry import (
    RetryExhaustedError,
    RetryingLogBroker,
    RetryingMetaStore,
    RetryingObjectStore,
    RetryPolicy,
    TransientError,
    TransientLogError,
    TransientMetaError,
    TransientStoreError,
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
    "CompactionCoordinator",
    "CompactionNode",
    "GCReaper",
    "ConsistencyLevel",
    "GuaranteeTs",
    "Crash",
    "FaultInjector",
    "FaultRule",
    "FaultyLogBroker",
    "FaultyMetaStore",
    "FaultyObjectStore",
    "RetryExhaustedError",
    "RetryingLogBroker",
    "RetryingMetaStore",
    "RetryingObjectStore",
    "RetryPolicy",
    "TransientError",
    "TransientLogError",
    "TransientMetaError",
    "TransientStoreError",
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

_LAZY = {
    "ManuCollection": ".manu",
    "ManuConfig": ".manu",
    "ManuSystem": ".manu",
    "CompactionCoordinator": ".compaction",
    "CompactionNode": ".compaction",
    "GCReaper": ".compaction",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
