"""Vector and attribute indexes of the port (mirrors ``repro.index``)."""

from .base import IndexSpec, VectorIndex
from .bucket import BucketIndex
from .flat import FlatIndex, SQIndex
from .hnsw import HNSWIndex
from .ivf import IVFFlatIndex, IVFPQIndex, IVFSQIndex
from .pq import OPQIndex, PQIndex
from .registry import INDEX_KINDS, create_index

__all__ = [
    "IndexSpec",
    "VectorIndex",
    "BucketIndex",
    "FlatIndex",
    "SQIndex",
    "HNSWIndex",
    "IVFFlatIndex",
    "IVFPQIndex",
    "IVFSQIndex",
    "OPQIndex",
    "PQIndex",
    "INDEX_KINDS",
    "create_index",
]
