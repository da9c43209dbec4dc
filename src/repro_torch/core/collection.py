"""Schema and collection metadata (paper §3.1).

Basic data types: vector, string, boolean, integer, float.  An entity has a
primary key, one or more feature vectors, optional labels (categorical) and
numerical attributes, plus the hidden LSN system field.  Collections have no
relations to each other (no joins).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any

import numpy as np


class FieldType(Enum):
    VECTOR = "vector"
    INT = "int"
    FLOAT = "float"
    STRING = "string"
    BOOL = "bool"


class Metric(Enum):
    L2 = "l2"
    IP = "ip"
    COSINE = "cosine"


@dataclass(frozen=True)
class FieldSchema:
    name: str
    dtype: FieldType
    dim: int = 0  # vectors only
    is_primary: bool = False

    def __post_init__(self):
        if self.dtype is FieldType.VECTOR and self.dim <= 0:
            raise ValueError(f"vector field '{self.name}' needs dim > 0")
        if self.is_primary and self.dtype not in (FieldType.INT, FieldType.STRING):
            raise ValueError("primary key must be int or string")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dtype": self.dtype.value,
            "dim": self.dim,
            "is_primary": self.is_primary,
        }

    @staticmethod
    def from_dict(d: dict) -> "FieldSchema":
        return FieldSchema(
            d["name"],
            FieldType(d["dtype"]),
            dim=int(d.get("dim", 0)),
            is_primary=bool(d.get("is_primary", False)),
        )


@dataclass(frozen=True)
class Schema:
    fields: tuple[FieldSchema, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError("duplicate field names")
        if sum(f.is_primary for f in self.fields) > 1:
            raise ValueError("at most one primary key")
        if not self.vector_fields():
            raise ValueError("schema needs at least one vector field")

    def primary(self) -> FieldSchema | None:
        for f in self.fields:
            if f.is_primary:
                return f
        return None

    def vector_fields(self) -> list[FieldSchema]:
        return [f for f in self.fields if f.dtype is FieldType.VECTOR]

    def field(self, name: str) -> FieldSchema:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no field '{name}'")

    def attribute_fields(self) -> list[FieldSchema]:
        return [
            f
            for f in self.fields
            if not f.is_primary and f.dtype is not FieldType.VECTOR
        ]

    def to_dict(self) -> dict:
        """Durable form, so a restarted system can reconstruct collections
        purely from the meta store."""
        return {"fields": [f.to_dict() for f in self.fields]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema(tuple(FieldSchema.from_dict(f) for f in d["fields"]))

    @staticmethod
    def simple(dim: int, metric: Metric = Metric.L2, extra: list[FieldSchema] | None = None) -> "Schema":
        """The common case: int PK + one vector field (+ extras)."""
        fields = [
            FieldSchema("pk", FieldType.INT, is_primary=True),
            FieldSchema("vector", FieldType.VECTOR, dim=dim),
        ]
        fields.extend(extra or [])
        return Schema(tuple(fields))


@dataclass
class CollectionInfo:
    """Coordinator-side collection metadata (lives in the meta store)."""

    name: str
    schema: Schema
    num_shards: int
    metric: Metric = Metric.L2
    created_ts: int = 0
    index_specs: dict[str, dict[str, Any]] = field(default_factory=dict)
    dropped: bool = False
    replication_factor: int = 1

    def dim(self, vector_field: str = "vector") -> int:
        return self.schema.field(vector_field).dim


def validate_rows(schema: Schema, rows: dict[str, np.ndarray]) -> int:
    """Validate one insert batch against the schema; returns row count.

    Rejects unknown field names outright — a typo'd column must fail the
    request, not silently vanish from the batch."""
    if not rows:
        raise ValueError("empty insert batch (no fields)")
    known = {f.name for f in schema.fields}
    stray = sorted(set(rows) - known)
    if stray:
        raise ValueError(
            f"unknown field(s) {stray} in insert batch; schema has {sorted(known)}"
        )
    n = None
    for f in schema.fields:
        if f.name not in rows:
            if f.is_primary:
                continue  # auto-assigned PK allowed
            raise ValueError(f"missing field '{f.name}' in insert batch")
        arr = rows[f.name]
        if n is None:
            n = len(arr)
        elif len(arr) != n:
            raise ValueError(f"field '{f.name}' length {len(arr)} != {n}")
        if f.dtype is FieldType.VECTOR:
            if arr.ndim != 2 or arr.shape[1] != f.dim:
                raise ValueError(
                    f"vector field '{f.name}' must be (n,{f.dim}), got {arr.shape}"
                )
    if n is None:
        raise ValueError("empty insert batch")
    return n
