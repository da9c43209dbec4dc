"""Vector index interface and serialization (mirrors ``repro.index.base``).

Search contract: ``search(queries, k, valid=None)`` returns device tensors
``(scores [nq,k], local_idx [nq,k])``; -1 marks empty slots.  Scores are L2
distances (ascending) or IP similarities (descending) per the metric.
Saved index bytes use the reference's ``.npz`` layout, so either package
loads the other's files.
"""

from __future__ import annotations

import io
import json
import zipfile
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..core.collection import Metric


@dataclass
class IndexSpec:
    kind: str
    metric: Metric = Metric.L2
    params: dict[str, Any] | None = None
    # Schema vector field the index serves (multi-vector collections build
    # one index per spec'd field); purely descriptive for the factory.
    field: str = "vector"

    def normalized_params(self) -> dict[str, Any]:
        return dict(self.params or {})


class VectorIndex:
    KIND = "base"

    def __init__(self, metric: Metric = Metric.L2, device="cuda", **params):
        self.metric = metric
        self.device = resolve_device(device)
        self.params = params
        self.num_rows = 0

    def build(self, vectors) -> None:
        raise NotImplementedError

    def search(self, queries, k, valid=None):
        raise NotImplementedError

    # -- batched candidate-pool surface -------------------------------------
    def batch_spec(self) -> tuple:
        """Hashable key: units whose indexes share it run as one
        ``search_batched`` dispatch."""
        return (
            type(self),
            self.metric,
            tuple(sorted((k, repr(v)) for k, v in self.params.items())),
        )

    @classmethod
    def search_batched(cls, indexes, queries, k: int, valids=None):
        """Candidate-pool search over co-located indexes of one spec.

        Returns ``(scores [nq, M], local_idx [nq, M], splits)``; block ``u``
        (columns ``splits[u]:splits[u+1]``) holds top candidates of
        ``indexes[u]`` with row indices local to it (-1 = empty).  The base
        implementation dispatches per index."""
        if valids is None:
            valids = [None] * len(indexes)
        ss, ii, splits = [], [], [0]
        for idx, v in zip(indexes, valids):
            s, i = idx.search(queries, k, valid=v)
            ss.append(s)
            ii.append(i)
            splits.append(splits[-1] + s.shape[1])
        nq = len(queries)
        if not ss:
            return (
                torch.zeros((nq, 0), dtype=torch.float32, device=queries.device),
                torch.full((nq, 0), -1, dtype=torch.int64, device=queries.device),
                splits,
            )
        return torch.cat(ss, 1), torch.cat(ii, 1), splits

    # -- (de)serialization ---------------------------------------------------
    def _state(self) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def _load_state(self, state: dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def save(self) -> bytes:
        """The reference's ``.npz`` layout, written uncompressed (numpy's
        loader reads both).  Every member carries the same fixed zip
        timestamp, so the bytes depend on the index state alone."""
        buf = io.BytesIO()
        meta = {
            "kind": np.bytes_(self.KIND.encode()),
            "metric": np.bytes_(self.metric.value.encode()),
            "num_rows": np.int64(self.num_rows),
            "params_json": np.bytes_(json.dumps(self.params, default=str).encode()),
        }
        with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED) as zf:
            for key, val in {**meta, **self._state()}.items():
                info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
                with zf.open(info, "w", force_zip64=True) as fid:
                    np.lib.format.write_array(fid, np.asanyarray(val), allow_pickle=False)
        return buf.getvalue()

    @classmethod
    def load(cls, data: bytes, device="cuda") -> "VectorIndex":
        from .registry import create_index

        meta_keys = ("kind", "metric", "num_rows", "params_json")
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            kind = bytes(z["kind"]).decode()
            metric = Metric(bytes(z["metric"]).decode())
            params = (
                json.loads(bytes(z["params_json"]).decode()) if "params_json" in z.files else {}
            )
            idx = create_index(IndexSpec(kind=kind, metric=metric, params=params), device=device)
            idx.num_rows = int(z["num_rows"])
            idx._load_state({k: z[k] for k in z.files if k not in meta_keys})
            return idx


def normalize_if_cosine(metric: Metric, x: torch.Tensor) -> torch.Tensor:
    """Cosine = IP over unit vectors; normalize once at build/query time."""
    if metric is Metric.COSINE:
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return (x / norms.clamp_min(1e-12)).contiguous()
    return x


def scan_metric(metric: Metric) -> str:
    return "l2" if metric is Metric.L2 else "ip"


def worst_score(metric: Metric) -> float:
    return float("inf") if metric is Metric.L2 else float("-inf")


def host_array(t) -> np.ndarray:
    """A state tensor as the host numpy array ``_state`` saves."""
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def device_tensor(a, device, dtype=None) -> torch.Tensor:
    """A saved state array as a contiguous tensor on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype).contiguous()
