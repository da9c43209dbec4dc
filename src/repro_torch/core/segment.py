"""Segments with MVCC visibility (mirrors ``repro.core.segment``).

The pk, vector and timestamp columns, the cached cosine unit columns and
the visibility masks are device tensors; tombstone maps stay host Python
dicts, as in the reference.  Scalar extras (attribute columns) stay numpy
arrays on the host, where filter expressions are evaluated; 2-D extras
(further vector fields) get a cached device copy when they are scanned.

A tombstone ``(pk, dts)`` kills exactly the row versions with
``row_ts < dts``, so an upsert's delete half leaves its own insert half
visible.  Primary keys are integers: string keys reach segments as the
int64 surrogate ids the data coordinator assigns (``IdAllocator.string_ids``).
"""

from __future__ import annotations

import io
import threading
from dataclasses import dataclass
from enum import Enum
from typing import Any

import numpy as np
import torch

from .._device import resolve_device

DEFAULT_SLICE_ROWS = 10_000
#: Every collection owns one implicit partition; unplaced writes land here.
DEFAULT_PARTITION = "_default"


def add_tombstone(dd: dict, pk, ts: int) -> bool:
    """Record one (pk, delete-ts) tombstone; returns False on duplicates."""
    cur = dd.get(pk)
    if cur is None:
        dd[pk] = int(ts)
        return True
    if isinstance(cur, list):
        if ts in cur:
            return False
        cur.append(int(ts))
        cur.sort()
        return True
    if cur == ts:
        return False
    dd[pk] = sorted((cur, int(ts)))
    return True


def flatten_tombstones(dd: dict, device) -> "tuple[torch.Tensor, torch.Tensor]":
    """Flatten a pk -> (ts | [ts, ...]) map into aligned (pks, dts) int64
    tensors on ``device`` -- the shape ``ops.eff_tombstones`` consumes."""
    pks: list = []
    dts: list = []
    for pk, v in dd.items():
        if isinstance(v, list):
            pks.extend([pk] * len(v))
            dts.extend(v)
        else:
            pks.append(pk)
            dts.append(v)
    return (
        torch.tensor(pks, dtype=torch.int64).to(device),
        torch.tensor(dts, dtype=torch.int64).to(device),
    )


class TombstoneSet:
    """A tombstone map flattened once, and its effective set at the last
    query timestamp, cached.

    ``pks`` / ``dts`` are the flattened pairs on the device (what
    ``ops.eff_tombstones`` takes).  A host copy of the delete timestamps,
    sorted, tells how many tombstones apply at a query ts (``dts <= ts``)
    without the card, and that count fixes the effective set exactly: two
    timestamps that admit the same count admit the same pairs.  So a lookup
    reads nothing back unless its count differs from the last lookup's, and
    then reduces the pairs with ``ops.eff_tombstones`` once.  The map must
    not change under the set: its owner drops the set when it does."""

    def __init__(self, dd: dict, device):
        pks, dts = flatten_tombstones(dd, "cpu")
        self._sorted_dts = np.sort(dts.numpy())
        self.pks, self.dts = pks.to(device), dts.to(device)
        # (count, effective set) of the last lookup that found tombstones;
        # replaced whole, so concurrent lookups need no lock.
        self._last: tuple[int, tuple[torch.Tensor, torch.Tensor]] | None = None

    def effective(self, ts: int):
        """``(sorted unique pks, effective delete ts)`` at ``ts`` as device
        tensors, or None when no tombstone applies, with the lookup's
        outcome: "none", "hit" or "miss"."""
        count = int(np.searchsorted(self._sorted_dts, ts, side="right"))
        if count == 0:
            return None, "none"
        last = self._last
        if last is not None and last[0] == count:
            return last[1], "hit"
        from ..kernels import ops

        eff = ops.eff_tombstones(self.pks, self.dts, ts)
        self._last = (count, eff)
        return eff, "miss"


def _int_pks(pks) -> np.ndarray:
    arr = np.asarray(pks)
    if arr.size and arr.dtype.kind not in "iu":
        raise TypeError(f"repro_torch segments take integer pks, got dtype {arr.dtype}")
    return arr.astype(np.int64, copy=False)


@dataclass
class SegmentStats:
    num_rows: int
    num_deleted: int
    state: str
    min_ts: int
    max_ts: int


class SegmentState(Enum):
    GROWING = "growing"
    SEALED = "sealed"
    DROPPED = "dropped"


class Segment:
    """Columnar segment on one device with MVCC visibility."""

    def __init__(
        self,
        segment_id: int,
        collection: str,
        shard: int,
        dim: int,
        slice_rows: int = DEFAULT_SLICE_ROWS,
        extra_fields: tuple[str, ...] = (),
        partition: str = DEFAULT_PARTITION,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.segment_id = segment_id
        self.collection = collection
        self.shard = shard
        self.partition = partition
        self.dim = dim
        self.slice_rows = slice_rows
        self.state = SegmentState.GROWING
        self.extra_fields = tuple(extra_fields)

        self._pks: list[torch.Tensor] = []
        self._vectors: list[torch.Tensor] = []
        self._timestamps: list[torch.Tensor] = []
        self._extras: dict[str, list[np.ndarray]] = {f: [] for f in self.extra_fields}
        self._num_rows = 0
        # Smallest and largest row ts, kept on the host as rows arrive.
        self._ts_range: tuple[int, int] = (0, 0)
        # Materialized columns and cached unit / device-extra columns;
        # invalidated on append.
        self._mat: dict[str, Any] | None = None
        self._unit: dict[str, torch.Tensor] = {}
        self._dev_extra: dict[str, torch.Tensor] = {}
        # Tombstones: pk -> delete ts (or a sorted list of them).
        self._deleted: dict[Any, Any] = {}
        self._del_set: TombstoneSet | None = None
        self._lock = threading.RLock()
        self.checkpoint_pos: int = 0
        # Temporary indexes over full slices of a growing segment (built by
        # the query node once a slice is full).
        self.slice_indexes: dict[int, Any] = {}

    # -------------------------------------------------------------- writes
    def append(self, pks, vectors, timestamps, extras: dict | None = None) -> None:
        """Append rows; ``pks``/``vectors``/``timestamps`` may be numpy
        arrays or tensors on any device (they are copied to this one)."""
        with self._lock:
            if self.state is not SegmentState.GROWING:
                raise RuntimeError(f"segment {self.segment_id} is {self.state}, not growing")
            if not torch.is_tensor(pks):
                pks = torch.from_numpy(_int_pks(pks))
            vec = vectors if torch.is_tensor(vectors) else torch.from_numpy(np.asarray(vectors))
            if vec.dim() != 2 or vec.shape[1] != self.dim:
                raise ValueError(f"expected (n,{self.dim}) vectors, got {tuple(vec.shape)}")
            ts = timestamps if torch.is_tensor(timestamps) else torch.from_numpy(
                np.asarray(timestamps, np.int64)
            )
            n = len(pks)
            if not (len(vec) == len(ts) == n):
                raise ValueError("pks/vectors/timestamps length mismatch")
            self._pks.append(pks.to(self.device, torch.int64))
            self._vectors.append(vec.to(self.device, torch.float32).contiguous())
            self._timestamps.append(ts.to(self.device, torch.int64))
            for name in self.extra_fields:
                src = (extras or {}).get(name)
                if src is None:
                    raise ValueError(f"missing extra field '{name}'")
                self._extras[name].append(np.asarray(src))
            if n:
                lo, hi = int(ts.min()), int(ts.max())
                if self._num_rows:
                    lo, hi = min(lo, self._ts_range[0]), max(hi, self._ts_range[1])
                self._ts_range = (lo, hi)
            self._num_rows += n
            self._mat = None
            self._unit.clear()
            self._dev_extra.clear()

    def delete(self, pks, ts: int) -> int:
        """Tombstone primary keys as of ``ts`` (row versions with
        ``row_ts < ts`` die for queries pinned at or after ``ts``).
        Returns the number of tombstones recorded."""
        with self._lock:
            want = torch.from_numpy(_int_pks(np.atleast_1d(np.asarray(pks)))).to(self.device)
            if want.numel() == 0 or self._num_rows == 0:
                return 0
            have = torch.sort(self.pks()).values
            from ..kernels import ops

            hit = want[ops.isin_sorted(want, have)].tolist()
            hits = sum(1 for pk in hit if add_tombstone(self._deleted, pk, ts))
            if hits:
                self._del_set = None
            return hits

    def seal(self) -> None:
        with self._lock:
            self.state = SegmentState.SEALED

    # --------------------------------------------------------------- reads
    def _materialize(self) -> dict[str, Any]:
        with self._lock:
            if self._mat is None:
                dev = self.device
                cols: dict[str, Any] = {
                    "pk": torch.cat(self._pks) if self._pks
                    else torch.empty(0, dtype=torch.int64, device=dev),
                    "vector": torch.cat(self._vectors) if self._vectors
                    else torch.empty((0, self.dim), dtype=torch.float32, device=dev),
                    "ts": torch.cat(self._timestamps) if self._timestamps
                    else torch.empty(0, dtype=torch.int64, device=dev),
                }
                for name in self.extra_fields:
                    chunks = self._extras[name]
                    cols[name] = np.concatenate(chunks) if chunks else np.empty(0)
                # Later appends rebuild from the single materialized chunk.
                self._pks, self._vectors, self._timestamps = (
                    [cols["pk"]], [cols["vector"]], [cols["ts"]]
                )
                self._mat = cols
            return self._mat

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def pks(self) -> torch.Tensor:
        return self._materialize()["pk"]

    def vectors(self) -> torch.Tensor:
        return self._materialize()["vector"]

    def timestamps(self) -> torch.Tensor:
        return self._materialize()["ts"]

    def extra(self, name: str) -> np.ndarray:
        """A stored extras column as the host numpy array."""
        return self._materialize()[name]

    def vector_column(self, name: str = "vector") -> torch.Tensor:
        """A vector column on the device ("vector" or a 2-D extra)."""
        if name == "vector":
            return self.vectors()
        with self._lock:
            cached = self._dev_extra.get(name)
            if cached is None:
                cached = torch.from_numpy(
                    np.ascontiguousarray(self.extra(name), np.float32)
                ).to(self.device)
                self._dev_extra[name] = cached
            return cached

    def unit_column(self, name: str = "vector") -> torch.Tensor:
        """Row-normalized copy of a vector column, cached until the next
        append (cosine brute scans reuse it)."""
        with self._lock:
            cached = self._unit.get(name)
            if cached is None:
                col = self.vector_column(name)
                norms = torch.linalg.vector_norm(col, dim=1, keepdim=True)
                cached = (col / norms.clamp_min(1e-12)).contiguous()
                self._unit[name] = cached
            return cached

    def _tombstone_set(self) -> TombstoneSet | None:
        with self._lock:
            if not self._deleted:
                return None
            if self._del_set is None:
                self._del_set = TombstoneSet(self._deleted, self.device)
            return self._del_set

    def visible_mask(self, ts: int) -> torch.Tensor:
        """MVCC visibility at query timestamp ``ts`` as a device bool mask:
        rows written at or before ``ts`` and not killed by a tombstone in
        ``(row_ts, ts]``."""
        from ..kernels import ops

        cols = self._materialize()
        mask = cols["ts"] <= ts
        tombstones = self._tombstone_set()
        if tombstones is not None:
            eff, _outcome = tombstones.effective(ts)
            if eff is not None:
                mask &= ~ops.tombstone_mask(cols["pk"], cols["ts"], eff[0], eff[1])
        return mask

    def delete_bitmap(self) -> torch.Tensor:
        """Rows currently dead (killed at any timestamp)."""
        return ~self.visible_mask(np.iinfo(np.int64).max)

    def stats(self) -> SegmentStats:
        return SegmentStats(
            num_rows=self.num_rows,
            num_deleted=len(self._deleted),
            state=self.state.value,
            min_ts=self.min_ts(),
            max_ts=self.max_ts(),
        )

    def deleted_fraction(self) -> float:
        return len(self._deleted) / max(1, self.num_rows)

    def min_ts(self) -> int:
        return self._ts_range[0]

    def max_ts(self) -> int:
        return self._ts_range[1]

    # -------------------------------------------------------------- slices
    def full_slices(self) -> list[int]:
        """Indices of completed slices (candidates for temporary indexes)."""
        return list(range(self._num_rows // self.slice_rows))

    def slice_bounds(self, slice_idx: int) -> tuple[int, int]:
        lo = slice_idx * self.slice_rows
        return lo, min(lo + self.slice_rows, self._num_rows)

    def tail_rows(self) -> tuple[int, int]:
        """Row range not covered by any full slice (always brute-force)."""
        return (self._num_rows // self.slice_rows) * self.slice_rows, self._num_rows

    # -------------------------------------------------- binlog (de)serialize
    def to_binlog(self) -> bytes:
        """The reference's single-blob serialization (``np.savez_compressed``
        of every column, tombstones flattened to aligned (pk, ts) arrays).
        The object store's per-column layout is ``binlog.py``'s."""
        cols = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in self._materialize().items()}
        tombstones = self._tombstone_set()
        if tombstones is not None:
            cols["__deleted_pks"], cols["__deleted_ts"] = (
                t.cpu().numpy() for t in (tombstones.pks, tombstones.dts)
            )
        else:
            cols["__deleted_pks"] = np.empty(0, cols["pk"].dtype)
            cols["__deleted_ts"] = np.empty(0, np.int64)
        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            __meta=np.array(
                [self.segment_id, self.shard, self.dim, self.checkpoint_pos], dtype=np.int64
            ),
            __partition=np.array(self.partition),
            **cols,
        )
        return buf.getvalue()

    @classmethod
    def from_binlog(
        cls, collection: str, data: bytes, slice_rows: int = DEFAULT_SLICE_ROWS, device="cuda"
    ) -> "Segment":
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            segment_id, shard, dim, ckpt = (int(x) for x in z["__meta"])
            extra_names = tuple(
                k for k in z.files
                if k not in ("__meta", "__partition", "pk", "vector", "ts",
                             "__deleted_pks", "__deleted_ts")
            )
            partition = str(z["__partition"]) if "__partition" in z.files else DEFAULT_PARTITION
            seg = cls(segment_id, collection, shard, dim, slice_rows, extra_names,
                      partition=partition, device=device)
            if len(z["pk"]):
                seg.append(z["pk"], z["vector"], z["ts"], {k: z[k] for k in extra_names})
            seg.checkpoint_pos = ckpt
            for pk, dts in zip(z["__deleted_pks"].tolist(), z["__deleted_ts"].tolist()):
                add_tombstone(seg._deleted, pk, dts)
            seg.seal()
            return seg


def merge_segments(new_id: int, segments: "list[Segment]") -> Segment:
    """Merge sealed segments into one on the first one's device, dropping
    the rows a tombstone already kills."""
    if not segments:
        raise ValueError("nothing to merge")
    base = segments[0]
    out = Segment(
        new_id, base.collection, base.shard, base.dim, base.slice_rows,
        base.extra_fields, partition=base.partition, device=base.device,
    )
    for seg in segments:
        keep = ~seg.delete_bitmap()
        if keep.any():
            host_keep = keep.cpu().numpy()
            extras = {f: seg.extra(f)[host_keep] for f in seg.extra_fields}
            out.append(seg.pks()[keep], seg.vectors()[keep], seg.timestamps()[keep], extras)
    out.checkpoint_pos = max(s.checkpoint_pos for s in segments)
    out.seal()
    return out


def segment_from_columns(
    columns: "dict[str, np.ndarray]",
    segment_id: int = 0,
    collection: str = "c",
    shard: int = 0,
    partition: str = DEFAULT_PARTITION,
    slice_rows: int = DEFAULT_SLICE_ROWS,
    sealed: bool = True,
    device="cuda",
) -> Segment:
    """Build a segment straight from columns ``pk``, ``vector``, ``ts`` and
    any extras (tests and benchmarks)."""
    vec = columns["vector"]
    extras = {k: v for k, v in columns.items() if k not in ("pk", "vector", "ts")}
    seg = Segment(
        segment_id, collection, shard, int(vec.shape[1]), slice_rows=slice_rows,
        extra_fields=tuple(sorted(extras)), partition=partition, device=device,
    )
    if len(columns["pk"]):
        seg.append(columns["pk"], vec, columns["ts"], extras)
    if sealed:
        seg.seal()
    return seg
