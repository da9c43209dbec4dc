"""Binlog: columnar segment objects in the object store (mirrors
``repro.core.binlog``, same key layout and ``.npy`` blobs).

    binlog/<collection>/<segment_id>/meta                 (segment header)
    binlog/<collection>/<segment_id>/col/<field>          (one object per column)
    index/<collection>/<segment_id>/<field>/<index_kind>  (built index files)
    attr/<collection>/<segment_id>/<field>                (attribute-index satellites)

The objects the reference writes load here key for key, and a segment
written here produces the same bytes the reference would write.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from .object_store import ObjectStore
from .segment import DEFAULT_PARTITION, Segment


def _col_key(collection: str, segment_id: int, field: str) -> str:
    return f"binlog/{collection}/{segment_id}/col/{field}"


def _meta_key(collection: str, segment_id: int) -> str:
    return f"binlog/{collection}/{segment_id}/meta"


def index_key(collection: str, segment_id: int, field: str, kind: str) -> str:
    return f"index/{collection}/{segment_id}/{field}/{kind}"


def attr_key(collection: str, segment_id: int, field: str) -> str:
    return f"attr/{collection}/{segment_id}/{field}"


def _dump_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _load_array(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def _host(col) -> np.ndarray:
    return col.cpu().numpy() if torch.is_tensor(col) else np.asarray(col)


def write_segment_binlog(store: ObjectStore, seg: Segment) -> dict[str, str]:
    """Persist a sealed segment as columnar binlog objects; returns keys."""
    keys: dict[str, str] = {}
    columns = {"pk": seg.pks(), "vector": seg.vectors(), "ts": seg.timestamps()}
    for f in seg.extra_fields:
        columns[f] = seg.extra(f)
    for field, arr in columns.items():
        key = _col_key(seg.collection, seg.segment_id, field)
        store.put(key, _dump_array(np.ascontiguousarray(_host(arr))))
        keys[field] = key
    meta = {
        "segment_id": seg.segment_id,
        "collection": seg.collection,
        "shard": seg.shard,
        "partition": seg.partition,
        "dim": seg.dim,
        "num_rows": seg.num_rows,
        "checkpoint_pos": seg.checkpoint_pos,
        "fields": sorted(columns),
        "extra_fields": list(seg.extra_fields),
        "min_ts": seg.min_ts(),
        "max_ts": seg.max_ts(),
    }
    mk = _meta_key(seg.collection, seg.segment_id)
    store.put(mk, json.dumps(meta).encode())
    keys["meta"] = mk
    return keys


def read_binlog_meta(store: ObjectStore, collection: str, segment_id: int) -> dict:
    return json.loads(store.get(_meta_key(collection, segment_id)).decode())


def read_binlog_column(
    store: ObjectStore, collection: str, segment_id: int, field: str
) -> np.ndarray:
    """Fetch exactly one column as a host array."""
    return _load_array(store.get(_col_key(collection, segment_id, field)))


def load_segment(
    store: ObjectStore, collection: str, segment_id: int, device="cuda"
) -> Segment:
    """Reconstruct a sealed segment from its binlog columns onto ``device``."""
    meta = read_binlog_meta(store, collection, segment_id)
    seg = Segment(
        segment_id=meta["segment_id"],
        collection=collection,
        shard=meta["shard"],
        dim=meta["dim"],
        extra_fields=tuple(meta.get("extra_fields", ())),
        partition=meta.get("partition", DEFAULT_PARTITION),
        device=device,
    )
    if meta["num_rows"]:
        seg.append(
            read_binlog_column(store, collection, segment_id, "pk"),
            read_binlog_column(store, collection, segment_id, "vector"),
            read_binlog_column(store, collection, segment_id, "ts"),
            {
                f: read_binlog_column(store, collection, segment_id, f)
                for f in meta.get("extra_fields", ())
            },
        )
    seg.checkpoint_pos = meta["checkpoint_pos"]
    seg.seal()
    return seg


# -- attribute-index satellites: scalar columns (pk + 1-D extras) only -------


def _write_attr_satellites(
    store: ObjectStore, collection: str, segment_id: int, columns: dict[str, np.ndarray]
) -> dict[str, str]:
    from ..index.attribute import build_attribute_index

    keys: dict[str, str] = {}
    for field, arr in columns.items():
        arr = np.asarray(arr)
        if arr.ndim != 1:
            continue
        key = attr_key(collection, segment_id, field)
        store.put(key, build_attribute_index(arr).save())
        keys[field] = key
    return keys


def write_attr_satellites(store: ObjectStore, seg: Segment) -> dict[str, str]:
    """Build + persist attribute indexes for a sealed segment's scalar columns."""
    columns: dict[str, np.ndarray] = {"pk": _host(seg.pks())}
    for f in seg.extra_fields:
        columns[f] = seg.extra(f)
    return _write_attr_satellites(store, seg.collection, seg.segment_id, columns)


def rebuild_attr_satellites(
    store: ObjectStore, collection: str, segment_id: int
) -> dict[str, str]:
    """(Re)build attr satellites straight from binlog columns (recovery path)."""
    meta = read_binlog_meta(store, collection, segment_id)
    columns = {"pk": read_binlog_column(store, collection, segment_id, "pk")}
    for f in meta.get("extra_fields", ()):
        columns[f] = read_binlog_column(store, collection, segment_id, f)
    return _write_attr_satellites(store, collection, segment_id, columns)


def load_attr_satellites(
    store: ObjectStore, collection: str, segment_id: int, fields
) -> dict[str, object]:
    """Load whichever attr satellites exist for ``fields`` (missing ones are
    absent from the result; callers rebuild locally)."""
    from ..index.attribute import load_attribute_index

    out: dict[str, object] = {}
    for f in fields:
        key = attr_key(collection, segment_id, f)
        if store.exists(key):
            out[f] = load_attribute_index(store.get(key))
    return out


def list_segments(store: ObjectStore, collection: str) -> list[int]:
    """Ids of the segments with a binlog header in ``store``."""
    ids = set()
    for m in store.list(f"binlog/{collection}/"):
        parts = m.key.split("/")
        if len(parts) >= 3 and parts[-1] == "meta":
            ids.add(int(parts[2]))
    return sorted(ids)
