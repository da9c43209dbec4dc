"""The port's data model (on the CPU) against the reference: MVCC masks
across inserts, deletes, upserts and timestamps; binlog and FLAT index
bytes in both directions; the device guard and the index registry."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.binlog import load_segment as ref_load_segment  # noqa: E402
from repro.core.binlog import write_attr_satellites as ref_write_attr  # noqa: E402
from repro.core.binlog import write_segment_binlog as ref_write  # noqa: E402
from repro.core.collection import Metric as RefMetric  # noqa: E402
from repro.core.object_store import MemoryObjectStore as RefStore  # noqa: E402
from repro.core.segment import Segment as RefSegment  # noqa: E402
from repro.index.base import VectorIndex as RefVectorIndex  # noqa: E402
from repro.index.flat import FlatIndex as RefFlat  # noqa: E402
from repro_torch.core import binlog  # noqa: E402
from repro_torch.core.collection import Metric  # noqa: E402
from repro_torch.core.object_store import MemoryObjectStore  # noqa: E402
from repro_torch.core.segment import Segment, segment_from_columns  # noqa: E402
from repro_torch.index.base import IndexSpec, VectorIndex  # noqa: E402
from repro_torch.index.flat import FlatIndex  # noqa: E402
from repro_torch.index.registry import create_index  # noqa: E402


def _history(seg_cls, dim, rng_seed, **kw):
    """One seeded write history: appends, deletes, an upsert (delete +
    re-insert of the same pk at one ts) and a repeated delete."""
    rng = np.random.default_rng(rng_seed)
    seg = seg_cls(1, "c", 0, dim, **kw)
    for lo, ts in ((0, 100), (20, 110), (40, 130)):
        n = 20
        seg.append(
            np.arange(lo, lo + n),
            rng.standard_normal((n, dim)).astype(np.float32),
            np.full(n, ts, np.int64),
        )
    seg.delete(np.array([3, 25, 41, 999]), 120)
    seg.delete(np.array([5]), 140)
    seg.delete(np.array([7]), 150)  # upsert: delete half ...
    seg.append(np.array([7]), rng.standard_normal((1, dim)).astype(np.float32),
               np.array([150], np.int64))  # ... and insert half at the same ts
    seg.delete(np.array([3, 5]), 160)  # repeated deletes of dead pks
    return seg


def test_visible_mask_matches_reference():
    ref = _history(RefSegment, 6, 0)
    got = _history(Segment, 6, 0, device="cpu")
    assert got.num_rows == ref.num_rows
    for ts in (0, 100, 115, 120, 125, 130, 140, 149, 150, 155, 160, 10**9):
        np.testing.assert_array_equal(got.visible_mask(ts).numpy(), ref.visible_mask(ts))
    np.testing.assert_array_equal(got.delete_bitmap().numpy(), ref.delete_bitmap())
    np.testing.assert_allclose(got.unit_column().numpy(), ref.unit_column(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.pks().numpy(), ref.pks())
    np.testing.assert_array_equal(got.timestamps().numpy(), ref.timestamps())


def test_binlog_bytes_and_loads_match_reference():
    rng = np.random.default_rng(1)
    n, dim = 50, 8
    cols = {
        "pk": np.arange(100, 100 + n),
        "vector": rng.standard_normal((n, dim)).astype(np.float32),
        "ts": np.arange(10, 10 + n, dtype=np.int64),
        "price": rng.integers(0, 100, n),
    }
    ref_seg = RefSegment(4, "c", 1, dim, extra_fields=("price",), partition="p1")
    ref_seg.append(cols["pk"], cols["vector"], cols["ts"], {"price": cols["price"]})
    ref_seg.seal()
    got_seg = segment_from_columns(cols, 4, "c", shard=1, partition="p1", device="cpu")

    ref_store, got_store = RefStore(), MemoryObjectStore()
    ref_keys = ref_write(ref_store, ref_seg)
    got_keys = binlog.write_segment_binlog(got_store, got_seg)
    assert ref_keys == got_keys
    for key in ref_keys.values():
        assert got_store.get(key) == ref_store.get(key), key

    loaded = binlog.load_segment(ref_store, "c", 4, device="cpu")  # reference bytes
    assert (loaded.shard, loaded.partition, loaded.extra_fields) == (1, "p1", ("price",))
    np.testing.assert_array_equal(loaded.vectors().numpy(), cols["vector"])
    np.testing.assert_array_equal(loaded.pks().numpy(), cols["pk"])
    np.testing.assert_array_equal(loaded.extra("price"), cols["price"])
    back = ref_load_segment(got_store, "c", 4)  # port bytes, reference reader
    np.testing.assert_array_equal(back.vectors(), cols["vector"])

    ref_write_attr(ref_store, ref_seg)
    sats = binlog.load_attr_satellites(ref_store, "c", 4, ["pk", "price"])
    assert sorted(sats) == ["pk", "price"]
    np.testing.assert_array_equal(sats["price"].op_mask("lt", 50), cols["price"] < 50)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_flat_index_bytes_cross_load(metric):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    ref = RefFlat(metric=RefMetric(metric))
    ref.build(x)
    got = VectorIndex.load(ref.save(), device="cpu")
    assert isinstance(got, FlatIndex) and got.metric is Metric(metric) and got.num_rows == 40
    np.testing.assert_array_equal(got.vectors.numpy(), ref.vectors)
    ws, wi = ref.search(q, 5)
    gs, gi = got.search(torch.from_numpy(q), 5)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), wi)
    again = RefVectorIndex.load(got.save())
    np.testing.assert_array_equal(again.vectors, ref.vectors)


def test_device_guard_and_registry():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Segment(1, "c", 0, 4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32))
    for kind in ("hnsw", "bucket"):
        idx = create_index(IndexSpec(kind), device="cpu")
        idx.build(x)
        assert idx.KIND == kind and idx.num_rows == 300
        _s, i = idx.search(x[:2], 3)
        assert i[:, 0].tolist() == [0, 1]
    with pytest.raises(KeyError):
        create_index(IndexSpec("no_such_kind"), device="cpu")
    with pytest.raises(TypeError):
        Segment(1, "c", 0, 2, device="cpu").append(
            np.array(["a"]), np.zeros((1, 2), np.float32), np.zeros(1, np.int64)
        )
