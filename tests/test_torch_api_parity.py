"""Reference surfaces the port carries beside its main path, against the
reference on seeded numpy inputs: the attribute indexes' ``range_mask`` /
``eq_mask`` / ``in_mask``, ``timestamp.add_ms`` and the ``Timestamp``
view, the legacy ``insert`` / ``delete`` of the proxy and the logger, and
``core.proxy``'s re-export of ``BatchingProxy`` / ``RequestScheduler``.
Masks, counts and pks must match exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro.core.proxy as ref_proxy  # noqa: E402
import repro.core.scheduler as ref_scheduler  # noqa: E402
import repro.core.timestamp as ref_ts  # noqa: E402
from repro.index import attribute as ref_attr  # noqa: E402

import repro_torch.core as port  # noqa: E402
import repro_torch.core.proxy as port_proxy  # noqa: E402
import repro_torch.core.scheduler as port_scheduler  # noqa: E402
import repro_torch.core.timestamp as port_ts  # noqa: E402
from repro_torch.index import attribute as port_attr  # noqa: E402

CONFIG = dict(num_query_nodes=2, num_index_nodes=1, seal_rows=300, slice_rows=128)


def _values(kind: str, rng):
    if kind == "int":
        return rng.integers(-20, 20, 400)
    if kind == "float":
        v = rng.standard_normal(400).astype(np.float32)
        v[::7] = np.round(v[::7])  # repeated values on the bounds below
        return v
    return np.array([f"tag{i}" for i in rng.integers(0, 9, 400)])


BOUNDS = [(None, None), (-3, None), (None, 2), (-3, 2), (2, -3), (0, 0), (-100, 100), (1.5, 1.5)]


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("lo,hi", BOUNDS)
@pytest.mark.parametrize("lo_open,hi_open", [(False, False), (True, False), (False, True), (True, True)])
def test_range_mask_matches_reference(kind, lo, hi, lo_open, hi_open):
    values = _values(kind, np.random.default_rng(len(kind)))
    want = ref_attr.SortedListIndex(values).range_mask(lo, hi, lo_open, hi_open)
    got = port_attr.SortedListIndex(values).range_mask(lo, hi, lo_open, hi_open)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    # and after a save / load round trip of the port's index
    loaded = port_attr.load_attribute_index(port_attr.SortedListIndex(values).save())
    np.testing.assert_array_equal(loaded.range_mask(lo, hi, lo_open, hi_open), want)


@pytest.mark.parametrize("kind", ["int", "str"])
def test_label_masks_match_reference(kind):
    values = _values(kind, np.random.default_rng(5))
    want_idx, got_idx = ref_attr.LabelIndex(values), port_attr.LabelIndex(values)
    present = [values[0].item(), values[3].item()]
    absent = [-99] if kind == "int" else ["none"]
    for v in present + absent:
        np.testing.assert_array_equal(got_idx.eq_mask(v), want_idx.eq_mask(v))
    for vs in (present, present + absent, absent, []):
        np.testing.assert_array_equal(got_idx.in_mask(vs), want_idx.in_mask(vs))
    # eq_mask hands out a copy: writing to it leaves the index as it was
    got_idx.eq_mask(present[0])[:] = False
    np.testing.assert_array_equal(got_idx.eq_mask(present[0]), want_idx.eq_mask(present[0]))


@pytest.mark.parametrize("ms", [0, 1, 7.9, 250, 10**6])
def test_add_ms_and_timestamp_view_match_reference(ms):
    rng = np.random.default_rng(int(ms))
    for phys, logical in zip(rng.integers(0, 2**40, 5), rng.integers(0, port_ts.MAX_LOGICAL, 5)):
        ts = port_ts.pack(int(phys), int(logical))
        assert ts == ref_ts.pack(int(phys), int(logical))
        assert port_ts.add_ms(ts, ms) == ref_ts.add_ms(ts, ms)
        got, want = port_ts.Timestamp.unpack(ts), ref_ts.Timestamp.unpack(ts)
        assert (got.physical_ms, got.logical) == (want.physical_ms, want.logical)
        assert got.packed() == want.packed() == ts
        assert repr(got) == f"HLC({int(phys)}ms+{int(logical)})"
        assert got == port_ts.Timestamp(int(phys), int(logical))


def _legacy(pkg, via: str):
    """Legacy insert / delete through the proxy or a logger, then a STRONG
    search: (row count, lsns increasing, pks of the search)."""
    kw = {"device": "cpu"} if pkg is port else {}
    manu = pkg.ManuSystem(pkg.ManuConfig(**CONFIG), **kw)
    coll = manu.create_collection("legacy", dim=8)
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((500, 8)).astype(np.float32)
    target = manu.proxy if via == "proxy" else manu.loggers[0]
    lsn_i, count = target.insert(coll.info, {"pk": np.arange(500), "vector": rows})
    lsn_d = target.delete(coll.info, np.arange(0, 500, 3))
    q = rng.standard_normal((3, 8)).astype(np.float32)
    res = coll.search(q, limit=10, staleness_ms=0.0)
    pks = res.pks.numpy() if torch.is_tensor(res.pks) else np.asarray(res.pks)
    return count, isinstance(lsn_i, int) and isinstance(lsn_d, int) and lsn_d > lsn_i, pks


@pytest.mark.parametrize("via", ["proxy", "logger"])
def test_legacy_insert_delete_match_reference(via):
    got, want = _legacy(port, via), _legacy(ref, via)
    assert got[0] == want[0] == 500
    assert got[1] and want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert not np.isin(got[2], np.arange(0, 500, 3)).any()


def test_proxy_reexports_the_scheduler_like_the_reference():
    for name in ("BatchingProxy", "RequestScheduler"):
        assert getattr(ref_proxy, name) is getattr(ref_scheduler, name)
        assert getattr(port_proxy, name) is getattr(port_scheduler, name)
    assert port_proxy.BatchingProxy is port.BatchingProxy
    assert ref_proxy.BatchingProxy is ref.BatchingProxy
