"""String primary keys through the port's ``ManuSystem`` on the CPU.

The reference ingests string keys (``tests/test_mutation_api.py:455``): the
loggers route each row by the hash of its key.  The port routes them the
same way and writes int64 surrogate ids (``IdAllocator.string_ids``) into
the rows, tombstones and binlogs; each WAL record carries the user's keys
beside their ids.  Ingest is held to the reference (acknowledgement,
routing, ``num_entities``); deletes, upserts, seals, compaction and
``restart()`` to the keys' own semantics; a search over such a collection
raises ``TypeError`` at the call (the reference's fails in its merge) and
leaves the system serving.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro.core.log import dml_channel as ref_dml_channel  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DeleteRequest,
    FieldSchema,
    FieldType,
    InsertRequest,
    ManuConfig,
    ManuSystem,
    Schema,
    UpsertRequest,
)
from repro_torch.core.log import dml_channel, shards_of_pks  # noqa: E402

CONFIG = dict(num_query_nodes=2, seal_rows=200, slice_rows=64, num_shards=2)
KEYS = np.array([f"doc-{i}" for i in range(100)])


def _schema(schema, field, ftype):
    return schema((field("pk", ftype.STRING, is_primary=True), field("vector", ftype.VECTOR, dim=4)))


def _system():
    system = ManuSystem(ManuConfig(**CONFIG), device="cpu")
    return system, system.create_collection("s", dim=4, schema=_schema(Schema, FieldSchema, FieldType))


def _vectors(seed: int = 0, n: int = 100) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)


def _second_collection_serves(system, seed: int = 5) -> None:
    """A mutate and a STRONG search of an int-pk collection: the answer is
    the exact top-5 of its rows."""
    other = system.create_collection(f"ints{seed}", dim=4)
    x = _vectors(seed, 60)
    res = other.mutate(InsertRequest({"vector": x}))
    assert res.row_count == 60
    q = _vectors(seed + 1, 3)
    got = other.search(q, limit=5, staleness_ms=0.0)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.pks.cpu().numpy(), np.argsort(d2, 1, kind="stable")[:, :5])
    assert other.num_entities() == 60


def test_string_pk_rows_route_by_hash_as_the_reference():
    vecs = _vectors()
    ref = ref_core.ManuSystem(ref_core.ManuConfig(**CONFIG))
    ref_coll = ref.create_collection("s", dim=4, schema=_schema(
        ref_core.Schema, ref_core.FieldSchema, ref_core.FieldType))
    ref_res = ref_coll.mutate(ref_core.InsertRequest({"pk": KEYS, "vector": vecs}))

    system, coll = _system()
    res = coll.mutate(InsertRequest({"pk": KEYS, "vector": vecs}))
    assert res.row_count == ref_res.row_count == 100
    assert set(res.shard_lsns) == set(ref_res.shard_lsns) == {0, 1}
    np.testing.assert_array_equal(res.pks, KEYS)
    seen, ids = [], []
    for shard in range(2):
        ref_keys = [k for e in ref.broker.read(ref_dml_channel("s", shard), 0)
                    if "pk" in e.payload for k in e.payload["pk"].tolist()]
        port_keys = []
        for e in system.broker.read(dml_channel("s", shard), 0):
            if "user_pk" in e.payload:
                got = e.payload["user_pk"]
                np.testing.assert_array_equal(shards_of_pks(got, 2), np.full(len(got), shard))
                assert e.payload["pk"].dtype == np.int64 and len(e.payload["pk"]) == len(got)
                port_keys.extend(got.tolist())
                ids.extend(e.payload["pk"].tolist())
        assert port_keys == ref_keys  # same rows on the same channel, in order
        seen.extend(port_keys)
    assert sorted(seen) == sorted(KEYS.tolist())
    # dense ids, one per key, in the order the keys were written
    id_of = dict(zip(seen, ids))
    assert sorted(ids) == list(range(100))
    assert [id_of[k] for k in KEYS.tolist()] == list(range(100))
    assert coll.num_entities() == ref_coll.num_entities() == 100


def test_string_pk_insert_leaves_the_system_serving():
    system, coll = _system()
    coll.mutate(InsertRequest({"pk": KEYS, "vector": _vectors()}))
    assert coll.num_entities() == 100
    _second_collection_serves(system)
    # a search of the string collection raises at the call, and harms nothing
    with pytest.raises(TypeError, match="string primary keys"):
        coll.search(_vectors(9, 2), limit=5, staleness_ms=0.0)
    _second_collection_serves(system, seed=7)
    assert coll.num_entities() == 100


def test_string_pk_delete_upsert_seal_compact_restart():
    system, coll = _system()
    coll.mutate(InsertRequest({"pk": KEYS, "vector": _vectors()}))
    res = coll.mutate(DeleteRequest(KEYS[:10]))
    assert res.ack_rows == 10
    assert coll.num_entities() == 100  # tombstoned rows stay until compaction
    # keys never written match nothing: no WAL record, ack 0
    nothing = coll.mutate(DeleteRequest(np.array(["nope", "doc-x"])))
    assert nothing.ack_rows == 0 and nothing.shard_lsns == {}
    # an upsert of live keys replaces them under their ids; a new key is appended
    up = coll.mutate(UpsertRequest({"pk": np.array(["doc-50", "doc-51", "new-0"]),
                                    "vector": _vectors(3, 3)}))
    assert up.row_count == 3
    coll.flush()
    assert coll.num_entities() == 103  # 100 + the upsert's three rows, versions not yet purged
    coll.compact()
    # compaction purges the 10 deleted rows and the 2 replaced versions
    assert coll.num_entities() == 91
    system.restart()
    coll = system.collections["s"]
    assert coll.num_entities() == 91
    # the ids survive the restart: a delete of a key written before it finds its rows
    assert coll.mutate(DeleteRequest(np.array(["doc-20", "new-0"]))).ack_rows == 2
    coll.mutate(InsertRequest({"pk": np.array(["doc-0"]), "vector": _vectors(4, 1)}))
    ids = [e.payload["pk"] for shard in range(2)
           for e in system.broker.read(dml_channel("s", shard), 0) if "user_pk" in e.payload
           and e.payload["user_pk"].tolist() == ["doc-0"]]
    assert [int(i[0]) for i in ids][-1] == 0  # a deleted key written again keeps its id
    _second_collection_serves(system)
