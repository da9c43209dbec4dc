"""Quickstart: the declarative request API end to end, on the PyTorch port
(``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Creates a multi-vector collection (a text embedding + an image embedding +
a price attribute), streams inserts through the log backbone, builds one
IVF index per vector field, then exercises the typed ``SearchRequest``
surface: consistency levels, hybrid (multi-vector) search under weighted
and RRF fusion, filtered range search, output-field hydration, and time
travel — plus the legacy kwarg facade, which runs through the exact same
pipeline.  Ends with the serving tier: async micro-batched ingest under
typed backpressure and plan-shape-grouped batched reads.

Runs on the card unless ``--device cpu`` is given.  Search results are
device tensors (``host`` brings them to numpy).  Exits non-zero unless the
deleted pks vanish from the top-5 and come back under time travel.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    AdmissionRejected,
    AnnsQuery,
    ConsistencyLevel,
    FieldSchema,
    FieldType,
    InsertRequest,
    ManuConfig,
    ManuSystem,
    Metric,
    Ranker,
    SearchRequest,
)


def host(x) -> np.ndarray:
    """A result's tensor (on any device) or array as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    # The small ingest queue makes the serving-tier scene below actually
    # hit backpressure (AdmissionRejected) with 200-row async chunks.
    manu = ManuSystem(ManuConfig(num_query_nodes=2, num_index_nodes=1,
                                 seal_rows=1_000, slice_rows=512,
                                 ingest_queue_rows=512,
                                 ingest_flush_rows=1_024), device=args.device)
    coll = manu.create_collection(
        "products", dim=64, metric=Metric.L2,
        extra_fields=[
            FieldSchema("img_vec", FieldType.VECTOR, dim=32),
            FieldSchema("price", FieldType.FLOAT),
        ],
    )
    # One index spec per vector field (paper §3.5: per-field build tasks).
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 16, "nprobe": 8})
    coll.create_index("img_vec", kind="ivf_flat", params={"nlist": 8, "nprobe": 8})

    rng = np.random.default_rng(0)
    text_vecs = rng.standard_normal((5_000, 64)).astype(np.float32)
    img_vecs = rng.standard_normal((5_000, 32)).astype(np.float32)
    prices = rng.uniform(1, 500, 5_000)
    for lo in range(0, 5_000, 1_000):
        coll.insert({"vector": text_vecs[lo:lo + 1_000],
                     "img_vec": img_vecs[lo:lo + 1_000],
                     "price": prices[lo:lo + 1_000]})
    print(f"ingested 5000 rows; sealed segments: "
          f"{manu.data_coord.sealed_segments('products')}")

    tq = rng.standard_normal((1, 64)).astype(np.float32)
    iq = rng.standard_normal((1, 32)).astype(np.float32)

    # ---- consistency: named levels or an explicit staleness bound -------
    strong = coll.search(SearchRequest.single(tq, k=5,
                                              consistency=ConsistencyLevel.STRONG))
    bounded = coll.search(SearchRequest.single(tq, k=5, staleness_ms=100.0))
    eventual = coll.search(SearchRequest.single(tq, k=5))
    print("strong   :", strong.pks[0])
    print("bounded  :", bounded.pks[0])
    print("eventual :", eventual.pks[0])

    # ---- hybrid multi-vector search ------------------------------------
    weighted = coll.search(SearchRequest(
        anns=[AnnsQuery("vector", tq, weight=0.7),
              AnnsQuery("img_vec", iq, weight=0.3)],
        k=5, staleness_ms=0.0, output_fields=("price",),
    ))
    rrf = coll.hybrid_search(
        [AnnsQuery("vector", tq), AnnsQuery("img_vec", iq)],
        limit=5, ranker=Ranker.rrf(), staleness_ms=0.0,
    )
    print("hybrid weighted :", weighted.pks[0],
          "prices:", np.round(weighted.fields["price"][0], 1))
    print("hybrid rrf      :", rrf.pks[0])

    # ---- filtered range search -----------------------------------------
    radius = float(np.sort(host(strong.scores[0]))[-1]) * 1.2
    cheap_near = coll.search(SearchRequest.single(
        tq, k=10, staleness_ms=0.0, filter="price < 50", radius=radius,
        output_fields=("price",),
    ))
    live = host(cheap_near.pks[0])[host(cheap_near.pks[0]) >= 0]
    print(f"price<50 within radius {radius:.1f}:", live,
          "prices:", np.round(cheap_near.fields["price"][0][:len(live)], 1))

    # ---- selectivity-adaptive filtered search ---------------------------
    # Every sealed segment carries attribute-index satellites (built at
    # seal, persisted next to the binlog).  The planner estimates each
    # filter's selectivity per segment and picks a strategy: pre-filter
    # (bitmap-masked scan), post-filter (inflated-k scan, then cut), or
    # brute (gather the few surviving rows).  ``filter_strategy`` forces
    # one globally — "price < 25" is tight, so adaptive chooses brute and
    # matches the forced-brute answer exactly; pre/post run the IVF index
    # (approximate at nprobe < nlist) and may differ.
    by_strategy = {}
    for strategy in (None, "pre", "post", "brute"):
        by_strategy[strategy] = coll.search(SearchRequest.single(
            tq, k=5, staleness_ms=0.0, filter="price < 25",
            filter_strategy=strategy,
        ))
    assert np.array_equal(host(by_strategy[None].pks), host(by_strategy["brute"].pks))
    chosen = {k.split('"')[1]: int(v)
              for k, v in manu.metrics().counters.items()
              if k.startswith("filter_strategy_total")}
    print("price<25 top-5 :", by_strategy[None].pks[0],
          "strategy picks:", chosen)

    # ---- deletes, MVCC, time travel ------------------------------------
    victims = host(strong.pks[0])[:2]
    coll.delete(victims)
    after = coll.search(tq, limit=5, staleness_ms=0.0)  # legacy facade
    print(f"deleted {victims}; new top-5: {after.pks[0]}")

    manu.checkpoint_collection("products")
    rollback = coll.search(tq, limit=5, time_travel_ts=strong.query_ts)
    print("time-travel top-5 (deleted rows resurrected):", rollback.pks[0])
    vanished = not set(victims.tolist()) & set(host(after.pks[0]).tolist())
    back = set(victims.tolist()) <= set(host(rollback.pks[0]).tolist())
    print(f"check: deleted pks vanished from the top-5: {vanished}; back under time travel: {back}")
    if not (vanished and back):
        return 1

    # ---- upsert: atomic replace at one timestamp ------------------------
    # Replace the current best match's vectors in ONE WAL record: the old
    # version dies and the new one appears at the same LSN, and the
    # MutationResult watermark feeds a read-your-writes SESSION search.
    target = int(host(after.pks[0])[0])
    res = coll.upsert({
        "pk": np.array([target]),
        "vector": rng.standard_normal((1, 64)).astype(np.float32),
        "img_vec": rng.standard_normal((1, 32)).astype(np.float32),
        "price": np.array([9.99]),
    })
    fresh = coll.search(res.session_request(tq, k=5))
    print(f"upserted pk={target} at LSN {res.watermark_ts}; "
          f"session top-5: {fresh.pks[0]}")
    was = coll.search(tq, limit=5, time_travel_ts=res.watermark_ts - 1)
    print("one tick earlier the old version still answers:", was.pks[0])

    # ---- partitions: placement + pruned search --------------------------
    catalog = manu.create_collection("catalog", dim=16, seal_rows=500)
    for season in ("summer", "winter"):
        catalog.create_partition(season)
    summer = rng.standard_normal((1_000, 16)).astype(np.float32)
    winter = rng.standard_normal((1_000, 16)).astype(np.float32)
    catalog.insert(InsertRequest({"vector": summer}, partition="summer"))
    catalog.insert(InsertRequest({"vector": winter}, partition="winter"))
    catalog.flush()
    cq = rng.standard_normal((1, 16)).astype(np.float32)
    everywhere = catalog.search(cq, limit=5, staleness_ms=0.0)
    only_summer = catalog.search(SearchRequest.single(
        cq, k=5, staleness_ms=0.0, partition_names=("summer",),
    ))
    print("catalog partitions:", catalog.partitions())
    print("all partitions :", everywhere.pks[0])
    print("summer only    :", only_summer.pks[0],
          "(planner skipped every winter segment)")

    # ---- serving tier: async mixed workload -----------------------------
    # Writes enter through the request scheduler's bounded queues and are
    # micro-batched cross-user into single WAL crossings; a full queue
    # rejects at admission time with the typed AdmissionRejected error.
    # Reads queue in the batcher and group by plan shape: one proxy search
    # per group, split back per request.
    jobs = manu.create_collection("jobs", dim=16,
                                  extra_fields=[FieldSchema("price",
                                                            FieldType.FLOAT)])
    tickets = []
    for _ in range(6):
        chunk = {"vector": rng.standard_normal((200, 16)).astype(np.float32),
                 "price": rng.uniform(1, 100, 200)}
        try:
            tickets.append(jobs.insert_async(chunk))
        except AdmissionRejected as e:
            print(f"backpressure: {e.pending_rows}/{e.capacity_rows} rows "
                  f"pending on shard {e.shard}; flushing")
            manu.flush_ingest()  # returns the credits
            tickets.append(jobs.insert_async(chunk))
    manu.flush_ingest()
    lsns = [t.result().watermark_ts for t in tickets]
    assert len(set(lsns)) == len(tickets)  # one LSN per request, batched WAL
    print(f"async-ingested {6 * 200} rows in "
          f"{int(manu.metrics().counters.get('logger_batches_total', 0))} "
          f"WAL batch crossings; one LSN each: {lsns}")

    jq = rng.standard_normal((3, 16)).astype(np.float32)
    idx_cheap = [manu.batcher.submit_request(jobs.info, SearchRequest.single(
        jq[i:i + 1], field="vector", k=3, staleness_ms=0.0,
        filter="price < 50", output_fields=("price",))) for i in range(3)]
    idx_bounded = manu.batcher.submit_request(jobs.info, SearchRequest.single(
        jq[:1], field="vector", k=3, consistency=ConsistencyLevel.BOUNDED))
    batched = manu.batcher.flush(wait_fn=manu._cooperative_wait)
    print("batched cheap top-3:", [batched[i].pks[0] for i in idx_cheap],
          "| bounded top-3:", batched[idx_bounded].pks[0])

    print("\nsystem stats:", {k: v for k, v in manu.stats().items() if k != "log"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
