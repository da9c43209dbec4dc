"""Elasticity + failure recovery demo (paper Figs 2/9, §3.6), on the
PyTorch port (``examples/elastic_failover.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_elastic_failover.py
    PYTHONPATH=src python examples/torch_elastic_failover.py --device cpu

Replays a bursty workload against Manu: the latency-threshold autoscaler
adds/removes query nodes; mid-run we crash a node *mid-request* and show
the replica groups + HealthMonitor/StateReconciler loop restoring
identical results, introspected through the typed cluster-admin API.

Runs on the card unless ``--device cpu`` is given.  Exits non-zero unless
every failover answers the results it answered before (``results
identical: True``).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import ManuConfig, ManuSystem, SearchRequest  # noqa: E402


def sorted_pks(res) -> np.ndarray:
    """A search result's pks, each row sorted, as numpy."""
    return np.sort(res.pks.cpu().numpy(), 1)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    system = ManuSystem(
        ManuConfig(num_query_nodes=3, seal_rows=1_000, replication_factor=2), device=args.device
    )
    coll = system.create_collection("c", dim=64)
    coll.create_index("vector", kind="ivf_flat", params={"nlist": 16, "nprobe": 8})
    base = rng.standard_normal((8_000, 64)).astype(np.float32)
    for lo in range(0, 8_000, 2_000):
        coll.insert({"vector": base[lo : lo + 2_000]})
    coll.flush()
    q = rng.standard_normal((8, 64)).astype(np.float32)
    coll.search(q, limit=10)  # warmup

    d = coll.describe()
    print(f"collection {d.name!r}: {d.num_entities} rows, "
          f"replication_factor={d.replication_factor}, "
          f"index={d.index_on('vector').kind}")

    def live_nodes():
        return system.cluster_state().live_node_ids

    print("\n== elastic scaling on a bursty trace ==")
    for phase, load in enumerate([1, 4, 16, 16, 4, 1]):
        t0 = time.perf_counter()
        for _ in range(load):
            coll.search(q, limit=10)
        ms = (time.perf_counter() - t0) * 1e3 / max(len(live_nodes()), 1)
        action = "-"
        if ms > 60 and len(live_nodes()) < 8:
            system.add_query_node()
            action = "scale-up"
        elif ms < 15 and len(live_nodes()) > 2:
            system.remove_query_node()
            action = "scale-down"
        print(f"phase {phase}: load={load:>2} latency/node={ms:6.1f}ms "
              f"nodes={len(live_nodes())} action={action}")

    print("\n== mid-request failover ==")
    before = coll.search(q, limit=10, staleness_ms=0.0)
    cs = system.cluster_state()
    victim_id = next(p.replicas[0] for p in cs.placement if p.replicas)
    print(f"placement before: "
          f"{[(p.segment_id, p.replicas) for p in cs.placement]}")
    victim = system.query_nodes[victim_id]

    def dying(request):  # the node dies between planning and scan
        victim.alive = False
        raise RuntimeError("injected crash mid-request")

    victim.search_request = dying
    print(f"crashing {victim_id} mid-request ...")
    after = coll.search(q, limit=10, staleness_ms=0.0)
    same = bool((sorted_pks(before) == sorted_pks(after)).all())

    cs = system.cluster_state()
    statuses = {n.node_id: n.status for n in cs.nodes}
    reassigned = all(victim_id not in p.replicas for p in cs.placement)
    print(f"results identical: {same}")
    print(f"node statuses: {statuses}")
    print(f"dead node out of every replica group: {reassigned}; "
          f"under-replicated segments: {cs.under_replicated}")
    if not (same and reassigned):
        return 1
    print("placement after:  "
          f"{[(p.segment_id, p.replicas) for p in cs.placement]}")

    print("\n== traced failover: the span tree of a crash mid-request ==")
    while len(live_nodes()) < 2:  # the crash needs a surviving replica
        system.add_query_node()
    system.run_until_idle()  # survivors finish loading healed replicas
    event_mark = system.clock.now_ms()
    victim2_id = next(p.replicas[0] for p in system.cluster_state().placement
                      if p.replicas)
    victim2 = system.query_nodes[victim2_id]

    def dying2(request):
        victim2.alive = False
        raise RuntimeError("injected crash mid-request")

    victim2.search_request = dying2
    print(f"crashing {victim2_id} mid-request, trace=True ...")
    traced = coll.search(
        SearchRequest.single(q, field="vector", k=10, staleness_ms=0.0,
                             trace=True)
    )
    traced_same = bool((sorted_pks(before) == sorted_pks(traced)).all())
    print(f"traced failover, results identical: {traced_same}")
    if not traced_same:
        return 1
    print(traced.trace.format())

    print("\n== control-plane event log of the failover ==")
    for e in system.events(since_ts=event_mark):
        print(f"  {e.ts_ms:>9.0f} {e.kind:<22} {e.source:<13} {e.detail}")

    print("\n== kill -9, per-node restart, then whole-system restart ==")
    expect = sorted_pks(coll.search(q, limit=10, staleness_ms=0.0))
    system.kill_logger("logger-0")   # a Crash runs no cleanup: claims and
    system.kill_data_node("dn-0")    # half-written state leak, on purpose
    print("killed logger-0 and dn-0 (simulated kill -9, no cleanup ran)")
    system.restart_logger("logger-0")
    system.restart_data_node("dn-0")  # re-subscribes from its WAL checkpoint
    got = sorted_pks(coll.search(q, limit=10, staleness_ms=0.0))
    print(f"after node restarts, results identical: {(got == expect).all()}")
    if not (got == expect).all():
        return 1

    # Tear down EVERY process and rebuild coordinators, nodes and serving
    # state from the meta store + object store + WAL replay alone.
    report = system.restart()
    coll = system.collections["c"]  # collection handles are rebuilt too
    got = sorted_pks(coll.search(q, limit=10, staleness_ms=0.0))
    print(f"whole-system restart: tso_frontier={report['tso_frontier']} "
          f"seals_reconciled={report['seals_reconciled']} "
          f"results identical: {(got == expect).all()}")
    if not (got == expect).all():
        return 1

    print("\n== serving latency from the metrics registry ==")
    h = system.metrics().histogram("proxy_search_latency_us")
    print(f"  searches={h.count} p50={h.p50:.0f}us p95={h.p95:.0f}us "
          f"p99={h.p99:.0f}us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
