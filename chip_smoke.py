#!/usr/bin/env python3
"""Smoke run of the repro_torch port on one NVIDIA GPU.

    python3 chip_smoke.py            (from the root of a checkout)

1. Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Kernel phase: each kernel against its plain PyTorch version on the card
   (L2 and IP, k in {1, 100, 1024}, ragged and all-invalid segments,
   duplicate, negative and >int32 pks, inf/NaN/-0.0 scores, merge pools
   wider than one launch takes).  Scores are held to
   ``repro_torch.testing.SCORE_TOL``, set from the measured float32 error;
   the main-path check also shows that a TF32 product would fail it.
3. Main path at VectorDBBench's Performance768D1M scale (1M x 768, top-100;
   synthetic data from --seed): an L2 and a cosine collection, each as
   seven 131,072-row sealed segments written to and loaded from the binlog
   (three FLAT-indexed through ``load_index``) plus 82,496 rows ingested as
   INSERT log entries into a growing segment; 1% of pks deleted; segments
   split across two QueryNodes on the card; requests at nq=1 and nq=100
   pinned before and after the delete, each through both nodes and a
   global ``merge_topk``, checked against an exact brute-force top-k over
   the visible rows (plain torch).  Both kernels' launch counters must move.
4. Prints phase times, request latencies, one JSON line of kernel
   measurements, the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

N_ROWS, DIM, K = 1_000_000, 768, 100
SEG_ROWS, N_SEALED = 131_072, 7
FLAT_SEGMENTS = (0, 1, 4)
NODE_A, NODE_B = (0, 1, 2, 3), (4, 5, 6)
DELETE_FRAC = 0.01
INSERT_BATCH = 8_192
# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM3 and f32 outside the
# tensor cores, the unit these kernels use.
PEAK_BYTES_S, PEAK_F32_FLOPS = 3.35e12, 67e12
# Log timestamps: sealed rows, WAL inserts, deletes, and the two pins.
TS_SEALED, TS_GROW, TS_DELETE = 1_000, 2_000, 3_000
TS_BEFORE, TS_AFTER = 2_500, 3_500


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_request(torch, fn, label: str) -> None:
    """One warm request under torch.profiler: wall time, device busy time
    (sum of kernel self times; one stream, so no overlap), the kernels and
    host ops that take the most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top_dev = sorted(events, key=dev_us, reverse=True)[:6]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    if busy_ms == 0:
        log(f"profile {label}: wall {wall_ms:.3f} ms, the profiler recorded no device time")
        return
    log(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f})")
    log("  device: " + "; ".join(f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.3f} ms" for e in top_dev))
    log("  host: " + "; ".join(
        f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms" for e in top_cpu
    ))


def kernel_phase(torch, l2_mod, merge_mod, ops, assert_scan_close, tol, dev, gen) -> dict:
    """Every kernel against its plain version; returns max |err| per kernel.
    Scores are held to ``tol[metric]`` (the measured float32 error, see
    ``repro_torch.testing.SCORE_TOL``); merges must be bit-exact."""
    err = {"l2_topk": 0.0, "merge_topk": 0.0}
    sizes = [0, 1, 700, SEG_ROWS, 5_000, N_ROWS - N_SEALED * SEG_ROWS]
    bases = [torch.randn((n, DIM), generator=gen, device=dev) for n in sizes]
    valids = [
        None,
        torch.ones(1, dtype=torch.bool, device=dev),
        torch.rand(700, generator=gen, device=dev) > 0.3,
        torch.rand(SEG_ROWS, generator=gen, device=dev) > 0.01,
        torch.zeros(5_000, dtype=torch.bool, device=dev),  # all invalid
        None,
    ]
    for nq in (1, 100):
        q = torch.randn((nq, DIM), generator=gen, device=dev)
        for metric in ("l2", "ip"):
            for k in (1, 100, 1024):
                got = l2_mod.l2_topk(q, bases, valids, k, metric)
                want = l2_mod.l2_topk_plain(q, bases, valids, k, metric)
                torch.cuda.synchronize()
                assert_scan_close(got, want, q, bases, valids, k, metric, *tol[metric])
                fin = torch.isfinite(want[0])
                e = (got[0][fin] - want[0][fin]).abs().max().item() if fin.any() else 0.0
                err["l2_topk"] = max(err["l2_topk"], e)
    # (k, pool width): the main path's node (4 units) and global (2 nodes)
    # merges at k=100, the extremes, and pools wider than one launch takes,
    # which ops.merge_topk merges in chunks.
    wide = 2 * merge_mod.MAX_M + 300
    cases = ((1, 8), (100, 200), (100, 400), (100, 800), (1024, merge_mod.MAX_M), (100, wide), (1024, wide))
    for k, m in cases:
        s = torch.randn((100, m), generator=gen, device=dev)
        s[:, ::5] = torch.round(s[:, ::5])
        s[:, 3::11] = -0.0
        s[:, 5::13] = float("inf")
        s[:, 6::17] = float("nan")
        s[:, 8::19] = float("-inf")
        p = torch.randint(-2, max(2, m // 3), (100, m), generator=gen, device=dev)
        p[:, ::23] += 2**40
        merge = merge_mod.merge_topk if m <= merge_mod.MAX_M else ops.merge_topk
        for metric in ("l2", "ip"):
            gv, gp = merge(s, p, k, metric)
            wv, wp = merge_mod.merge_topk_plain(s, p, k, metric)
            torch.cuda.synchronize()
            if not torch.equal(gp, wp) or not torch.equal(gv, wv):
                raise AssertionError(f"merge_topk differs from its plain version (k={k}, M={m}, {metric})")
            fin = torch.isfinite(wv)
            e = (gv[fin] - wv[fin]).abs().max().item() if fin.any() else 0.0
            err["merge_topk"] = max(err["merge_topk"], e)
    log(f"kernel phase: l2_topk 24 cases agree (rtol, atol: l2 {tol['l2']}, ip {tol['ip']}), "
        f"merge_topk {2 * len(cases)} cases bit-exact (widths up to {wide}); max |err| {err}")
    return err


def tf32_control(torch, q, x, want_s, largest: bool, rtol: float, atol: float) -> float:
    """The exact check's teeth: the same top-k from a TF32 product must fall
    outside the tolerance.  Returns the TF32 product's largest score error."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qx = q @ x.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if largest:
        scores = qx
    else:
        scores = ((q * q).sum(1, keepdim=True) - 2.0 * qx) + (x * x).sum(1)[None, :]
    tf_s = torch.topk(scores, want_s.shape[1], dim=1, largest=largest).values
    e = (tf_s - want_s).abs()
    if not bool((e > atol + rtol * want_s.abs()).any()):
        raise AssertionError(
            f"a TF32 product passes the score tolerance (rtol={rtol}, atol={atol}, "
            f"max |err| {e.max().item():.3g}): the check cannot tell it from float32"
        )
    return e.max().item()


def build_collection(torch, store, gen, dev, name: str, metric):
    """Seeded 1M x 768 rows on the card: 7 sealed segments written to the
    binlog (3 with FLAT indexes) and the tail kept for the WAL."""
    from repro_torch.core.binlog import index_key, write_segment_binlog
    from repro_torch.core.segment import segment_from_columns
    from repro_torch.index.flat import FlatIndex

    x = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
    pks = torch.arange(N_ROWS, dtype=torch.int64, device=dev)
    for s in range(N_SEALED):
        lo, hi = s * SEG_ROWS, (s + 1) * SEG_ROWS
        seg = segment_from_columns(
            {"pk": pks[lo:hi], "vector": x[lo:hi],
             "ts": torch.full((SEG_ROWS,), TS_SEALED, dtype=torch.int64, device=dev)},
            segment_id=s, collection=name, device=dev,
        )
        write_segment_binlog(store, seg)
        if s in FLAT_SEGMENTS:
            idx = FlatIndex(metric, device=dev)
            idx.build(x[lo:hi])
            store.put(index_key(name, s, "vector", "flat"), idx.save())
            del idx
        del seg
    return x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import log as wal
    from repro_torch.core.collection import Metric
    from repro_torch.core.consistency import GuaranteeTs
    from repro_torch.core.object_store import MemoryObjectStore
    from repro_torch.core.query_node import QueryNode
    from repro_torch.core.request import AnnsQuery, NodeSearchRequest
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import l2_topk as l2_mod
    from repro_torch.kernels import merge_topk as merge_mod
    from repro_torch.testing import SCORE_TOL, assert_scan_close

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    phases: dict[str, float] = {}

    t0 = time.perf_counter()
    for name, text in _build.build_all().items():
        log(f"nvcc {name}: " + " | ".join(
            ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln
        ))
    phases["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    max_err = kernel_phase(torch, l2_mod, merge_mod, ops, assert_scan_close, SCORE_TOL, dev, gen)
    phases["kernel_phase_s"] = time.perf_counter() - t0

    # ---------------------------------------------------------- main path
    t0 = time.perf_counter()
    store = MemoryObjectStore()
    colls = {"vdb_l2": Metric.L2, "vdb_cosine": Metric.COSINE}
    data = {name: build_collection(torch, store, gen, dev, name, m) for name, m in colls.items()}
    torch.cuda.synchronize()
    phases["data_and_binlog_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    broker = wal.LogBroker()
    broker.create_channel("coord")
    nodes = {
        nid: QueryNode(nid, broker, store, slice_rows=SEG_ROWS, device=dev)
        for nid in ("qn-a", "qn-b")
    }
    for name in colls:
        for nid, sids in (("qn-a", NODE_A), ("qn-b", NODE_B)):
            for s in sids:
                nodes[nid].load_sealed(name, s)
                if s in FLAT_SEGMENTS:
                    nodes[nid].load_index(name, s, "flat", f"index/{name}/{s}/vector/flat")
    torch.cuda.synchronize()
    phases["load_sealed_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tail = N_SEALED * SEG_ROWS
    deleted = {}
    for name in colls:
        ch = wal.dml_channel(name, 0)
        broker.create_channel(ch)
        nodes["qn-b"].subscribe(ch)
        x_tail = data[name][tail:].cpu().numpy()
        for j, lo in enumerate(range(0, len(x_tail), INSERT_BATCH)):
            hi = min(lo + INSERT_BATCH, len(x_tail))
            broker.publish(ch, wal.LogEntry(TS_GROW + j, wal.EntryType.INSERT, {
                "collection": name, "segment_id": N_SEALED, "shard": 0,
                "pk": np.arange(tail + lo, tail + hi), "vector": x_tail[lo:hi],
            }))
    for node in nodes.values():
        node.step()
    for i, name in enumerate(colls):
        doomed = torch.randperm(N_ROWS, generator=gen, device=dev)[: int(N_ROWS * DELETE_FRAC)]
        deleted[name] = doomed
        pk = doomed.cpu().numpy()
        broker.publish(wal.dml_channel(name, 0),
                       wal.LogEntry(TS_DELETE + i, wal.EntryType.DELETE, {"collection": name, "pk": pk}))
        broker.publish("coord", wal.LogEntry(TS_DELETE + i, wal.EntryType.COORD,
                                             {"msg": "tombstones", "collection": name, "pk": pk}))
    for node in nodes.values():
        node.step()
    torch.cuda.synchronize()
    phases["ingest_and_delete_s"] = time.perf_counter() - t0
    if sum(seg.num_rows for seg in nodes["qn-b"].growing.values()) != 2 * (N_ROWS - tail):
        raise AssertionError("the growing segments did not take every WAL insert")

    def request(name, metric, q, ts):
        mstr = "l2" if metric is Metric.L2 else "ip"
        parts = [
            node.search_request(NodeSearchRequest(
                collection=name, k=K, metric=metric,
                guarantee=GuaranteeTs(query_ts=ts, staleness_ms=float("inf")),
                anns=[AnnsQuery("vector", q)],
            ))[0]
            for node in nodes.values()
        ]
        return ops.merge_topk(torch.cat([p[0] for p in parts], 1),
                              torch.cat([p[1] for p in parts], 1), K, metric=mstr)

    queries = {nq: torch.randn((nq, DIM), generator=gen, device=dev) for nq in (1, 100)}
    reps = {1: 20, 100: 5}
    latency: dict[str, list[float]] = {}
    results = {}
    l2_mod.l2_topk.launches = 0
    merge_mod.merge_topk.launches = 0
    t0 = time.perf_counter()
    for name, metric in colls.items():
        for nq, q in queries.items():
            for pin, ts in (("before", TS_BEFORE), ("after", TS_AFTER)):
                times = []
                for _ in range(reps[nq] + 1):  # first call is the warm-up
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    out = request(name, metric, q, ts)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                latency[f"{name} nq={nq} {pin}"] = times
                results[(name, nq, pin)] = out
    phases["requests_s"] = time.perf_counter() - t0
    launches = {"l2_topk": l2_mod.l2_topk.launches, "merge_topk": merge_mod.merge_topk.launches}
    log(f"main path launches: {launches}")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")

    # ------------------------------------------------ exact-answer check
    t0 = time.perf_counter()
    for name, metric in colls.items():
        x = data[name]
        cosine = metric is Metric.COSINE
        rtol, atol = SCORE_TOL["cosine" if cosine else "l2"]
        if cosine:
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        x_norm = (x * x).sum(1)
        for (rname, nq, pin), (got_s, got_p) in results.items():
            if rname != name:
                continue
            q = queries[nq]
            if cosine:
                q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)
                scores = q @ x.T
            else:
                scores = ((q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T)) + x_norm[None, :]
            if pin == "after":
                scores[:, deleted[name]] = float("-inf") if cosine else float("inf")
            want_s, want_p = torch.topk(scores, K, dim=1, largest=cosine)
            if got_s.shape != (nq, K) or got_p.dtype != torch.int64 or not torch.isfinite(got_s).all():
                raise AssertionError(f"{name} nq={nq} {pin}: malformed result")
            if pin == "after" and torch.isin(got_p, deleted[name]).any():
                raise AssertionError(f"{name}: a deleted pk was returned")
            torch.testing.assert_close(got_s, want_s, rtol=rtol, atol=atol)
            diff = got_p != want_p
            if diff.any():
                qi, slot = torch.nonzero(diff, as_tuple=True)
                torch.testing.assert_close(
                    scores[qi, got_p[qi, slot]], want_s[qi, slot], rtol=rtol, atol=atol
                )
            msg = (f"check {name} nq={nq} {pin}: ok (rtol={rtol}, atol={atol}; max |err| "
                   f"{(got_s - want_s).abs().max().item():.3g}; {int(diff.sum())} near-tie swaps)")
            del scores
            if nq == 100 and pin == "before":  # every row visible: the TF32 control
                msg += f"; TF32 product fails it, max |err| {tf32_control(torch, q, x, want_s, cosine, rtol, atol):.3g}"
            log(msg)
        del x, x_norm
    phases["verify_s"] = time.perf_counter() - t0

    # ------------------------------------- where one request's time goes
    t0 = time.perf_counter()
    for nq, pin, ts in ((1, "before", TS_BEFORE), (1, "after", TS_AFTER), (100, "after", TS_AFTER)):
        profile_request(torch, lambda: request("vdb_l2", Metric.L2, queries[nq], ts),
                        f"vdb_l2 nq={nq} {pin}")
    phases["profile_s"] = time.perf_counter() - t0

    # ------------------------------------------- kernel times at path shapes
    t0 = time.perf_counter()
    x = data["vdb_l2"]
    bases = [x[s * SEG_ROWS:(s + 1) * SEG_ROWS] for s in range(N_SEALED)] + [x[tail:]]
    valids = [torch.ones(b.shape[0], dtype=torch.bool, device=dev) for b in bases]
    kt = {}
    for nq, q in queries.items():
        reps_k = 20 if nq == 1 else 10
        kt[nq] = {
            "ms": cuda_ms(torch, lambda: l2_mod.l2_topk(q, bases, valids, K, "l2"), reps_k),
            "plain_ms": cuda_ms(torch, lambda: l2_mod.l2_topk_plain(q, bases, valids, K, "l2"), reps_k),
            "library_ms": cuda_ms(
                torch, lambda: torch.topk(q @ x.T, K, dim=1), reps_k
            ),
        }
        n_bytes = 4 * nq * DIM + 4 * N_ROWS * DIM + N_ROWS + 12 * nq * len(bases) * K
        n_ops = 2 * nq * N_ROWS * DIM + 2 * N_ROWS * DIM + 2 * nq * DIM
        kt[nq]["bound_ms"] = max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOPS) * 1e3
        kt[nq]["bound_by"] = "bytes" if n_bytes / PEAK_BYTES_S >= n_ops / PEAK_F32_FLOPS else "operations"
        log(f"l2_topk nq={nq} over {N_ROWS} x {DIM}, k={K}: " + json.dumps(kt[nq]))
    m_pool = 4 * K  # node merge: four scan units of top-100 per node
    ps = torch.randn((100, m_pool), generator=gen, device=dev)
    pp = torch.randint(0, N_ROWS, (100, m_pool), generator=gen, device=dev)
    mt = {
        "ms": cuda_ms(torch, lambda: merge_mod.merge_topk(ps, pp, K, "l2"), 50),
        "plain_ms": cuda_ms(torch, lambda: merge_mod.merge_topk_plain(ps, pp, K, "l2"), 50),
        "bound_ms": (12 * 100 * m_pool + 12 * 100 * K) / PEAK_BYTES_S * 1e3,
    }
    log(f"merge_topk nq=100 M={m_pool} k={K}: " + json.dumps(mt))
    phases["kernel_timing_s"] = time.perf_counter() - t0

    for key, times in latency.items():
        steady = times[1:]
        log(f"request {key}: first {times[0]:.3f} ms, median {statistics.median(steady):.3f} ms "
            f"over {len(steady)} (min {min(steady):.3f}, max {max(steady):.3f})")
    log("phases: " + json.dumps({k: round(v, 3) for k, v in phases.items()}))

    kernels = [
        {
            "name": "l2_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/l2_topk.cu",
            "replaces": "src/repro/kernels/l2_topk.py:91",
            "launches": launches["l2_topk"], "max_abs_err": max_err["l2_topk"],
            "ms": kt[100]["ms"], "plain_ms": kt[100]["plain_ms"], "bound_ms": kt[100]["bound_ms"],
            "bound_by": kt[100]["bound_by"], "library_ms": kt[100]["library_ms"],
        },
        {
            "name": "merge_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/merge_topk.cu",
            "replaces": "src/repro/kernels/merge_topk.py:77",
            "launches": launches["merge_topk"], "max_abs_err": max_err["merge_topk"],
            "ms": mt["ms"], "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failing phase and exit non-zero, no result line
        traceback.print_exc()
        sys.exit(1)
