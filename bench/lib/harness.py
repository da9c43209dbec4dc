"""One run of one cell: set-up, warm-up, the measured window, the checks,
the result.

``run_cell`` never looks for a chip: ``bench/run.py`` does, and the CPU
tests call this with ``device="cpu"`` at tiny sizes (the program then runs
its plain PyTorch kernels).
"""

from __future__ import annotations

import gc
import time

import torch

from . import checks, spec, yardstick
from .spec import Cell
from .system import Deployment
from .trace import DeviceTrace
from .window import Traffic

DEFAULT_WARMUP = {"search": 2, "write": 1, "ingest": 2}
CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def _spread(label: str, calls: list[dict]) -> str:
    """Median, 95th percentile and largest of the calls' milliseconds, and
    the medians of the window's two halves."""
    ms = [(c["t1"] - c["t0"]) * 1e3 for c in calls]
    if not ms:
        return f"{label}: none"
    q = sorted(ms)
    half = len(ms) // 2
    med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")
    at = lambda p: q[int(p * (len(q) - 1))]
    return (f"{label}: {len(ms)} calls, ms mean {sum(ms) / len(ms):.3f}, median {med(ms):.3f}, "
            f"p90 {at(0.90):.3f}, p95 {at(0.95):.3f}, p99 {at(0.99):.3f}, most {q[-1]:.3f}, "
            f"over 2x median {sum(m > 2 * med(ms) for m in ms)}; "
            f"halves {med(ms[:half]):.3f} / {med(ms[half:]):.3f}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             log=print, control: bool = False) -> dict:
    device = torch.device(device)
    config, mix = cell.config, cell.traffic
    phases: dict[str, float] = {}
    dep = Deployment(config, device, seed, phases)
    try:
        if config["kind"] == "embedder":
            dep.load_embedder(mix["ingest"]["micro_batch"])
            dep.start()
        elif config["kind"] == "vectors":
            dep.start()
            dep.load_rows()
        else:
            raise KeyError(f"unknown configuration kind {config['kind']!r}")
        t = time.perf_counter()
        traffic = Traffic(mix, dep, seed, seconds)
        pool = getattr(traffic, "pool", None)
        warm = traffic.run(None, warmup={**DEFAULT_WARMUP, **mix.get("warmup", {})})
        if warm.errors:
            raise RuntimeError("warm-up failed: " + "; ".join(warm.errors[:3]))
        _sync(device)
        phases["warmup_s"] = time.perf_counter() - t
        setup_s = time.time() - t_process
        log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
            + f"; setup_s {setup_s:.3f}")

        on_card = device.type == "cuda"
        before = yardstick.card(CLOCKS) if on_card else "cpu"
        if on_card:
            # The peak read is the window's: what the deployment holds, and
            # what the window's calls add, not set-up's transients.
            torch.cuda.reset_peak_memory_stats(device)
        with DeviceTrace(trace, device) as tracer:
            rec = traffic.run(seconds, trace=trace)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if on_card:
            log(f"card {CLOCKS}: before the window {before}; after {yardstick.card(CLOCKS)}")
        for label, calls in (("search", rec.requests), ("embed", rec.embeds), ("insert", rec.inserts)):
            if calls:
                log(_spread(label, calls))
        t = time.perf_counter()
        device_trace = tracer.read()
        if trace:
            log(f"trace read in {time.perf_counter() - t:.3f} s")
        for r in rec.requests:
            r["n_live"] = r["visible"] - int((dep.deleted < r["visible"]).sum())
        lates = [i["t0"] - i["due"] for i in rec.inserts if "due" in i]
        if lates:
            log(f"writer: {len(lates)} batches, lateness median {sorted(lates)[len(lates) // 2]:.4f} s, "
                f"most {max(lates):.4f} s")
        for err in rec.errors[:5]:
            log(f"failed: {err}")

        numbers: dict[str, float] = {}
        want = mix.get("check", {})
        if rec.inserts and want.get("readback_rows"):
            numbers.update(checks.readback(rec, dep, seed, want["readback_rows"]))
    finally:
        dep.stop()
    # The program's state goes before the references run on the card.
    dep.manu = dep.coll = dep.embedder = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if "search" in mix:
        numbers.update(checks.search(rec, dep, pool, seed, want.get("requests", 3), control))
    if "ingest" in mix:
        numbers.update(checks.embeddings(rec, config, seed, want.get("docs", 64), device, control))
    log(f"references ran in {time.perf_counter() - t:.3f} s")

    rec_view = {
        "seconds": seconds, "t0": rec.t0, "t1": rec.t1, "requests": rec.requests,
        "inserts": rec.inserts, "embeds": rec.embeds, "device": device_trace,
        "config": config, "traffic": mix, "setup_s": setup_s,
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], "per_layer" if trace else "end_to_end")(rec_view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = config["limits"]
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing} in the configuration")
    checked = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    failed = len(rec.errors)
    result = {
        "correct": failed == 0 and all(c["value"] <= c["limit"] for c in checked.values()),
        "attempted": len(rec.requests) + len(rec.inserts) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace and device_trace is not None:
        result["device"]["busy_s"] = device_trace["busy_s"]
        result["device"]["window_s"] = device_trace["window_s"]
        result["breakdown"] = {"device_ops": device_trace["device_ops"],
                               "idle_gaps": device_trace["idle_gaps"]}
    result["checks"] = checked
    return result
