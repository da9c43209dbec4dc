"""Render the roofline tables from the dry-run's result files; mirrors
``repro.launch.report``.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir results/dryrun_torch]

The numbers are a model at the H100 datasheet constants
(``launch.dryrun``), not measurements.
"""

from __future__ import annotations

import argparse
import json
import os

from .dryrun import RESULTS_DIR


def load_all(d: str) -> list[dict]:
    out = []
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                out.append(json.load(f))
    return out


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


_ORDER = {"train": 0, "prefill": 1, "decode": 2}


def roofline_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | kind | mem/dev GiB | compute ms | memory ms | collective ms | bound | "
           "useful-FLOP ratio | roofline frac |\n|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], _ORDER.get(r.get("kind", ""), 3), r["shape"])):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | - | FAILED: {r.get('error', '?')} | | | | | | |")
            continue
        if "roofline" not in r:
            continue
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | {fmt_bytes(r['memory']['peak_bytes_per_device'])} "
            f"| {t['compute_s'] * 1e3:.1f} | {t['memory_s'] * 1e3:.1f} | {t['collective_s'] * 1e3:.1f} "
            f"| {t['bound']} | {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |")
    return hdr + "\n".join(lines)


def fit_table(rows: list[dict]) -> str:
    hdr = "| arch | shape | mem/dev GiB | fits 80 GB |\n|---|---|---|---|\n"
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | FAILED | |")
            continue
        peak = r["memory"]["peak_bytes_per_device"]
        lines.append(f"| {r['arch']} | {r['shape']} | {fmt_bytes(peak)} | {'yes' if peak <= 80e9 else 'no'} |")
    return hdr + "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.report")
    ap.add_argument("--dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    single = load_all(os.path.join(args.dir, "16x16"))
    multi = load_all(os.path.join(args.dir, "2x16x16"))
    print("## Roofline (one pod, 16x16 = 256 H100s, per-device terms; a model at datasheet constants)\n")
    print(roofline_table(single))
    print("\n## Multi-pod fit pass (2x16x16 = 512 H100s)\n")
    print(fit_table(multi))
    ok_s = sum(1 for r in single if r.get("ok"))
    ok_m = sum(1 for r in multi if r.get("ok"))
    print(f"\nsingle-pod: {ok_s}/{len(single)} cells pass; multi-pod: {ok_m}/{len(multi)} cells pass")


if __name__ == "__main__":
    main()
