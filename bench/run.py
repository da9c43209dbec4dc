#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU.  One run
is one process: it builds the cell's system from its configuration, makes
its inputs from the seed, warms up the cell's own shapes, measures for
``--seconds``, checks what the window produced against the plain
references, and prints one JSON object as the last line of standard
output (with ``--trace 0`` the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics and the device trace).  The numbers compared and
their limits are the last lines of standard error and the last key of the
result.  ``bench/README.md`` says how cells, mixes and metrics are added.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout, so only the
# first run of a checkout builds (the port's own nvcc cache is
# build/repro_torch_kernels/, fixed in its code).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
# Names of the JAX package, JAX and Flax: the run fails if one is loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # The control of how `correct` is decided: the plain reference in a
    # lower precision put in the program's place (TF32 search answers, fp8
    # embeddings).  Its runs must come out not correct.
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from bench.lib import harness, spec, yardstick

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    log(f"card: {yardstick.card()}; peaks at {yardstick.DATASHEET_POWER_W:.0f} W: "
        f"bf16 {yardstick.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, TF32 {yardstick.PEAK_TF32_FLOPS / 1e12:.0f} "
        f"TFLOP/s, HBM {yardstick.PEAK_BYTES_S / 1e12:.2f} TB/s")
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS, log=log, control=args.control)
    loaded = forbidden_modules()
    if loaded:
        log(f"the run loaded {loaded}: the benchmark drives the port alone")
        return 3
    log(f"correct: {result['correct']}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
