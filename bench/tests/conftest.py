"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src/`` on the path, and cells cut to a size the CPU runs in seconds."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny stand-ins for each configuration's sizes and each mix's loads: the
# same code paths, the plain PyTorch kernels of the port.
TINY_MODEL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16, intermediate_size=128, vocab_size=512)
# The same sizes as the port's ``ModelConfig`` keywords (``port_model``).
TINY_PORT_MODEL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=512)


def tiny(cell):
    cfg = copy.deepcopy(cell.config)
    if cfg["kind"] == "vectors":
        cfg.update(rows=3000, dim=48, insert_batch=512)
        cfg["manu"].update(seal_rows=1024, slice_rows=256)
        cfg["data"]["centers"] = 16
    else:
        cfg["model"].update(TINY_MODEL)
        cfg["port_model"].update(TINY_PORT_MODEL)
        cfg["dim"] = TINY_MODEL["hidden_size"]
        cfg["index"]["params"] = {"nlist": 8, "nprobe": 4}
    mix = copy.deepcopy(cell.traffic)
    if "search" in mix:
        mix["search"].update(nq=20, k=10, pool_requests=2)
    if "write" in mix:
        mix["write"].update(rows_per_batch=256, batches_per_s=4.0)
    if "ingest" in mix:
        mix["ingest"].update(doc_tokens=16, micro_batch=4)
    check = mix.get("check", {})
    if "readback_rows" in check:
        check["readback_rows"] = 64
    if "docs" in check:
        check["docs"] = 8
    cell.config, cell.traffic = cfg, mix
    return cell


@pytest.fixture
def tiny_cell():
    from bench.lib import spec

    return lambda name: tiny(spec.load_cell(name))


@pytest.fixture
def run_tiny(tiny_cell):
    """Run a tiny cell on the CPU: (result, log lines)."""
    import time

    from bench.lib import harness

    def run(name, seed=2**31 + 7, seconds=1.5, trace=False, control=False):
        lines = []
        res = harness.run_cell(tiny_cell(name), seed, seconds, trace, "cpu", time.time(),
                               log=lines.append, control=control)
        return res, lines

    return run
