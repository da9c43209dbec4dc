"""A cell's pieces, found by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric.  Each piece lives in a file of its own that this module finds
by that name alone:

- a configuration: the ``file`` its entry gives (``bench/configs/<name>.json``);
- a traffic mix: ``bench/traffic/<traffic>.json``;
- a metric: ``bench/layer_metrics/<metric>.py`` (per-layer) or
  ``bench/end_to_end/<metric>.py``, whose ``read(rec)`` returns the
  metric's value from the run's records, or None where the run has
  nothing for it to read;
- an embedder configuration's plain reference: the module
  ``bench/reference/<reference>.py`` its ``reference`` key names.

A later change adds a cell, a mix, a metric, a configuration or the
reference of another architecture as new files and new entries;
no file here needs an edit for it.  An unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise KeyError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; one
    without applies to every cell (a per-layer one: every cell that reports
    the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic mix read from their files."""
    _checked(name)
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r} names an unknown configuration {w['config']!r}")
    config = json.loads((Path(root) / configs[w["config"]]["file"]).read_text())
    traffic = load_traffic(w["traffic"], root)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "bench" / "traffic" / f"{_checked(name)}.json"
    if not path.is_file():
        raise KeyError(f"unknown traffic mix {name!r}: no {path.relative_to(root)}")
    return json.loads(path.read_text())


def metric_reader(name: str, kind: str = "per_layer", root: Path = ROOT):
    """``read(rec)`` of ``bench/layer_metrics/<name>.py`` (a per-layer
    metric) or ``bench/end_to_end/<name>.py``."""
    folder = {"per_layer": "layer_metrics", "end_to_end": "end_to_end"}[kind]
    path = Path(root) / "bench" / folder / f"{_checked(name)}.py"
    if not path.is_file():
        raise KeyError(f"unknown {kind} metric {name!r}: no {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference(name: str):
    """The plain reference module ``bench/reference/<name>.py``: for an
    embedder, its ``layer_parameters(model, layer)``, ``embed(tokens, model,
    seed, device, precision, block)`` and ``flops_per_token(model,
    seq_len)``."""
    path = BENCH_DIR / "reference" / f"{_checked(name)}.py"
    if not path.is_file():
        raise KeyError(f"unknown reference {name!r}: no {path.relative_to(ROOT)}")
    return importlib.import_module(f"bench.reference.{name}")
