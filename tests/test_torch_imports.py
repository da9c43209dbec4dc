"""The port stands alone: importing it loads neither jax nor the reference
package, and no file of the port (or chip_smoke.py) imports either."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = [
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in sorted(PORT.rglob("*.py"))
    if p.name != "__init__.py"
]
_FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_import_leaves_out_jax_and_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: p.name
)
def test_no_source_imports_jax_or_reference(path):
    assert not _FORBIDDEN.search(path.read_text()), path


#: The maintenance and recovery modules: each must load on its own, without
#: jax and without the reference (they keep their own copies of the
#: reference's host-only modules, faults.py and retry.py included).
MAINTENANCE_MODULES = [
    "repro_torch.core.compaction",
    "repro_torch.core.faults",
    "repro_torch.core.retry",
    "repro_torch.core.time_travel",
]


def test_maintenance_modules_are_checked_and_import_alone():
    assert set(MAINTENANCE_MODULES) <= set(MODULES)
    code = (
        "import importlib, sys\n"
        f"for m in {MAINTENANCE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "    bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "    assert not bad, (m, bad)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: The model zoo (``models``) and the architecture registry (``configs``):
#: each must load on its own, without jax and without the reference (they
#: keep their own copies of ``repro.models.config`` and ``repro.configs``,
#: which import no jax themselves).
MODEL_MODULES = sorted(
    [m for m in MODULES if m.startswith(("repro_torch.models.", "repro_torch.configs."))]
    + ["repro_torch.models", "repro_torch.configs"]
)


def test_model_modules_are_all_listed():
    assert {"repro_torch.models.config", "repro_torch.models.layers", "repro_torch.models.model",
            "repro_torch.models.embedder", "repro_torch.models.convert",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.configs.yi_9b"} <= set(MODEL_MODULES)
    assert len([m for m in MODEL_MODULES if m.startswith("repro_torch.configs.")]) == 10


@pytest.fixture(scope="module")
def model_imports():
    """One interpreter imports the model modules in turn and records, after
    each, any jax or reference module loaded so far."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for m in {MODEL_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "    out[m] = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.mark.parametrize("module", MODEL_MODULES)
def test_model_modules_import_without_jax_or_reference(model_imports, module):
    assert model_imports[module] == []


#: The serving path's new modules: each loads alone, in a fresh interpreter,
#: without jax and without the reference.
SERVING_MODULES = ["repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.launch.serve"]


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_import_alone_without_jax_or_reference(module):
    assert module in MODULES
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


#: The training and distributed modules: each loads alone, in a fresh
#: interpreter, without jax and without the reference, and importing it
#: starts no process group.
TRAIN_AND_DISTRIBUTED_MODULES = [
    "repro_torch.train.optimizer", "repro_torch.train.checkpoint", "repro_torch.train.loop",
    "repro_torch.launch.steps", "repro_torch.launch.train",
    "repro_torch.distributed.search", "repro_torch.distributed.decode_attn",
    "repro_torch.distributed.act_sharding",
]


@pytest.mark.parametrize("module", TRAIN_AND_DISTRIBUTED_MODULES)
def test_train_and_distributed_modules_import_alone(module):
    assert module in MODULES
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "import torch.distributed as dist\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
