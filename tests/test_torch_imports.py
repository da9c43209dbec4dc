"""The port stands alone: importing it loads neither jax nor the reference
package, and no file of the port (or chip_smoke.py) imports either."""

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
