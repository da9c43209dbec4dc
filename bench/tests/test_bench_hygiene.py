"""The benchmark drives the PyTorch port alone: no module under ``bench/``
imports JAX, Flax or the JAX package ``repro`` (top-level names compared
whole: ``repro_torch`` starts with ``repro``), and the plain references
import nothing of the port."""

import ast
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(ROOT)), m) for p in BENCH.rglob("*.py") for m in _imports(p)
             if m.split(".")[0] in FORBIDDEN}
    assert not found


def test_references_import_nothing_of_the_port():
    found = {(str(p.relative_to(ROOT)), m) for p in (BENCH / "reference").rglob("*.py")
             for m in _imports(p) if m.split(".")[0] == "repro_torch" or m == "bench.lib.system"}
    assert not found


def test_a_run_fails_without_a_gpu_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        return  # the card's runs check the other side
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "cohere1m-flat-batch",
                          "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_port_loads_without_jax():
    """What the harness loads of the port (the facade and the embedder)
    pulls in no JAX, in a process of its own."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import bench.lib.system as s; s.import_port(); "
            "import repro_torch.models.embedder; from bench.run import forbidden_modules; "
            "print(forbidden_modules())") % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
