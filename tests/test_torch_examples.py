"""The port's examples, each run as a script with ``--device cpu``: each
exits 0 only when its own check passes.

- ``torch_quickstart.py``: the deleted pks vanish from the top-5 and come
  back under time travel;
- ``torch_elastic_failover.py``: every failover answers what was answered
  before (``results identical: True``);
- ``torch_serve_embedder.py``: every batch is answered with bounded
  staleness while fresh documents stream in.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CASES = {
    "torch_quickstart.py": "check: deleted pks vanished from the top-5: True; back under time travel: True",
    "torch_elastic_failover.py": "results identical: True",
    "torch_serve_embedder.py": "check: 64 of 64 queries answered with 5 hits at staleness 200 ms",
}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_passes_its_check(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert CASES[script] in run.stdout
    assert "jax" not in (ROOT / "examples" / script).read_text()
