"""``examples/torch_train_embedder.py`` on the CPU: a fresh run crashes at
``--crash-at`` (exit code 17) after committing a checkpoint; the rerun with
the same arguments resumes from it, trains to the end, embeds a corpus
with the port's ``Embedder``, ingests it into the port's ``ManuSystem``
and finds each of the first rows as its own nearest neighbour."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "torch_train_embedder.py"


def test_example_crashes_resumes_and_retrieves(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("torch_train_embedder", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--device", "cpu", "--steps", "30", "--crash-at", "25", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as crashed:
        example.main(argv)
    assert crashed.value.code == example.CRASH_EXIT
    assert example.main(argv) == 0
    out = capsys.readouterr().out
    assert "resumed 'embedder-small' from step 20" in out
    assert "over 10 steps" in out and "searchable: done" in out
