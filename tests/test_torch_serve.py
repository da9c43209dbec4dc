"""The port's serving launcher, ``repro_torch.launch.serve``, on the CPU.

``--local --device cpu`` runs the reduced configuration's prefill and
greedy decode end to end and prints the reference's two lines; the tokens
are held to the port's own ``prefill`` over the whole decoded sequence (a
greedy token is the argmax of that prefill's logits at its position,
except where the top two lie within the decode-vs-prefill bound 0.15 of
``test_prefill_decode_parity``).  Without ``--device`` it runs on the card
and raises when no GPU is visible; ``--dry-run`` runs the cell's dry-run.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEAR_TIE = 0.15


def _held_to_prefill(arch: str, seq: np.ndarray) -> None:
    """Rebuild the launcher's seeded model and prompt, prefill prompt +
    decoded tokens at once, and check each greedy choice against it."""
    cfg = get_arch(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
    prefix = None
    if cfg.frontend == "vlm_stub":
        gen.manual_seed(2)
        prefix = torch.randn((4, cfg.num_prefix_embeddings, cfg.d_model), generator=gen)
    p = 0 if prefix is None else cfg.num_prefix_embeddings
    full_tok = torch.cat([prompt, torch.from_numpy(seq)], 1)
    with torch.no_grad():
        cache = M.init_cache(cfg, 4, full_tok.shape[1] + p, device="cpu")
        logits, _ = M.prefill(cfg, params, full_tok, cache, prefix)
    # the token after position p + 7 + i is seq[:, i]
    lg = logits[:, p + 7:p + 7 + seq.shape[1]]
    top2 = lg.topk(2, dim=-1).values
    chosen = lg.gather(-1, torch.from_numpy(seq)[..., None])[..., 0]
    near_tie = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE
    assert ((chosen == top2[..., 0]) | near_tie).all()
    assert (top2[..., 0] - chosen).max().item() <= NEAR_TIE


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm3-4b", "jamba-v0.1-52b", "paligemma-3b"])
def test_serve_local_on_the_cpu(arch, capsys):
    seq = serve.main(["--arch", arch, "--local", "--tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{arch}-reduced: decoded 6 tokens x4 seqs in ") and out[0].endswith(" tok/s)")
    assert out[1].startswith("sample: [")
    cfg = get_arch(arch).reduced()
    assert seq.shape == (4, 6) and seq.dtype == np.int64
    assert ((seq >= 0) & (seq < cfg.vocab_size)).all()
    _held_to_prefill(arch, seq)
    # seeded: a second run decodes the same tokens
    np.testing.assert_array_equal(serve.main(["--arch", arch, "--local", "--tokens", "6", "--device", "cpu"]), seq)


def test_serve_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-370m", "--local",
         "--tokens", "3", "--device", "cpu"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("mamba2-370m-reduced: decoded 3 tokens x4 seqs")


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-9b", "--local", "--tokens", "2"])


def test_serve_dry_run_runs_the_cell(capsys):
    """``--dry-run`` runs ``launch.dryrun.run_cell`` for the arch, shape and
    mesh it is given (on the fake 256-rank world, on the CPU)."""
    res = serve.main(["--arch", "qwen3-32b", "--shape", "decode_32k", "--dry-run"])
    assert (res["arch"], res["shape"], res["mesh"], res["kind"]) == ("qwen3-32b", "decode_32k", "16x16", "decode")
    assert res["ok"] and res["cost"]["flops_per_device"] > 0 and res["roofline"]["bound"]
    assert "qwen3-32b x decode_32k [16x16]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "yi-9b"])
