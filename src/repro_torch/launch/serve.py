"""Serving launcher; mirrors ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b --shape decode_32k --dry-run
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --local --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --local --device cpu

``--local`` runs real batched greedy decode of the architecture's reduced
configuration: B=4, an 8-token prompt (after ``num_prefix_embeddings``
patch embeddings for the VLM stub), a cache of the prompt plus
``--tokens``, ``prefill``, then ``decode_step`` on the argmax token.  It
runs on the card unless ``--device cpu`` is given, and raises when no GPU
is visible.  Weights and inputs are drawn from explicit
``torch.Generator``s, so the tokens differ from the reference's, whose RNG
is JAX's.  ``--dry-run`` runs ``launch.dryrun.run_cell`` for ``--arch``,
``--shape`` and ``--multi-pod`` (the prefill / decode cell on the
production mesh, on the CPU, in a fake world) and prints its memory and
roofline terms at H100 constants.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_arch
from ..models import model as M



def dry_run(arch: str, shape: str, multi_pod: bool) -> dict:
    """``dryrun.run_cell`` for one cell, with a one-line summary printed."""
    from .dryrun import run_cell, summary

    res = run_cell(arch, shape, multi_pod=multi_pod)
    print(f"{arch} x {shape} [{res['mesh']}]: ran on the fake world; {summary(res)}")
    return res


def main(argv: list[str] | None = None) -> np.ndarray | dict | None:
    """Parse ``argv`` (the command line when None) and run.  ``--local``
    returns the decoded tokens [B, tokens] as numpy, ``--dry-run`` the
    dry-run's result."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.dry_run:
        return dry_run(args.arch, args.shape, args.multi_pod)
    if not args.local:
        ap.error("choose --dry-run or --local")

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    params = M.init_params(cfg, seed=0, device=dev)
    batch = 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, 8), generator=gen, device=dev)
    prefix = None
    if cfg.frontend == "vlm_stub":
        gen.manual_seed(2)
        prefix = torch.randn((batch, cfg.num_prefix_embeddings, cfg.d_model), generator=gen, device=dev)
    total = 8 + (cfg.num_prefix_embeddings if prefix is not None else 0)
    with torch.no_grad():
        cache = M.init_cache(cfg, batch, total + args.tokens, device=dev)
        logits, cache = M.prefill(cfg, params, prompt, cache, prefix)
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            logits, cache = M.decode_step(cfg, params, cache, tok)
            tok = logits.argmax(-1)
            out.append(tok)
        seq = torch.cat(out, 1).cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"{args.arch}-reduced: decoded {args.tokens} tokens x{batch} seqs "
          f"in {dt:.2f}s ({args.tokens * batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", seq[0][:12])
    return seq


if __name__ == "__main__":
    main()
