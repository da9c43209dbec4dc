#!/usr/bin/env python3
"""Decode against prefill at depth, on one NVIDIA GPU.

    python3 chip_depth.py            (from the root of a checkout)

For minicpm3-4b at 62 and 2 layers and yi-9b at 48 and 2 (published
widths, random weights from seed 0): B=4, an 8-token prompt, 16 decode
steps fed fixed tokens, each step's logits against one prefill over the
whole sequence (max |err| per step and per row), beside a control: the
first two rows prefilled alone against the same rows in the batch of four.
Each case runs with cuBLAS's reduced-precision bf16 reductions allowed
(PyTorch's default) and not.  Prints one line per case.
"""

import dataclasses
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def check(torch, M, cfg, model, dev, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b, s, steps = 4, 8, 16
    tok = torch.randint(0, cfg.vocab_size, (b, s + steps), generator=gen, device=dev)
    with torch.no_grad():
        cache = M.init_cache(cfg, b, s + steps, device=dev)
        first, cache = M.prefill(cfg, model, tok[:, :s], cache, last_only=True)
        got = [first]
        for i in range(steps):
            logits, cache = M.decode_step(cfg, model, cache, tok[:, s + i:s + i + 1])
            got.append(logits)
        full, _ = M.prefill(cfg, model, tok, M.init_cache(cfg, b, s + steps, device=dev))
        pair, _ = M.prefill(cfg, model, tok[:2], M.init_cache(cfg, 2, s + steps, device=dev))
        err = (torch.cat(got, 1) - full[:, s - 1:]).abs()
    return (err.amax((0, 2)).tolist(), err.amax((1, 2)).tolist(), (pair - full[:2]).abs().max().item(),
            full.abs().max().item())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_depth: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for name, layers in (("minicpm3-4b", 62), ("yi-9b", 48), ("yi-9b", 2), ("minicpm3-4b", 2)):
        cfg = dataclasses.replace(get_arch(name), num_layers=layers)
        model = M.init_params(cfg, seed=0, device=dev)
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            for seed in (20, 21):
                per_step, per_row, control, scale = check(torch, M, cfg, model, dev, seed)
                print(f"{name} x{layers} reduced_precision_reduction={flag} seed {seed}: max|err| "
                      f"{max(per_step):.4f} per row {[round(x, 4) for x in per_row]} per step "
                      f"{[round(x, 3) for x in per_step]}; prefill B=2 vs B=4 rows {control:.4f}; "
                      f"max|logit| {scale:.2f}", flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
