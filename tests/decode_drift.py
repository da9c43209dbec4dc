#!/usr/bin/env python3
"""Decode against prefill at depth, in both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/decode_drift.py

For yi-9b at 48 and 2 layers and minicpm3-4b at 62 and 2 layers, at the
reduced widths (``ModelConfig.reduced``), with the reference's weights
(``init_params`` from seed 0, carried to the port by ``params_from_jax``):
B=4, an 8-token prompt, 16 decode steps fed fixed tokens, each step's
logits against one prefill over the whole sequence, max |err|, in the
reference and in the port on the same weights and tokens.  Beside them, the
largest |logit| and each package's prefill against the other's.  Prints one
JSON line per case.  Not a test module: it compares the two packages the
way the tests do, at depths the tests leave out.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core  # noqa: F401  (the reference's import order)
from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as RM
from repro_torch.configs import ARCHS
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_jax

B, PROMPT, STEPS = 4, 8, 16


def reference_drift(cfg, params, tokens):
    cache = RM.init_cache(cfg, B, PROMPT + STEPS)
    first, cache = RM.prefill(cfg, params, jnp.asarray(tokens[:, :PROMPT]), cache, remat=False)
    got = [first[:, -1:]]
    for i in range(STEPS):
        logits, cache = RM.decode_step(cfg, params, cache, jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]))
        got.append(logits)
    full, _ = RM.prefill(cfg, params, jnp.asarray(tokens), RM.init_cache(cfg, B, PROMPT + STEPS), remat=False)
    return np.asarray(jnp.concatenate(got, 1), np.float32), np.asarray(full, np.float32)


def port_drift(cfg, model, tokens):
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        cache = PM.init_cache(cfg, B, PROMPT + STEPS, device="cpu")
        first, cache = PM.prefill(cfg, model, tok[:, :PROMPT], cache, last_only=True)
        got = [first]
        for i in range(STEPS):
            logits, cache = PM.decode_step(cfg, model, cache, tok[:, PROMPT + i:PROMPT + i + 1])
            got.append(logits)
        full, _ = PM.prefill(cfg, model, tok, PM.init_cache(cfg, B, PROMPT + STEPS, device="cpu"))
    return torch.cat(got, 1).numpy(), full.numpy()


def main() -> None:
    for name, layers in (("yi-9b", 48), ("yi-9b", 2), ("minicpm3-4b", 62), ("minicpm3-4b", 2)):
        t0 = time.time()
        ref_cfg = REF_ARCHS[name].reduced(num_layers=layers)
        cfg = ARCHS[name].reduced(num_layers=layers)
        params = RM.init_params(ref_cfg, jax.random.key(0))
        model = params_from_jax(cfg, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
                                device="cpu")
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
        ref_dec, ref_full = reference_drift(ref_cfg, params, tokens)
        port_dec, port_full = port_drift(cfg, model, tokens)
        ref_err = np.abs(ref_dec - ref_full[:, PROMPT - 1:]).max(axis=(0, 2))
        port_err = np.abs(port_dec - port_full[:, PROMPT - 1:]).max(axis=(0, 2))
        print(json.dumps({
            "arch": name, "layers": layers, "widths": f"d_model {cfg.d_model}, vocab {cfg.vocab_size}",
            "reference_decode_vs_prefill": float(ref_err.max()), "port_decode_vs_prefill": float(port_err.max()),
            "reference_per_step": [round(float(e), 4) for e in ref_err],
            "port_per_step": [round(float(e), 4) for e in port_err],
            "port_prefill_vs_reference_prefill": float(np.abs(port_full - ref_full).max()),
            "max_abs_logit": float(np.abs(ref_full).max()), "seconds": round(time.time() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
