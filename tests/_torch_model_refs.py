"""Set-up shared by the port's model parity tests (not a test module).

``carried(name)`` builds the reference's reduced model with every vector
leaf (norms, biases, ``a_log``, ``d_skip``, ``dt_bias``) moved off its
constant init by 0.1 N(0, 1), so that each one counts, and the port's model
from the same tree through ``params_from_jax`` (bf16 leaves widened to
float32 on the way, exact both ways).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as RM
from repro_torch.configs import ARCHS
from repro_torch.models.convert import params_from_jax

ALL = tuple(sorted(REF_ARCHS))
#: End-to-end tolerance factors by configuration.  Reduced jamba is one
#: full 8-layer period, four times the other configurations' 2 layers; its
#: residual stream reaches |x| ~ 10 (one bf16 ulp 2^-4), and each layer
#: adds up to an ulp of rounding difference between the packages, which
#: the layers after it carry on.  So its end-to-end bounds are four times
#: the 2-layer ones (measured on its inputs here: hidden states 0.10,
#: logits 0.018-0.040, embeddings 0.014), while each layer fed the
#: reference's input is held to the 2-layer bound
#: (``test_torch_model_families.py::test_each_layer_matches_reference``)
#: and no MoE slot routes differently.
DEPTH_SCALE = {"jamba-v0.1-52b": 4.0}
#: The families ported after the dense GQA decoders.
FAMILIES = ("minicpm3-4b", "qwen3-moe-30b-a3b", "deepseek-moe-16b", "mamba2-370m",
            "jamba-v0.1-52b", "paligemma-3b", "musicgen-medium")


def _perturb(tree: dict, rng, stacked: bool) -> None:
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb(leaf, rng, stacked)
        elif leaf.ndim == (2 if stacked else 1):
            noise = 0.1 * rng.standard_normal(leaf.shape)
            tree[key] = jnp.asarray(np.asarray(leaf, np.float32) + noise, leaf.dtype)


def reference_params(cfg, seed: int = 0) -> dict:
    params = RM.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 10)
    _perturb({k: v for k, v in params.items() if k != "layers"}, rng, False)
    for slot in params["layers"].values():
        _perturb(slot, rng, True)
    return params


def numpy_tree(params: dict) -> dict:
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def carried(name: str, seed: int = 0, **overrides):
    """(reference cfg, reference params, the port's model on the CPU)."""
    cfg = REF_ARCHS[name].reduced(**overrides)
    params = reference_params(cfg, seed)
    return cfg, params, params_from_jax(ARCHS[name].reduced(**overrides), numpy_tree(params), device="cpu")


def inputs(cfg, batch: int, seq: int, seed: int = 1):
    """Seeded tokens [B, S] int32 and, for the VLM stub, patch embeddings
    [B, P, D] float32 (else None)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    prefix = None
    if cfg.frontend == "vlm_stub":
        prefix = rng.standard_normal((batch, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return tokens, prefix


def j(a):
    return None if a is None else jnp.asarray(a)


def t(a, dtype=None):
    if a is None:
        return None
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)
