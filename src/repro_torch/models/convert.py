"""Weights carried across from a reference parameter tree, and back.

``params_from_jax`` takes ``repro.models.model.init_params``'s tree with
every leaf as a numpy array (bf16 leaves widened to float32 by the caller,
which is exact: ``torch.from_numpy`` takes no ``ml_dtypes.bfloat16``) and
returns the port's ``Transformer``.  Each leaf takes the dtype the port's
model declares for it, which is the reference's: bf16, save the MoE
``router`` and the SSM's ``a_log`` / ``d_skip`` / ``dt_bias``, which stay
float32, so nothing is rounded.  The reference stacks each slot's layers
along a leading ``periods`` axis; layer ``period * len(pattern) + slot`` is
row ``period`` of ``layers/slot<slot>``; nested dicts (``attn``, ``ssm``,
``moe`` with its ``shared`` MLP) become dotted names.

``params_to_jax`` is the inverse: any dict keyed by the port's
``state_dict`` names (the parameters, or the optimizer's float32 ``m`` /
``v``) becomes the reference's stacked tree of float32 numpy arrays (bf16
widened, exactly).  ``state_from_jax`` is the unstacking alone: such a tree
to a dict of numpy arrays keyed by ``state_dict`` names.  The reference's
layout has no leading dense layers: a configuration with
``first_k_dense_replace`` raises ``ValueError`` in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .config import ModelConfig
from .model import Transformer, effective_pattern, num_periods


def _flatten(tree: dict, prefix: str, out: dict, row=None) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flatten(leaf, f"{prefix}{name}.", out, row)
        else:
            out[prefix + name] = leaf if row is None else leaf[row]


def _stacked_layout(cfg: ModelConfig) -> None:
    if cfg.first_k_dense_replace:
        raise ValueError(f"{cfg.name}: the reference's stacked layout has no leading dense layers")


def state_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    """A reference tree's leaves keyed by ``state_dict`` names, each
    period's row of the stacked layers apart."""
    _stacked_layout(cfg)
    pattern = effective_pattern(cfg)
    leaves: dict = {}
    _flatten({k: v for k, v in tree.items() if k != "layers"}, "", leaves)
    for period in range(num_periods(cfg)):
        for slot in range(len(pattern)):
            _flatten(tree["layers"][f"slot{slot}"], f"layers.{period * len(pattern) + slot}.",
                     leaves, period)
    return leaves


def params_to_jax(cfg: ModelConfig, state: dict) -> dict:
    """The reference's tree (``init_params``'s layout, layers stacked per
    slot over periods) of ``state``'s tensors as float32 numpy arrays."""
    _stacked_layout(cfg)
    period = len(effective_pattern(cfg))
    tree: dict = {}
    stacks: dict = {}
    for name, value in state.items():
        arr = value.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            layer = int(parts[1])
            rows = stacks.setdefault((f"slot{layer % period}", *parts[2:]), {})
            rows[layer // period] = arr
        else:
            _nest(tree, parts, arr)
    for path, rows in stacks.items():
        _nest(tree, ["layers", *path], np.stack([rows[i] for i in range(num_periods(cfg))]))
    return tree


def _nest(tree: dict, path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    dev = resolve_device(device)
    leaves = state_from_jax(cfg, tree)
    model = Transformer(cfg, device="meta")
    dtypes = {k: p.dtype for k, p in model.state_dict().items()}
    state = {k: torch.from_numpy(np.array(v)).to(device=dev, dtype=dtypes.get(k, torch.float32))
             for k, v in leaves.items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(False)
