"""Weights carried across from a reference parameter tree.

``params_from_jax`` takes ``repro.models.model.init_params``'s tree with
every leaf as a numpy array (bf16 leaves widened to float32 by the caller,
which is exact: ``torch.from_numpy`` takes no ``ml_dtypes.bfloat16``) and
returns the port's ``Transformer`` with bf16 parameters, which rounds
nothing.  The reference stacks each slot's layers along a leading
``periods`` axis; layer ``period * len(pattern) + slot`` is row ``period``
of ``layers/slot<slot>``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .config import ModelConfig
from .layers import PARAM_DTYPE
from .model import Transformer, effective_pattern, num_periods


def _tensor(leaf, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(leaf)).to(device=device, dtype=PARAM_DTYPE)


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> Transformer:
    dev = resolve_device(device)
    pattern = effective_pattern(cfg)
    state = {"embed": _tensor(tree["embed"], dev), "ln_final": _tensor(tree["ln_final"], dev)}
    if not cfg.tie_embeddings:
        state["lm_head"] = _tensor(tree["lm_head"], dev)
    for period in range(num_periods(cfg)):
        for slot in range(len(pattern)):
            prefix = f"layers.{period * len(pattern) + slot}."
            stack = tree["layers"][f"slot{slot}"]
            for name, leaf in stack.items():
                if isinstance(leaf, dict):
                    for sub, arr in leaf.items():
                        state[prefix + f"{name}.{sub}"] = _tensor(arr[period], dev)
                else:
                    state[prefix + name] = _tensor(leaf[period], dev)
    model = Transformer(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(False)
