"""Step-atomic checkpoint / restart to the object store; mirrors
``repro.train.checkpoint`` object for object.

Training state (the parameters, the optimizer's moments and step) goes to
``ckpt/<name>/<step:010d>/{params,opt}/<leaf path>`` objects of ``.npy``
bytes, then a ``MANIFEST`` written last: a checkpoint without one is never
visible (the manifest is the commit record), which is what makes
preemption and node-failure recovery safe.  ``restore_latest`` resumes from
the newest committed step.

The leaf paths are the reference's: its stacked tree (``layers/slot<i>/
attn/w_q`` holds that slot's layer of every period; ``opt/m/...``,
``opt/v/...`` and ``opt/step``), built by ``models.convert.params_to_jax``
from the port's dicts keyed by ``state_dict`` names, and unstacked again by
``state_from_jax``.  bf16 leaves are stored widened to float32 (exact) and
the manifest records their dtype, so a checkpoint the reference wrote
restores here and one written here restores in the reference.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from ..core.object_store import ObjectStore
from ..models.config import ModelConfig
from ..models.convert import params_to_jax, state_from_jax
from ..models.model import effective_pattern

Tensors = dict[str, torch.Tensor]


def _paths(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            flat.update(_paths(leaf, f"{prefix}{key}/"))
        else:
            flat[prefix + key] = leaf
    return flat


def _tree(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _leaf_path(cfg: ModelConfig, name: str) -> str:
    """The reference leaf path that holds ``state_dict`` entry ``name``."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["layers", f"slot{int(parts[1]) % len(effective_pattern(cfg))}", *parts[2:]]
    return "/".join(parts)


def save_checkpoint(cfg: ModelConfig, store: ObjectStore, name: str, step: int, params: Tensors,
                    opt_state: dict, extra: dict | None = None) -> str:
    """Write one checkpoint of ``params`` and ``opt_state``
    (``{"step", "m", "v"}``) and commit it; returns its prefix."""
    prefix = f"ckpt/{name}/{step:010d}"
    groups = {
        "params": (params_to_jax(cfg, params),
                   {_leaf_path(cfg, k): str(p.dtype).removeprefix("torch.") for k, p in params.items()}),
        "opt": ({"m": params_to_jax(cfg, opt_state["m"]), "v": params_to_jax(cfg, opt_state["v"]),
                 "step": np.asarray(opt_state["step"], np.int32)}, {}),
    }
    leaves: dict[str, dict] = {"params": {}, "opt": {}}
    for group, (tree, dtypes) in groups.items():
        for key, arr in _paths(tree).items():
            obj_key = f"{prefix}/{group}/{key}"
            buf = io.BytesIO()
            np.save(buf, arr, allow_pickle=False)
            store.put(obj_key, buf.getvalue())
            leaves[group][key] = {"key": obj_key, "dtype": dtypes.get(key, str(arr.dtype)),
                                  "shape": list(arr.shape)}
    manifest = {"name": name, "step": step, "leaves": leaves, "extra": extra or {}}
    # the manifest is the atomic commit record: written last
    store.put(f"{prefix}/MANIFEST", json.dumps(manifest).encode())
    return prefix


def committed_steps(store: ObjectStore, name: str) -> list[int]:
    steps = []
    for meta in store.list(f"ckpt/{name}/"):
        parts = meta.key.split("/")
        if parts[-1] == "MANIFEST":
            steps.append(int(parts[2]))
    return sorted(steps)


def restore_checkpoint(cfg: ModelConfig, store: ObjectStore, name: str, step: int,
                       params_like: Tensors, opt_like: dict) -> tuple[Tensors, dict, dict]:
    """The committed checkpoint ``step``: (params, opt_state, extra), each
    leaf taking the dtype and device of its counterpart in ``params_like``
    / ``opt_like``."""
    prefix = f"ckpt/{name}/{step:010d}"
    manifest = json.loads(store.get(f"{prefix}/MANIFEST").decode())

    def load(group: str) -> dict:
        return _tree({key: np.load(io.BytesIO(store.get(info["key"])), allow_pickle=False)
                      for key, info in manifest["leaves"][group].items()})

    def like(arrays: dict, ref: Tensors) -> Tensors:
        return {k: torch.from_numpy(np.asarray(arrays[k])).to(device=r.device, dtype=r.dtype)
                for k, r in ref.items()}

    opt = load("opt")
    params = like(state_from_jax(cfg, load("params")), params_like)
    opt_state = {"step": int(opt["step"]), "m": like(state_from_jax(cfg, opt["m"]), opt_like["m"]),
                 "v": like(state_from_jax(cfg, opt["v"]), opt_like["v"])}
    return params, opt_state, manifest["extra"]


def restore_latest(cfg: ModelConfig, store: ObjectStore, name: str, params_like: Tensors,
                   opt_like: dict) -> tuple[int, Tensors, dict, dict] | None:
    steps = committed_steps(store, name)
    if not steps:
        return None
    params, opt_state, extra = restore_checkpoint(cfg, store, name, steps[-1], params_like, opt_like)
    return steps[-1], params, opt_state, extra


def prune_checkpoints(store: ObjectStore, name: str, keep: int = 2) -> None:
    """Delete every committed checkpoint but the newest ``keep``."""
    for step in committed_steps(store, name)[:-keep]:
        for meta in list(store.list(f"ckpt/{name}/{step:010d}")):
            store.delete(meta.key)
