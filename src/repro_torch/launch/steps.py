"""Step builders and input specs for every (arch x shape) cell; mirrors
``repro.launch.steps``.

``build_cell(cfg, shape, mesh)`` returns ``(step_fn, specs, structs,
donated)`` as the reference's builders do: the step function, the specs of
its arguments (``distributed.partition``), their global shapes as meta
tensors, and the positions of the arguments it updates in place.  The
step function runs on every rank of ``mesh`` on local shards
(``shard_model``, ``shard_tensor``), inside ``act_sharding.policy``:

* train: FSDP over ``data`` and tensor parallel over ``model``, the batch
  over (pod, data); each parameter's gradient summed over the batch axes
  it is not sharded on; the global norm counts each element once; AdamW
  on the local shards, in place;
* prefill / decode: weights tensor parallel (FSDP off), caches sharded on
  the sequence over ``model`` (decode through flash decode there), SSM
  states gathered over ``model`` for the step and sliced after.

``build_local_train_cell(cfg, adamw, ...)`` (no shape, no mesh) is the
one-device step alone, as ``launch/train.py --local`` and the train loop
run it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed import act_sharding, partition
from ..distributed.decode_attn import make_gqa_flash_decode, make_mla_flash_decode
from ..models import model as M
from ..models.config import ModelConfig, ShapeConfig
from ..train.optimizer import AdamWConfig, adamw_update, clip_by_global_norm, opt_state_shape


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    out: dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = torch.empty((b, s), dtype=torch.int64, device=meta)
        out["labels"] = torch.empty((b, s), dtype=torch.int64, device=meta)
    elif shape.kind == "prefill":
        out["tokens"] = torch.empty((b, s), dtype=torch.int64, device=meta)
    else:  # decode: one new token against a seq_len cache
        out["tokens"] = torch.empty((b, 1), dtype=torch.int64, device=meta)
    if cfg.frontend == "vlm_stub" and shape.kind != "decode":
        out["prefix_embeds"] = torch.empty((b, cfg.num_prefix_embeddings, cfg.d_model),
                                           dtype=torch.bfloat16, device=meta)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict[str, tuple]:
    bspec = partition.batch_spec(mesh, shape.global_batch)
    return {k: bspec if v.ndim >= 1 else () for k, v in batch_struct(cfg, shape).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """All model inputs of a cell, as meta tensors: the reference's public
    name for ``batch_struct``, which its dry-run and tests call."""
    return batch_struct(cfg, shape)


def norm_batch_axes(bspec: tuple) -> tuple[str, ...] | None:
    """The mesh axes a batch spec splits the rows over (None: whole)."""
    axes = bspec[0] if len(bspec) else None
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_tensor(full: torch.Tensor, spec: tuple, mesh, device=None, copy: bool = True) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: a copy on ``device``
    (without ``copy``, ``full`` itself where the block is all of it on
    that device); a meta tensor of the local shape when ``full`` is on the
    meta device."""
    if full.device.type == "meta":
        return torch.empty(partition.local_shape(full.shape, spec, mesh), dtype=full.dtype, device="meta")
    block = full[partition.local_slices(full.shape, spec, mesh_coords(mesh), mesh)]
    return block.to(device if device is not None else full.device, copy=copy).contiguous()


def shard_model(cfg: ModelConfig, mesh, fsdp: bool, full: M.Transformer | None = None,
                device=None, copy: bool = True) -> M.Transformer:
    """This rank's shard of a model under ``param_specs``: blocks of
    ``full`` (on ``device``, by default ``full``'s; without ``copy`` a
    block that is a whole tensor on that device is ``full``'s own), or meta
    tensors of the local shapes when ``full`` is None.  Each module keeps
    its parameters' specs in ``_specs``, which ``act_sharding.weight``
    reads."""
    src = full if full is not None else M.params_shape(cfg)
    specs = partition.param_specs(cfg, mesh, src, fsdp)
    local = M.Transformer(cfg, device="meta")
    tensors = dict(src.named_parameters())
    for name, spec in specs.items():
        owner, leaf = local, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = local.get_submodule(path)
        value = shard_tensor(tensors[name], spec, mesh, device, copy)
        setattr(owner, leaf, nn.Parameter(value, requires_grad=False))
        owner.__dict__.setdefault("_specs", {})[leaf] = spec
    return local


def shard_cache(cfg: ModelConfig, mesh, cache: dict, batch: int, device=None) -> dict:
    """This rank's shard of a cache under ``cache_specs``."""
    specs = partition.cache_specs(cfg, mesh, cache, batch)
    return {"length": cache["length"],
            "layers": [{k: shard_tensor(v, specs["layers"][i][k], mesh, device) for k, v in lc.items()}
                       for i, lc in enumerate(cache["layers"])]}


def _seq_split(c_specs: dict) -> bool:
    """Whether the attention caches hold a slice of the sequence."""
    return any(spec[1] == "model" for lc in c_specs["layers"] for k, spec in lc.items() if k in ("k", "v", "c"))


def _states(cache: dict, c_specs: dict, gather: bool) -> None:
    """Gather (or slice back) the SSM states' ``model``-sharded dimension."""
    for lc, specs in zip(cache["layers"], c_specs["layers"]):
        for k in ("h", "conv"):
            if k in lc and "model" in specs[k]:
                dim = specs[k].index("model")
                lc[k] = (act_sharding.gather_nograd(lc[k], "model", dim) if gather
                         else act_sharding.local_block(lc[k], "model", dim).contiguous())


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def accumulate_grads(cfg: ModelConfig, params: M.Transformer, batch: dict, microbatches: int = 1,
                     remat: bool = True, seq_chunk: int = 1_024) -> tuple[torch.Tensor, dict]:
    """``(loss, {state_dict name: gradient})`` of ``lm_loss`` over ``batch``
    (``tokens``, ``labels`` and, for the VLM stub, ``prefix_embeds``); the
    model's parameters are made trainable.

    ``microbatches`` > 1 splits the batch into that many equal slices, run
    one after another, their gradients summed in float32 as ``g / n``; the
    loss is the mean of theirs.  Live activations shrink by ~n."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())

    def loss_and_grads(mb: dict):
        loss = M.lm_loss(cfg, params, mb["tokens"], mb["labels"], mb.get("prefix_embeds"),
                         remat=remat, seq_chunk=seq_chunk)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for (k, p), g in zip(named.items(), grads)}

    if microbatches <= 1:
        return loss_and_grads(batch)
    n = microbatches
    rows = batch["tokens"].shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
    grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in named.items()}
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    for i in range(n):
        mb = {k: v[i * rows // n:(i + 1) * rows // n] for k, v in batch.items() if v is not None}
        mb_loss, g = loss_and_grads(mb)
        for k, gi in g.items():
            grads[k] += gi.float() / n
        loss = loss + mb_loss / n
    return loss, grads


def _axes_of(spec: tuple) -> set[str]:
    out: set[str] = set()
    for entry in spec:
        if entry is not None:
            out.update((entry,) if isinstance(entry, str) else entry)
    return out


def sum_replicated_grads(grads: dict, specs: dict) -> dict:
    """Sum each gradient over the batch axes its parameter is not sharded
    on (those it is sharded on were reduce-scattered in the backward)."""
    out = {}
    for name, g in grads.items():
        g = g.contiguous()
        for axis in act_sharding.batch_axes():
            if axis not in _axes_of(specs[name]):
                act_sharding.all_reduce(g, axis)
        out[name] = g
    return out


def sharded_global_norm(grads: dict, specs: dict) -> torch.Tensor:
    """The global L2 norm of sharded gradients, each element counted once:
    a shard's squares divided by the number of ranks that hold it, then
    summed over every axis of the mesh."""
    pol = act_sharding.current_policy()
    sizes = pol["sizes"]
    total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for name, g in grads.items():
        replicas = math.prod(n for a, n in sizes.items() if a not in _axes_of(specs[name]))
        total = total + (g.float() ** 2).sum() / replicas
    for axis, n in sizes.items():
        if n > 1:
            act_sharding.all_reduce(total, axis)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------


def _metrics(loss, gnorm, grads: dict, return_grads: bool) -> dict:
    return {"loss": loss, "grad_norm": gnorm, **({"grads": grads} if return_grads else {})}


def build_local_train_cell(cfg: ModelConfig, adamw: AdamWConfig | None = None, remat: bool = True,
                           microbatches: int = 1, seq_chunk: int = 1_024, return_grads: bool = False):
    """The one-device step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``: ``lm_loss`` and its
    gradients (``accumulate_grads``, over ``microbatches`` slices),
    global-norm clipping, one AdamW update (in place on the model's
    parameters and the moments).  ``params`` is the model
    (``models.model.Transformer``).  ``return_grads`` adds the clipped
    gradients the update took, as ``"grads"``."""
    adamw = adamw or AdamWConfig()

    def train_step(params: M.Transformer, opt_state: dict, batch: dict):
        loss, grads = accumulate_grads(cfg, params, batch, microbatches, remat, seq_chunk)
        grads, gnorm = clip_by_global_norm(grads, adamw.grad_clip)
        adamw_update(adamw, dict(params.named_parameters()), grads, opt_state)
        return params, opt_state, _metrics(loss, gnorm, grads, return_grads)

    return train_step


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, adamw: AdamWConfig | None = None,
                     remat: bool = True, moe_impl: str = "expert_parallel", microbatches: int = 1,
                     seq_chunk: int = 1_024, return_grads: bool = False):
    """The train cell on ``mesh``: ``train_step(params, opt_state, batch)``
    on this rank's shards (``shard_model(cfg, mesh, fsdp=True, ...)``, the
    moments shaped alike, the batch's rows over (pod, data)); returns
    (params, opt_state, {"loss", "grad_norm"}), the same on every rank.
    ``return_grads`` adds this rank's shards of the clipped gradients the
    update took, as ``"grads"``."""
    adamw = adamw or AdamWConfig()
    p_shape = M.params_shape(cfg)
    p_specs = partition.param_specs(cfg, mesh, p_shape, fsdp=True)
    o_specs = {"step": (), "m": p_specs, "v": p_specs}
    b_axes = norm_batch_axes(partition.batch_spec(mesh, shape.global_batch))

    def train_step(params: M.Transformer, opt_state: dict, batch: dict):
        with act_sharding.policy(mesh, b_axes, moe_impl):
            loss, grads = accumulate_grads(cfg, params, batch, microbatches, remat, seq_chunk)
            grads = sum_replicated_grads(grads, p_specs)
            gnorm = sharded_global_norm(grads, p_specs)
            scale = torch.clamp(adamw.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
            adamw_update(adamw, dict(params.named_parameters()), grads, opt_state)
        return params, opt_state, _metrics(loss, gnorm, grads, return_grads)

    structs = (p_shape, opt_state_shape(dict(p_shape.named_parameters())), batch_struct(cfg, shape))
    return train_step, (p_specs, o_specs, batch_specs(cfg, shape, mesh)), structs, (0, 1)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, remat: bool = True,
                       moe_impl: str = "expert_parallel"):
    """``prefill_step(params, batch, cache) -> (last logits [B_local, 1, V],
    cache)`` on this rank's shards (``shard_model(cfg, mesh, fsdp=False,
    ...)``, ``shard_cache``)."""
    p_shape = M.params_shape(cfg)
    p_specs = partition.param_specs(cfg, mesh, p_shape, fsdp=False)
    total_seq = shape.seq_len + (cfg.num_prefix_embeddings if cfg.frontend == "vlm_stub" else 0)
    c_shape = M.cache_shape(cfg, shape.global_batch, total_seq)
    c_specs = partition.cache_specs(cfg, mesh, c_shape, shape.global_batch)
    b_axes = norm_batch_axes(partition.batch_spec(mesh, shape.global_batch))
    seq_shards = partition.axis_size(mesh, "model") if _seq_split(c_specs) else 1

    def prefill_step(params: M.Transformer, batch: dict, cache: dict):
        with act_sharding.policy(mesh, b_axes, moe_impl), torch.no_grad():
            cache["seq_shards"] = seq_shards
            logits, cache = M.prefill(cfg, params, batch["tokens"], cache, batch.get("prefix_embeds"),
                                      remat=remat, last_only=True)
            _states(cache, c_specs, gather=False)
        return logits, cache

    specs = (p_specs, batch_specs(cfg, shape, mesh), c_specs)
    return prefill_step, specs, (p_shape, batch_struct(cfg, shape), c_shape), (2,)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, flash_decode: bool = True,
                      moe_impl: str = "expert_parallel", cache_mode: str = "carry"):
    """``serve_step(params, cache, batch) -> (logits [B_local, 1, V], cache)``
    for one token against a ``shape.seq_len`` cache; flash decode over
    ``model`` where the caches hold a slice of the sequence (the dense
    decode otherwise, and with ``flash_decode=False`` on whole caches)."""
    p_shape = M.params_shape(cfg)
    p_specs = partition.param_specs(cfg, mesh, p_shape, fsdp=False)
    c_shape = M.cache_shape(cfg, shape.global_batch, shape.seq_len)
    b_axes = norm_batch_axes(partition.batch_spec(mesh, shape.global_batch))
    flash = flash_decode and partition.axis_size(mesh, "model") > 1
    c_specs = partition.cache_specs(cfg, mesh, c_shape, shape.global_batch)
    if not flash:  # the dense decode reads whole caches
        c_specs = {"length": (), "layers": [{k: spec if k not in ("k", "v", "c") else
                                             spec[:1] + (None,) * (len(spec) - 1) for k, spec in lc.items()}
                                            for lc in c_specs["layers"]]}
    flash = flash and _seq_split(c_specs)

    def serve_step(params: M.Transformer, cache: dict, batch: dict):
        with act_sharding.policy(mesh, b_axes, moe_impl), torch.no_grad():
            hooks = {}
            if flash:
                group = mesh.get_group("model")
                hooks = {"gqa_attn_impl": make_gqa_flash_decode(group),
                         "mla_attn_impl": make_mla_flash_decode(group)}
            _states(cache, c_specs, gather=True)
            logits, cache = M.decode_step(cfg, params, cache, batch["tokens"], cache_mode=cache_mode, **hooks)
            _states(cache, c_specs, gather=False)
        return logits, cache

    specs = (p_specs, c_specs, batch_specs(cfg, shape, mesh))
    return serve_step, specs, (p_shape, c_shape, batch_struct(cfg, shape)), (1,)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw):
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, **kw)
    return build_decode_cell(cfg, shape, mesh, **kw)
