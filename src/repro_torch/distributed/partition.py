"""Partitioning rules: parameter, batch and cache specs for any mesh;
mirrors ``repro.distributed.partition``.

Scheme (the reference's):

* **Training**: the batch over (pod, data); parameters 2-D sharded, FSDP
  (ZeRO-3) over ``data`` on the input-feature dimension and tensor
  parallel over ``model`` on the output-feature / head / expert dimension;
  the optimizer's moments like the parameters; gradients summed over the
  batch axes a parameter is not sharded on.
* **Serving**: weights tensor parallel over ``model`` with FSDP off
  (replicated over ``data``), requests over ``data``; decode caches
  sharded on the *sequence* dimension over ``model`` (flash decode merges
  the partial softmax statistics), the batch over ``data`` when it
  divides.
* A dimension that does not divide its axes' size stays whole.

A spec is a plain tuple with one entry per dimension: an axis name, a
tuple of names, or None; it equals ``tuple(PartitionSpec)`` of the
reference's entry.  Parameters are keyed by the port's ``state_dict``
names (``layers.<i>.attn.w_q``), one layer each, so the reference's
leading None for the stacked periods axis is dropped.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh``, a dict of axis sizes, or any
object whose ``.shape`` is such a dict.
"""

from __future__ import annotations

import math

Spec = tuple


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, a dict, or an object with a
    ``.shape`` dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _div(dim: int, mesh, axis):
    """``axis`` if ``dim`` divides its total size (above one), else None; a
    tuple of one axis becomes its name, as ``PartitionSpec`` writes it."""
    if axis is None:
        return None
    total = math.prod(axis_size(mesh, a) for a in _axes(axis))
    if total <= 1 or dim % total:
        return None
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def batch_spec(mesh, batch: int) -> Spec:
    full = _div(batch, mesh, batch_axes(mesh))
    return (full if full is not None else _div(batch, mesh, "data"),)


def param_rule(mesh, name: str, shape: tuple[int, ...], fsdp: bool) -> Spec:
    """The spec of the parameter ``name`` (a ``state_dict`` name) of
    ``shape``: ``_param_rule`` without the periods axis."""
    d_axis = "data" if fsdp else None
    leaf = name.split(".")[-1]
    # Embedding / head: vocab on `model` when divisible; never the d_model
    # contraction dimension on `data`.
    if leaf == "embed":
        return (_div(shape[0], mesh, "model"), None)
    if leaf in ("lm_head", "vision_proj"):
        return (None, _div(shape[1], mesh, "model"))
    if leaf == "ln_final":
        return (None,)
    if len(shape) == 1:  # norms, biases, scalars
        if leaf in ("b_q", "b_k", "b_v"):
            return (_div(shape[0], mesh, "model"),)
        return (None,)
    if leaf in ("w_q", "w_k", "w_v", "w_dq", "w_uq", "w_dkv", "w_ukv", "w_gate", "w_up", "w_in"):
        if len(shape) == 3:  # MoE experts [E, D, F]
            return (_div(shape[0], mesh, "model"), _div(shape[1], mesh, d_axis), None)
        return (_div(shape[0], mesh, d_axis), _div(shape[1], mesh, "model"))
    if leaf in ("w_o", "w_down", "w_out"):
        if len(shape) == 3:  # MoE [E, F, D]
            return (_div(shape[0], mesh, "model"), _div(shape[1], mesh, d_axis), None)
        return (_div(shape[0], mesh, "model"), _div(shape[1], mesh, d_axis))
    if leaf == "router":
        return (_div(shape[0], mesh, d_axis), None)
    return (None,) * len(shape)  # conv_w and the rest: replicated


def param_specs(cfg, mesh, params, fsdp: bool) -> dict[str, Spec]:
    """``{state_dict name: spec}`` of a model (``models.model.Transformer``,
    on any device, the meta device included) or of a dict of tensors."""
    named = params.named_parameters() if hasattr(params, "named_parameters") else params.items()
    return {name: param_rule(mesh, name, tuple(p.shape), fsdp) for name, p in named}


def cache_specs(cfg, mesh, cache: dict, batch: int) -> dict:
    """``{"length": (), "layers": [{name: spec}]}`` for a cache of
    ``models.model.init_cache``: attention caches on the sequence over
    ``model``; an SSM state's heads take ``model`` only when the batch
    cannot use ``data`` (the long-context batch of one)."""
    b_spec = _div(batch, mesh, batch_axes(mesh)) or _div(batch, mesh, "data")

    def rule(name: str, shape) -> Spec:
        if name in ("k", "v"):  # [B, S, KVH, hd]
            return (b_spec, _div(shape[1], mesh, "model"), None, None)
        if name == "c":  # MLA [B, S, r + rope]
            return (b_spec, _div(shape[1], mesh, "model"), None)
        if name == "h":  # SSM [B, H, hd, N]
            return (b_spec, None if b_spec else _div(shape[1], mesh, "model"), None, None)
        if name == "conv":  # [B, conv - 1, C]
            return (b_spec, None, _div(shape[2], mesh, "model"))
        return (None,) * len(shape)

    return {"length": (), "layers": [{k: rule(k, tuple(v.shape)) for k, v in lc.items()}
                                     for lc in cache["layers"]]}


# ------------------------------------------------------------- local shards --
def local_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape one rank holds of a tensor of ``shape`` under ``spec``."""
    out = []
    for dim, entry in zip(shape, spec):
        out.append(dim // math.prod(axis_size(mesh, a) for a in _axes(entry)))
    return tuple(out) + tuple(shape[len(spec):])


def shard_index(entry, coords: dict[str, int], mesh) -> tuple[int, int]:
    """(index, count) of the block a rank at mesh coordinates ``coords``
    holds along one dimension sharded over ``entry``'s axes (the first
    axis major, as ``PartitionSpec`` orders them)."""
    index, count = 0, 1
    for a in _axes(entry):
        size = axis_size(mesh, a)
        index, count = index * size + coords.get(a, 0), count * size
    return index, count


def local_slices(shape, spec: Spec, coords: dict[str, int], mesh) -> tuple[slice, ...]:
    """The slice of a tensor of ``shape`` that the rank at ``coords`` holds."""
    out = []
    for dim, entry in zip(shape, spec):
        index, count = shard_index(entry, coords, mesh)
        per = dim // count
        out.append(slice(index * per, (index + 1) * per))
    return tuple(out)
