"""The distributed-execution scope of the model code; mirrors
``repro.distributed.act_sharding``.

The reference's launcher installs a policy (mesh, batch axes, MoE
implementation) around a cell, and the model code reads it through
``constrain`` and ``model_axis_size``; GSPMD then inserts the collectives.
Here every rank runs the model code on its local shards as plain tensors,
and the policy supplies the collectives explicitly:

* ``policy(mesh, batch_axes, moe_impl)`` with a ``DeviceMesh``: the
  parameters are the local shards of ``partition.param_specs`` (each
  module keeps its parameters' specs in ``_specs``, set by
  ``launch.steps.shard_model``).  ``weight`` gathers a shard for use:
  over ``data`` always (FSDP; the backward reduce-scatters the gradient),
  over ``model`` where the block runs replicated.  Attention heads, MLP
  columns, experts and the vocabulary stay split over ``model`` where
  they divide (``head_parallel``): ``copy_to`` enters such a region
  (identity forward, sum of the gradient over ``model`` backward) and
  ``reduce_from`` leaves it (sum forward, identity backward), the
  Megatron pair.
* ``policy(group)`` (or ``policy(None)``, the default group): the
  parameters are whole on every rank, and only ``models.moe`` changes: each
  rank computes ``E / world`` experts and the ranks' outputs are summed,
  with the same pair around the block so that it trains.

Outside a policy, and with ``moe_impl="dense"`` for the MoE block, the
model code runs as on one device.  The policy is per thread; the model
code's remat goes through ``checkpoint``, which carries the forward's
policy into the recompute (a CUDA backward runs on the autograd engine's
own thread).  Every collective goes through this
module on one mesh axis's group and is tallied per axis and kind (operand
bytes and calls, ``tally()``), which the dry-run reads.  An axis of size
one runs no collective and tallies nothing.
"""

from __future__ import annotations

import functools
import threading
import warnings
from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.utils.checkpoint

_STATE = threading.local()

#: The MoE implementations a policy selects: experts split over the
#: ``model`` axis (the reference's ``"shard_map"``, also accepted), or the
#: dense buffer.
MOE_IMPLS = ("expert_parallel", "dense")


def current_policy() -> dict | None:
    """The innermost policy installed on this thread, or None."""
    return getattr(_STATE, "policy", None)


def _is_mesh(obj) -> bool:
    return hasattr(obj, "mesh_dim_names") and hasattr(obj, "get_group")


@contextmanager
def policy(mesh=None, batch_axes: tuple[str, ...] | None = None, moe_impl: str = "expert_parallel"):
    """Run the model code in its scope over ``mesh`` (a ``DeviceMesh``,
    with the batch sharded over ``batch_axes``) or over a process group
    (None: the default group) that only the MoE block splits over."""
    if moe_impl == "shard_map":
        moe_impl = "expert_parallel"
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got {moe_impl!r}")
    if _is_mesh(mesh):
        names = tuple(mesh.mesh_dim_names)
        groups = {a: mesh.get_group(a) for a in names}
        coords = dict(zip(names, mesh.get_coordinate()))
        sizes = dict(zip(names, mesh.shape))
        sharded = True
    else:
        groups = {"model": mesh}
        coords = {"model": dist.get_rank(mesh)}
        sizes = {"model": dist.get_world_size(mesh)}
        sharded, batch_axes = False, ()
    outer = current_policy()
    _STATE.policy = {"mesh": mesh if sharded else None, "group": None if sharded else mesh,
                     "groups": groups, "coords": coords, "sizes": sizes, "sharded": sharded,
                     "batch": tuple(a for a in (batch_axes or ()) if sizes.get(a, 1) > 1),
                     "moe_impl": moe_impl}
    try:
        yield _STATE.policy
    finally:
        _STATE.policy = outer


# ------------------------------------------------------------------ queries --
def axis_size(axis: str) -> int:
    pol = current_policy()
    return 1 if pol is None else pol["sizes"].get(axis, 1)


def axis_rank(axis: str) -> int:
    pol = current_policy()
    return 0 if pol is None else pol["coords"].get(axis, 0)


def model_axis_size() -> int:
    """The tensor-parallel width: ``model``'s size under a mesh policy, 1
    outside one and under a process-group policy."""
    pol = current_policy()
    return axis_size("model") if pol is not None and pol["sharded"] else 1


def batch_axes() -> tuple[str, ...]:
    """The mesh axes (of more than one rank) the batch is split over."""
    pol = current_policy()
    return () if pol is None else pol["batch"]


def expert_parallel() -> bool:
    pol = current_policy()
    return pol is not None and pol["moe_impl"] == "expert_parallel"


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's sharding constraint, kept so that code written
    against the reference's names runs: ``x``.  A local shard's layout is
    fixed by the cell that makes it, and the model code calls the
    collectives below itself, so there is nothing for it to do."""
    return x


def constrain_tree_batch(tree, batch_dim_by_rank: dict[int, int] | None = None):
    """The reference's batch constraint on every leaf, kept as ``constrain``
    is: the tree itself."""
    return tree


def _in_policy(pol: dict | None, fn, *args):
    outer = current_policy()
    _STATE.policy = pol
    try:
        return fn(*args)
    finally:
        _STATE.policy = outer


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute runs in the policy of the forward: the recompute runs inside
    the backward, on whatever thread runs it, where this thread's policy
    is not installed."""
    return torch.utils.checkpoint.checkpoint(functools.partial(_in_policy, current_policy(), fn), *args,
                                             use_reentrant=False)


# ------------------------------------------------------------------- tally --
class Tally:
    """Operand bytes and calls of the collectives, per mesh axis and kind."""

    def __init__(self):
        self.counts: dict[str, dict[str, dict[str, int]]] = {}

    def add(self, axis: str, kind: str, nbytes: int) -> None:
        row = self.counts.setdefault(axis, {}).setdefault(kind, {"bytes": 0, "calls": 0})
        row["bytes"] += int(nbytes)
        row["calls"] += 1

    def total_bytes(self) -> int:
        return sum(r["bytes"] for kinds in self.counts.values() for r in kinds.values())


# Process-wide, not per thread: the autograd engine runs a CUDA backward
# on a thread of its own.
_TALLIES: list[Tally] = []


@contextmanager
def tally():
    """Count every collective the process runs inside the block."""
    t = Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def record(axis: str, kind: str, x: torch.Tensor) -> None:
    """Tally a collective made outside this module (``decode_attn``,
    ``search``) under ``axis``."""
    for t in _TALLIES:
        t.add(axis, kind, x.numel() * x.element_size())


class _Axis:
    """One mesh axis's group, size and this rank's coordinate, taken when a
    collective is recorded (its backward may run on another thread)."""

    def __init__(self, name: str):
        _quiet_renames()
        pol = current_policy()
        self.name, self.group = name, pol["groups"][name]
        self.size, self.rank = pol["sizes"][name], pol["coords"][name]

    def record(self, kind: str, x: torch.Tensor) -> None:
        record(self.name, kind, x)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        self.record("all-reduce", x)
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((self.size * xs.shape[0],) + xs.shape[1:])
        self.record("all-gather", xs)
        dist.all_gather_into_tensor(out, xs, group=self.group)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((xs.shape[0] // self.size,) + xs.shape[1:])
        self.record("reduce-scatter", xs)
        dist.reduce_scatter_tensor(out, xs, group=self.group)
        return out.movedim(0, dim)

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


@functools.cache
def _quiet_renames() -> None:
    """The ``*_tensor`` collectives warn of a rename on newer releases."""
    warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor).*",
                            category=FutureWarning)


# ------------------------------------------------------------- collectives --
def all_reduce(x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over ``axis``; records no gradient."""
    return _Axis(axis).all_reduce(x, op) if axis_size(axis) > 1 else x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_reduce(g.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return ax.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, grad):
        ctx.ax, ctx.dim, ctx.grad = ax, dim, grad
        return ax.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            return ctx.ax.reduce_scatter(g, ctx.dim), None, None, None
        return ctx.ax.chunk(g, ctx.dim).contiguous(), None, None, None


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Enter a region split over ``axis``: identity forward, the gradient
    summed over ``axis`` backward."""
    return _CopyTo.apply(x, _Axis(axis)) if axis_size(axis) > 1 else x


def reduce_from(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Leave a region split over ``axis``: the sum over ``axis`` forward,
    identity backward."""
    return _ReduceFrom.apply(x, _Axis(axis)) if axis_size(axis) > 1 else x


def gather(x: torch.Tensor, axis: str, dim: int, grad: str = "sum") -> torch.Tensor:
    """All-gather ``x``'s blocks along ``dim`` over ``axis``.  Backward,
    ``grad="sum"`` reduce-scatters (each rank used the whole tensor for
    its own part of the work), ``grad="slice"`` keeps this rank's block
    (every rank computed the same thing)."""
    return _Gather.apply(x, _Axis(axis), dim, grad) if axis_size(axis) > 1 else x


def gather_nograd(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    return _Axis(axis).gather(x, dim) if axis_size(axis) > 1 else x


def local_block(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis``."""
    return _Axis(axis).chunk(x, dim) if axis_size(axis) > 1 else x


def sum_over_batch(x: torch.Tensor) -> torch.Tensor:
    """``reduce_from`` over every batch axis."""
    for a in batch_axes():
        x = reduce_from(x, a)
    return x


# ---------------------------------------------------------------- weights --
def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_of(module, name: str):
    return getattr(module, "_specs", {}).get(name)


def is_split(module, name: str, axis: str = "model") -> bool:
    """Whether ``module.name``'s local shard is split over ``axis``."""
    pol = current_policy()
    spec = spec_of(module, name)
    if pol is None or not pol["sharded"] or spec is None or axis_size(axis) <= 1:
        return False
    return any(axis in _entry_axes(e) for e in spec)


def weight(module, name: str, model: str = "slice") -> torch.Tensor:
    """``module.name`` ready for use under a mesh policy (as it is outside
    one): gathered over each batch axis it is sharded on (FSDP: the
    gradient reduce-scattered), and over ``model`` unless ``model="keep"``.
    ``model="slice"``: the block runs replicated over ``model`` (the
    gradient keeps this rank's block); ``"sum"``: each rank uses a part
    (the gradient is summed over ``model``, through ``copy_to`` for a
    parameter that is whole on every rank)."""
    w = getattr(module, name)
    pol = current_policy()
    if pol is None or not pol["sharded"]:
        return w
    spec = spec_of(module, name) or ()
    for dim, entry in enumerate(spec):
        for axis in reversed(_entry_axes(entry)):  # the minor axis first
            if axis_size(axis) <= 1 or (axis == "model" and model == "keep"):
                continue
            w = gather(w, axis, dim, model if axis == "model" else "sum")
    if model == "sum" and not any("model" in _entry_axes(e) for e in spec):
        w = copy_to(w)
    return w


def head_parallel(cfg) -> int:
    """The number of ranks attention heads split over: ``model``'s size
    when the heads (and the KV heads, or their repeat up to it, the
    reference's partial KV repeat) divide evenly, else 1 (attention runs
    replicated)."""
    tp = model_axis_size()
    if tp <= 1:
        return 1
    h = cfg.num_heads
    if cfg.attn_type == "mla":
        return tp if h % tp == 0 else 1
    kvh = cfg.num_kv_heads
    return tp if h % tp == 0 and (kvh % tp == 0 or tp % kvh == 0) else 1
