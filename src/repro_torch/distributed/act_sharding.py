"""The distributed-execution scope of the model code; the part of
``repro.distributed.act_sharding`` a process group needs.

The reference's launcher installs a policy (mesh, batch axes, MoE
implementation) around a cell, and the model code reads it: sharding
constraints, and ``models.moe.moe_block``'s choice of the expert-parallel
``shard_map``.  Here the policy is a process group and the MoE
implementation: inside ``policy(group)`` every MoE block computes
``E / world`` experts on each rank and sums the ranks' outputs
(``models.moe``).  Outside it, and with ``moe_impl="dense"``, the dense
formulation runs.  The sharding constraints (``constrain``,
``constrain_tree_batch``) wait for ROADMAP Queue 1 item 4, step 7.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_STATE = threading.local()

#: The MoE implementations a policy selects: experts split over the
#: group's ranks (the reference's ``"shard_map"``), or the dense buffer.
MOE_IMPLS = ("expert_parallel", "dense")


def current_policy() -> dict | None:
    """The innermost policy installed on this thread, or None."""
    return getattr(_STATE, "policy", None)


@contextmanager
def policy(group=None, moe_impl: str = "expert_parallel"):
    """Run the model code in its scope over ``group`` (None: the default
    process group)."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got {moe_impl!r}")
    outer = current_policy()
    _STATE.policy = {"group": group, "moe_impl": moe_impl}
    try:
        yield
    finally:
        _STATE.policy = outer
