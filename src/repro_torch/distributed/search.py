"""Distributed vector search: Manu's segment-parallel two-phase reduce over
a process group; mirrors ``repro.distributed.search``.

The paper's scale-out (§3.6): segments spread over query nodes, each node
computes its top-k and the proxy reduces them to the global top-k.  Here
the base rows are sharded over the group's ranks (padded to equal shards,
the padding invalid); each rank scans its shard with ``ops.topk_scan`` (the
``l2_topk`` kernel on the card, its plain version on the CPU) at its global
row offset, the ranks ``all_gather`` their k-sized partials (bytes moved
O(world * k), whatever the collection's size), and one ``ops.merge_topk``
(the ``merge_topk`` kernel) reduces them with the global row ids as pks.

``dryrun_search`` runs the search on meta shards over a fake world of a
mesh's size and reports what it would cost per rank (the reference lowers
and compiles it for the TPU mesh).  On the meta device the scan and the
merge are their plain formulas (``torch.topk`` of the expanded L2 or the
inner product; the merge of the world's distinct row ids needs no dedup),
since no kernel runs there; the gather is the same.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..kernels import ops
from . import act_sharding


def make_distributed_search(group, k: int, metric: str = "l2"):
    """Returns ``search(queries [NQ, D] (the same on every rank), base
    shard [N / world, D], valid shard [N / world]) -> (scores [NQ, k],
    global row ids [NQ, k])``, the same on every rank: ascending L2
    distances or descending inner products, -1 (and the metric's fill)
    where fewer than k rows are valid.  Shards are equal, and rank r holds
    rows [r * N / world, (r + 1) * N / world)."""

    def search(queries: torch.Tensor, base_shard: torch.Tensor, valid_shard: torch.Tensor):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        rows_local = base_shard.shape[0]
        k_local = min(k, rows_local)
        meta = base_shard.device.type == "meta"
        scan = _meta_scan if meta else ops.topk_scan
        scores, idx = scan(queries, base_shard, k_local, metric, valid=valid_shard.bool())
        ids = torch.where(idx >= 0, idx + rank * rows_local, idx)
        # two-phase reduce: one all_gather of the k-sized partials, then a
        # merge of the world * k candidates on every rank
        all_scores = [torch.empty_like(scores) for _ in range(world)]
        all_ids = [torch.empty_like(ids) for _ in range(world)]
        for part, out in ((scores, all_scores), (ids, all_ids)):
            act_sharding.record("all", "all-gather", part)
            dist.all_gather(out, part.contiguous(), group=group)
        merge = _meta_merge if meta else ops.merge_topk
        return merge(torch.cat(all_scores, 1), torch.cat(all_ids, 1), k, metric)

    return search


def _shard_rows(base, rank: int, world: int):
    """Rank ``rank``'s shard of ``base`` [N, D] padded to a multiple of
    ``world`` rows: (rows [N_pad / world, D], valid [N_pad / world] int32,
    1 on real rows)."""
    n = base.shape[0]
    per = -(-n // world)
    lo, hi = rank * per, min((rank + 1) * per, n)
    rows = np.zeros((per, base.shape[1]), np.float32)
    valid = np.zeros(per, np.int32)
    if hi > lo:
        rows[: hi - lo] = base[lo:hi]
        valid[: hi - lo] = 1
    return rows, valid


def distributed_search_host(queries, base, k: int, metric: str = "l2", group=None, device="cuda"):
    """Convenience wrapper, called on every rank with the whole ``base``
    (numpy): takes this rank's padded shard to ``device`` and runs the
    search.  Returns (scores, global row ids) as numpy on every rank."""
    dev = resolve_device(device)
    rows, valid = _shard_rows(np.asarray(base, np.float32), dist.get_rank(group),
                             dist.get_world_size(group))
    search = make_distributed_search(group, k, metric)
    scores, ids = search(torch.from_numpy(np.asarray(queries, np.float32)).to(dev),
                         torch.from_numpy(rows).to(dev), torch.from_numpy(valid).to(dev))
    return scores.cpu().numpy(), ids.cpu().numpy()


def _meta_scan(queries, base, k: int, metric: str, valid=None):
    """The scan's plain formula, for shapes on the meta device."""
    q, x = queries.float(), base.float()
    if metric == "l2":
        scores = (q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
    else:
        scores = q @ x.T
    scores = scores.masked_fill(~valid[None, :], float("inf") if metric == "l2" else float("-inf"))
    return torch.topk(scores, k, dim=1, largest=metric != "l2")


def _meta_merge(scores, ids, k: int, metric: str):
    vals, sel = torch.topk(scores, k, dim=1, largest=metric != "l2")
    return vals, ids.gather(1, sel)


def dryrun_search(mesh, n_rows: int, dim: int, nq: int, k: int, metric: str = "l2") -> dict:
    """The distributed search over ``n_rows`` x ``dim`` rows sharded over
    every rank of ``mesh`` (a ``DeviceMesh`` on the default group, e.g. the
    dry-run's fake world), ``nq`` queries, top ``k``, run on meta shards as
    rank 0: ``{"flops_per_device", "collectives": {kind: bytes}, "rows_per_device"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    world = dist.get_world_size()
    rows = -(-n_rows // world)
    meta = torch.device("meta")
    search = make_distributed_search(None, k, metric)
    with act_sharding.tally() as tally, FlopCounterMode(display=False) as flops:
        search(torch.empty((nq, dim), device=meta), torch.empty((rows, dim), device=meta),
               torch.empty(rows, dtype=torch.int32, device=meta))
    return {"flops_per_device": float(flops.get_total_flops()), "rows_per_device": rows,
            "world": world, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "collectives": {kind: row["bytes"] for axis in tally.counts.values() for kind, row in axis.items()}}
