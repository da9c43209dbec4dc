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

``dryrun_search`` lowers the search for a TPU mesh in the reference: it
waits for ROADMAP Queue 1 item 4, step 7.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..kernels import ops


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
        scores, idx = ops.topk_scan(queries, base_shard, k_local, metric, valid=valid_shard.bool())
        ids = torch.where(idx >= 0, idx + rank * rows_local, idx)
        # two-phase reduce: one all_gather of the k-sized partials, then a
        # merge of the world * k candidates on every rank
        all_scores = [torch.empty_like(scores) for _ in range(world)]
        all_ids = [torch.empty_like(ids) for _ in range(world)]
        dist.all_gather(all_scores, scores.contiguous(), group=group)
        dist.all_gather(all_ids, ids.contiguous(), group=group)
        return ops.merge_topk(torch.cat(all_scores, 1), torch.cat(all_ids, 1), k, metric)

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
