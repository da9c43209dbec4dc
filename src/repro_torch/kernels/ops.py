"""Public entry points of the port's kernel layer (mirrors the read-path part
of ``repro.kernels.ops``).

Everything takes and returns torch tensors on one device.  The scan and
merge dispatch by device inside their kernel modules: CUDA tensors launch
the hand-written kernels, CPU tensors run the plain PyTorch versions.  The
mask ops are plain tensor code on either device.
"""

from __future__ import annotations

import torch

from .l2_topk import MAX_K as MAX_SCAN_K
from .l2_topk import l2_topk
from .merge_topk import MAX_M as MAX_MERGE_WIDTH
from .merge_topk import merge_topk as _merge_topk

__all__ = [
    "MAX_SCAN_K",
    "topk_scan",
    "topk_scan_segmented",
    "merge_topk",
    "isin_sorted",
    "eff_tombstones",
    "tombstone_mask",
    "mask_intersect",
    "range_cut",
    "post_filter_cut",
]


def _fill(metric: str) -> float:
    return float("inf") if metric == "l2" else float("-inf")


def topk_scan(queries, base, k: int, metric: str = "l2", valid=None):
    """Brute-force top-k scan of one segment: ``(scores [nq, k], idx [nq,
    k])``, ascending L2 distance or descending inner product; invalid or
    missing slots carry idx -1 and the metric's fill."""
    return topk_scan_segmented(queries, [base], k, metric, [valid])


def topk_scan_segmented(queries, bases, k: int, metric: str = "l2", valids=None):
    """One scan over an execution class of segments (one kernel launch on
    the card).  Returns ``(scores [nq, S*k], idx [nq, S*k])`` where block
    ``[:, s*k:(s+1)*k]`` equals ``topk_scan(queries, bases[s], k, metric,
    valids[s])`` with row indices local to ``bases[s]``."""
    if valids is None:
        valids = [None] * len(bases)
    return l2_topk(queries, list(bases), list(valids), k, metric)


def merge_topk(scores, pks, k: int, metric: str = "l2"):
    """Segmented k-way top-k merge with pk dedup (two-phase reduce): keeps
    each pk's best occurrence, drops pk < 0 and non-finite scores, breaks
    ties by pool column; missing slots are (fill, -1).

    A pool wider than the kernel takes (``MAX_MERGE_WIDTH`` columns) is
    merged in column chunks of that width, and the chunks' top-k lists,
    concatenated in chunk order, are merged again.  That is exact: a pk in
    the final top-k is in its own chunk's top-k, and chunk order keeps the
    pool-column tie-break.  Each pass shrinks the pool while 2k fits in a
    chunk; above that a wide pool raises ``ValueError``."""
    scores, pks = scores.contiguous(), pks.contiguous()
    while scores.shape[1] > MAX_MERGE_WIDTH:
        if 2 * k > MAX_MERGE_WIDTH:
            raise ValueError(
                f"merge_topk: k={k} with a pool of {scores.shape[1]} columns; a pool wider "
                f"than {MAX_MERGE_WIDTH} takes k <= {MAX_MERGE_WIDTH // 2}"
            )
        parts = [
            _merge_topk(
                scores[:, lo : lo + MAX_MERGE_WIDTH].contiguous(),
                pks[:, lo : lo + MAX_MERGE_WIDTH].contiguous(), k, metric,
            )
            for lo in range(0, scores.shape[1], MAX_MERGE_WIDTH)
        ]
        scores = torch.cat([s for s, _ in parts], 1)
        pks = torch.cat([p for _, p in parts], 1)
    return _merge_topk(scores, pks, k, metric)


def isin_sorted(values, sorted_haystack):
    """Membership of ``values`` in a SORTED 1-D haystack (binary search)."""
    if sorted_haystack.numel() == 0 or values.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    idx = torch.searchsorted(sorted_haystack, values)
    idx = idx.clamp_(max=sorted_haystack.numel() - 1)
    return sorted_haystack[idx] == values


def eff_tombstones(pks, dts, ts: int):
    """Reduce (pk, delete-ts) tombstone pairs to ``(sorted unique pks,
    effective delete ts)`` at query time ``ts``: the latest delete with
    ``dts <= ts`` per pk.  ``None`` when no tombstone applies."""
    sel = dts <= ts
    if not bool(sel.any()):
        return None
    p, d = pks[sel], dts[sel]
    o = torch.sort(d, stable=True).indices  # lexsort((d, p)): d, then p
    p, d = p[o], d[o]
    o = torch.sort(p, stable=True).indices
    p, d = p[o], d[o]
    last = torch.ones_like(p, dtype=torch.bool)
    last[:-1] = p[1:] != p[:-1]
    return p[last], d[last]


def tombstone_mask(seg_pks, seg_ts, doomed_pks, doomed_eff):
    """Rows killed by a materialized tombstone set: the row's pk is doomed
    AND its row timestamp predates the pk's effective delete."""
    if seg_pks.numel() == 0 or doomed_pks.numel() == 0:
        return torch.zeros(seg_pks.shape, dtype=torch.bool, device=seg_pks.device)
    idx = torch.searchsorted(doomed_pks, seg_pks).clamp_(max=doomed_pks.numel() - 1)
    return (doomed_pks[idx] == seg_pks) & (seg_ts < doomed_eff[idx])


def mask_intersect(*masks):
    """AND row bitmaps together, skipping ``None`` (all-visible) operands;
    ``None`` when every operand is ``None``."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m.clone() if out is None else (out & m)
    return out


def range_cut(scores, pks, metric: str = "l2", radius=None, range_filter=None):
    """Radius cut for range search, Milvus convention: L2 keeps
    ``range_filter <= d < radius``; IP/cosine keeps ``radius < s <=
    range_filter``.  Cut slots become (fill, -1) and are not compacted."""
    keep = (pks >= 0) & torch.isfinite(scores)
    if metric == "l2":
        if radius is not None:
            keep &= scores < radius
        if range_filter is not None:
            keep &= scores >= range_filter
    else:
        if radius is not None:
            keep &= scores > radius
        if range_filter is not None:
            keep &= scores <= range_filter
    return torch.where(keep, scores, _fill(metric)), torch.where(keep, pks, -1)


def post_filter_cut(scores, idx, keep, metric: str = "l2"):
    """Cut candidates (segment-local ``idx``, -1 = empty) whose row fails
    the filter bitmap ``keep``; failing slots become (fill, -1)."""
    alive = idx >= 0
    if keep.numel():
        ok = keep[idx.clamp(min=0, max=keep.numel() - 1)] & alive
    else:
        ok = torch.zeros_like(alive)
    dead = alive & ~ok
    return torch.where(dead, _fill(metric), scores), torch.where(dead, -1, idx)
