"""Public entry points of the port's kernel layer (mirrors
``repro.kernels.ops`` as far as the port reaches).

Everything takes and returns torch tensors on one device.  The scans,
merge, assignment and SQ encoder dispatch by device inside their kernel
modules: CUDA tensors launch the hand-written kernels, CPU tensors run the
plain PyTorch versions.  The mask ops and the IVF gather-scan are plain
tensor code on either device (the reference's are numpy, outside any
kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kmeans_assign as _assign_mod
from . import pq_adc as _pq_mod
from . import sq_codec as _sq_mod
from .l2_topk import MAX_K as MAX_SCAN_K
from .l2_topk import l2_topk
from .merge_topk import MAX_M as MAX_MERGE_WIDTH
from .merge_topk import merge_topk as _merge_topk
from .sq_codec import sq_scale

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
    "kmeans_assign",
    "sq_scale",
    "sq_encode",
    "sq_decode",
    "sq_topk_scan",
    "sq_topk_scan_segmented",
    "shard_split",
    "normalized_similarity",
    "hybrid_fuse",
    "pq_adc_topk",
    "ivf_probe_schedule",
    "ivf_gather_topk",
    "IVFBucket",
    "IVFSchedule",
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


def kmeans_assign(x, centroids):
    """Nearest-centroid assignment: ``(assign [n] int64, sqdist [n]
    float32)``; the earliest centroid wins ties."""
    x = x.to(torch.float32).contiguous()
    c = centroids.to(device=x.device, dtype=torch.float32).contiguous()
    return _assign_mod.kmeans_assign(x, c)


def sq_encode(x, vmin, vmax) -> torch.Tensor:
    """float32 rows -> uint8 SQ codes (round half to even, clipped)."""
    return _sq_mod.sq_encode(x.to(torch.float32).contiguous(), vmin, vmax)


def sq_decode(codes, vmin, vmax) -> torch.Tensor:
    """uint8 SQ codes -> float32 rows ``code * scale + vmin``."""
    return _sq_mod.sq_decode(codes, vmin, vmax)


def sq_topk_scan(queries, codes, vmin, vmax, k: int, metric: str = "l2", valid=None):
    """Top-k against an SQ-compressed base with fused dequantization (the
    ``topk_scan`` contract).  Codes are taken as uint8."""
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8)
    return _sq_mod.sq_l2_topk(
        queries.contiguous(), codes.contiguous(), vmin, vmax, valid, k, metric
    )


def sq_topk_scan_segmented(queries, codes, vmin, vmax, k: int, metric: str = "l2", valids=None):
    """``topk_scan_segmented`` over SQ code segments that share ``vmin`` /
    ``vmax`` (one launch on the card): block ``[:, s*k:(s+1)*k]`` equals
    ``sq_topk_scan(queries, codes[s], vmin, vmax, k, metric, valids[s])``."""
    codes = [c if c.dtype == torch.uint8 else c.to(torch.uint8) for c in codes]
    if valids is None:
        valids = [None] * len(codes)
    return _sq_mod.sq_l2_topk_segmented(
        queries.contiguous(), [c.contiguous() for c in codes], vmin, vmax, list(valids), k, metric
    )


def pq_adc_topk(luts, codes, k: int, valid=None):
    """ADC top-k over PQ codes: ``luts`` [nq, m, ksub], ``codes`` [n, m]
    (uint8 or int32).  Ascending sums; (+inf, -1) fill."""
    if codes.dtype not in (torch.uint8, torch.int32):
        codes = codes.to(torch.int32)
    return _pq_mod.pq_adc_topk(luts.contiguous(), codes.contiguous(), k, valid)


# ---------------------------------------------------------------------------
# Batched IVF execution: probe inversion + size-bucketed gather-scan (the
# reference's ``ivf_probe_schedule`` / ``ivf_gather_topk``).  The schedule
# is host control state built with torch on the CPU from the probe matrix
# (one read-back per call); the bucket index tensors live on the scan's
# device.  Each probed list is scanned ONCE against the group of queries
# that probe it.  Buckets bound the padding of the batched products: lists
# are grouped by quantized (list length, group size) levels, with the
# in-bucket maxima as the padded extents.  Results do not depend on the
# bucketing, only the padding and the number of launches do.
# ---------------------------------------------------------------------------


@dataclass
class IVFBucket:
    """One fused-scan work item: B probed lists padded to a common (group G,
    width W) tile.  ``rows`` are absolute row indices into the permuted CSR
    storage (padding clipped to each list's first row, dead in ``wmask``);
    ``q_idx``/``slot_idx`` address the candidate pool, ``pair_idx`` the
    schedule's flat pair arrays; ``sel`` lists the real (query, list) pairs
    among the B*G group slots.  All tensors are on the scan device."""

    lo: torch.Tensor  # [B] CSR start offset per list
    rows: torch.Tensor  # [B, W]
    wmask: torch.Tensor  # [B, W] True = real row
    q_idx: torch.Tensor  # [B, G]
    slot_idx: torch.Tensor  # [B, G]
    pair_idx: torch.Tensor  # [B, G]
    sel: torch.Tensor  # [P_b] flat indices of the real pairs in [B*G]
    full: bool  # every [B, W] slot is a real row


@dataclass
class IVFSchedule:
    buckets: "list[IVFBucket]"
    pair_q: torch.Tensor  # [P] query per kept pair (list-sorted order)
    pair_list: torch.Tensor  # [P] list id per kept pair (sorted)
    nq: int
    nprobe: int


def _pow2_ceil(x: torch.Tensor) -> torch.Tensor:
    e = torch.ceil(torch.log2(x.clamp(min=1).to(torch.float64))).to(torch.int64)
    return torch.ones_like(e) << e


def _bucket_quantum(x: torch.Tensor) -> torch.Tensor:
    """Quantize up to {1, 2, 3, 4, 6, 8, 12, 16, ...}: powers of two and
    their midpoints."""
    p2 = _pow2_ceil(x)
    mid = (p2 >> 1) + (p2 >> 2)
    return torch.where(x <= mid, mid.clamp(min=1), p2)


# Coarser than the reference's 128 / 512: on the card a padded row costs
# far less than the launches and host work of one more bucket.
_SMALL_TILE_W = 1_024  # lists at or below this width share one tile class
_COARSE_W = 2_048  # up to this width, group sizes take the coarse ladder


def _pow4_ceil(x: torch.Tensor) -> torch.Tensor:
    e = torch.ceil(torch.log2(x.clamp(min=1).to(torch.float64))).to(torch.int64)
    return torch.ones_like(e) << ((e + 1) >> 1 << 1)


def ivf_probe_schedule(probes, list_offsets, max_tile_rows: int = 1 << 17, device=None):
    """Invert ``probes [nq, nprobe]`` (list ids, -1 = padded slot) into a
    bucketed gather-scan schedule over the CSR ``list_offsets`` [nlist+1].
    Padded probe slots and empty lists are dropped up front (their pool
    slots keep the fill).  The schedule is computed on the host and goes to
    ``device`` (default: the probes' device) in ONE copy; the buckets' row
    tiles and masks are expanded there."""
    dev = probes.device if device is None else torch.device(device)
    p = probes.to("cpu", torch.int64)
    offsets = torch.as_tensor(list_offsets).to("cpu", torch.int64)
    nq, nprobe = p.shape
    lengths_all = offsets[1:] - offsets[:-1]
    nlist = lengths_all.numel()

    pair_list = p.reshape(-1)
    pair_q = torch.arange(nq).repeat_interleave(nprobe)
    pair_slot = torch.arange(nprobe).repeat(nq)
    ok = (pair_list >= 0) & (pair_list < nlist)
    if nlist:
        ok &= lengths_all[pair_list.clamp(0, nlist - 1)] > 0
    pair_list, pair_q, pair_slot = pair_list[ok], pair_q[ok], pair_slot[ok]

    order = torch.sort(pair_list, stable=True).indices
    pl, pq, ps = pair_list[order], pair_q[order], pair_slot[order]
    if pl.numel() == 0:
        return IVFSchedule([], pq.to(dev), pl.to(dev), nq, nprobe)

    ulists, counts = torch.unique_consecutive(pl, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    ulen = lengths_all[ulists]
    wq = torch.clamp(_bucket_quantum(ulen), min=_SMALL_TILE_W)
    gq = torch.where(wq <= _COARSE_W, _pow4_ceil(counts), _bucket_quantum(counts))
    bkey = (wq << 32) | gq
    # Host pieces of every bucket, packed into one buffer for one copy.
    parts, shapes = [pq, ps, pl], []
    for key in torch.unique(bkey).tolist():  # bounded: one per (W, G) level pair
        mem = torch.nonzero(bkey == key).squeeze(1)
        w = int(ulen[mem].max())
        g = int(counts[mem].max())
        chunk = max(1, max_tile_rows // max(w, 1))
        for c0 in range(0, mem.numel(), chunk):
            mm = mem[c0 : c0 + chunk]
            ln = ulen[mm]
            gpos = (starts[mm][:, None] + torch.arange(g)[None, :]).clamp(max=pl.numel() - 1)
            sel = torch.nonzero((torch.arange(g)[None, :] < counts[mm][:, None]).reshape(-1))
            parts += [offsets[ulists[mm]], ln, gpos.reshape(-1), sel.reshape(-1)]
            shapes.append((len(mm), w, g, sel.numel(), bool(ln.min() == w)))
    packed = torch.cat(parts).to(dev)
    pq_d, ps_d, pl_d = packed[: pl.numel()], packed[pl.numel() : 2 * pl.numel()], packed[
        2 * pl.numel() : 3 * pl.numel()
    ]
    sched = IVFSchedule([], pq_d, pl_d, nq, nprobe)
    at = 3 * pl.numel()
    for n_b, w, g, n_sel, full in shapes:
        lo, ln = packed[at : at + n_b], packed[at + n_b : at + 2 * n_b]
        at += 2 * n_b
        gpos = packed[at : at + n_b * g].view(n_b, g)
        at += n_b * g
        sel = packed[at : at + n_sel]
        at += n_sel
        ar_w = torch.arange(w, device=dev)
        wmask = ar_w[None, :] < ln[:, None]
        sched.buckets.append(
            IVFBucket(
                lo=lo, rows=torch.where(wmask, lo[:, None] + ar_w[None, :], lo[:, None]),
                wmask=wmask, q_idx=pq_d[gpos], slot_idx=ps_d[gpos], pair_idx=gpos, sel=sel,
                full=full,
            )
        )
    return sched


def ivf_gather_topk(schedule: IVFSchedule, k: int, score_bucket, device):
    """Run a schedule's fused scans and pool per-(query, probe slot) top-k.

    ``score_bucket(bucket) -> scores [B, G, W]`` returns min-semantics
    scores (L2 distance, or negated similarity) with dead slots at +inf.
    Returns ``(pool_scores [nq, nprobe*k], pool_rows [nq, nprobe*k])``:
    block ``[:, j*k:(j+1)*k]`` holds probe slot j's candidates, ascending,
    with absolute rows into the permuted storage (+inf / -1 fill).  Ties
    break by row index (a stable sort)."""
    nq, nprobe = schedule.nq, schedule.nprobe
    pool_s = torch.full((nq, nprobe, k), float("inf"), dtype=torch.float32, device=device)
    pool_r = torch.full((nq, nprobe, k), -1, dtype=torch.int64, device=device)
    for b in schedule.buckets:
        scores = score_bucket(b)  # [B, G, W]
        n_b, g, w = scores.shape
        k_eff = min(k, w)
        vals, idx = torch.sort(scores, dim=2, stable=True)
        vals, idx = vals[:, :, :k_eff], idx[:, :, :k_eff] + b.lo[:, None, None]
        idx = torch.where(vals >= 1e38, -1, idx)
        # Integer gathers of the real pairs: no device-to-host sync.
        qi = b.q_idx.reshape(-1).index_select(0, b.sel)
        si = b.slot_idx.reshape(-1).index_select(0, b.sel)
        pool_s[qi, si, :k_eff] = vals.reshape(n_b * g, k_eff).index_select(0, b.sel)
        pool_r[qi, si, :k_eff] = idx.reshape(n_b * g, k_eff).index_select(0, b.sel)
    return pool_s.reshape(nq, nprobe * k), pool_r.reshape(nq, nprobe * k)


def shard_split(shards, num_shards: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Group a batch by shard id in one pass (``bincount`` + stable
    ``argsort``).  Returns ``(order, offsets)``: ``order[offsets[s] :
    offsets[s + 1]]`` are the row indices of shard ``s`` in arrival order."""
    shards = torch.as_tensor(shards, dtype=torch.int64)
    counts = torch.bincount(shards, minlength=num_shards)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return torch.argsort(shards, stable=True), offsets


def normalized_similarity(scores, metric: str = "l2") -> torch.Tensor:
    """Raw metric scores -> a shared higher-is-better (0, 1] scale: L2
    ``1/(1+d)`` (d clipped at 0), cosine ``(1+s)/2``, IP ``1/(1+exp(-s))``;
    float32, as the reference."""
    s = scores.to(torch.float32)
    if metric == "l2":
        return 1.0 / (1.0 + torch.clamp_min(s, 0.0))
    if metric == "cosine":
        return (1.0 + s) / 2.0
    return 1.0 / (1.0 + torch.exp(-s))


def hybrid_fuse(
    scores_list, pks_list, k: int, metrics, weights=None, kind: str = "weighted",
    rrf_k: float = 60.0,
):
    """Fuse per-field global result lists ([nq, m_f] best-first, pk < 0 =
    empty) into the hybrid top-k: ``weighted`` sums weight-scaled
    :func:`normalized_similarity`, ``rrf`` sums ``w_f / (rrf_k + rank)``
    (1-based).  Sums are float64 per (row, pk) in field order, the ranking
    is a stable sort of the descending sums.  Returns (fused [nq, k]
    float32 descending, pks [nq, k]); slots past the distinct candidates
    carry (-inf, -1)."""
    n_fields = len(scores_list)
    if n_fields == 0:
        raise ValueError("hybrid_fuse needs at least one field result")
    if weights is None:
        weights = [1.0] * n_fields
    if isinstance(metrics, str):
        metrics = [metrics] * n_fields
    if kind not in ("weighted", "rrf"):
        raise ValueError(f"unknown fusion kind '{kind}'")
    dev = scores_list[0].device
    nq = scores_list[0].shape[0]
    contribs = []
    for f in range(n_fields):
        s = scores_list[f].to(torch.float32)
        live = (pks_list[f] >= 0) & torch.isfinite(s)
        if kind == "rrf":
            ranks = torch.arange(1, s.shape[1] + 1, dtype=torch.float64, device=dev)
            c = (float(weights[f]) / (float(rrf_k) + ranks))[None, :].expand(s.shape)
        else:
            c = float(weights[f]) * normalized_similarity(s, metrics[f]).to(torch.float64)
        contribs.append(torch.where(live, c, 0.0))
    P = torch.cat([p.to(torch.int64) for p in pks_list], 1)
    C = torch.cat(contribs, 1)
    m = P.shape[1]
    if nq == 0 or m == 0:
        return (
            torch.full((nq, k), float("-inf"), dtype=torch.float32, device=dev),
            torch.full((nq, k), -1, dtype=torch.int64, device=dev),
        )
    live = (P >= 0).reshape(-1)
    stride = max(int(P.max()) + 1, 1)
    rows = torch.arange(nq, dtype=torch.int64, device=dev)[:, None]
    key = (rows * stride + torch.where(P >= 0, P, 0)).reshape(-1)
    fused = torch.full((nq * m,), float("-inf"), dtype=torch.float64, device=dev)
    pos = torch.nonzero(live).squeeze(1)
    if pos.numel():
        uniq, inv = torch.unique(key[pos], return_inverse=True)
        sums = torch.zeros(len(uniq), dtype=torch.float64, device=dev)
        sums.index_add_(0, inv, C.reshape(-1)[pos])
        # Each candidate's sum lands on its first slot; duplicates stay -inf.
        first = torch.full((len(uniq),), torch.iinfo(torch.int64).max, device=dev)
        first.scatter_reduce_(0, inv, pos, "amin")
        fused[first] = sums
    fused = fused.reshape(nq, m)
    order = torch.argsort(-fused, dim=1, stable=True)[:, :k]
    out_s = torch.gather(fused, 1, order)
    out_p = torch.where(torch.isfinite(out_s), torch.gather(P, 1, order), -1)
    pad = k - out_s.shape[1]
    if pad > 0:
        out_s = torch.cat([out_s, out_s.new_full((nq, pad), float("-inf"))], 1)
        out_p = torch.cat([out_p, out_p.new_full((nq, pad), -1)], 1)
    return out_s.to(torch.float32), out_p
