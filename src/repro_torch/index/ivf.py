"""Inverted-file indexes: IVF-FLAT, IVF-SQ and IVF-PQ (mirrors
``repro.index.ivf``).

Vectors are grouped into ``nlist`` k-means clusters (``kmeans_assign``
kernel); a query scans only the ``nprobe`` most promising lists.  Lists are
stored contiguously in list order (CSR), on the index's device.

Search is the reference's batched pipeline:

1. **probe** -- the ``l2_topk`` kernel over the centroids; ``search_batched``
   probes every index of a group in one segmented launch and reads the
   probes back once;
2. **invert + gather-scan** -- ``ops.ivf_probe_schedule`` inverts the probe
   matrix into a (list -> query group) schedule bucketed by padded size,
   and ``ops.ivf_gather_topk`` runs one batched product per bucket
   (``torch.bmm``; the reference's numpy products sit outside any kernel)
   and pools the per-probe-slot top-k.  IVF-FLAT and IVF-SQ accumulate the
   product (and IVF-SQ its ``q . vmin`` constant) in float64 and round each
   score once to float32: a float32 dot product of 768 terms at row norms
   near 1e3 drifts by up to ~3e-3, past ``testing.SCORE_TOL`` (see
   PERF.md);
3. **reduce** -- ``search`` merges the pool with the ``merge_topk`` kernel;
   ``search_batched`` returns the raw pools, so the query node merges once.

``_search_reference`` keeps the per-list loop (scans through the FLAT, SQ
and PQ kernels) as the equivalence oracle.  IVF-PQ encodes residuals
(x - centroid).
"""

from __future__ import annotations

import torch

from ..core.collection import Metric
from ..kernels import ops
from .base import (
    VectorIndex,
    device_tensor,
    host_array,
    normalize_if_cosine,
    scan_metric,
    worst_score,
)
from .kmeans import _as_rows, kmeans
from .pq import _device_codes, adc_tables, pq_encode, train_pq_codebooks

_CHUNK = 65_536  # rows per pass of the lazily cached per-row biases


def _round_scores(s: torch.Tensor, bias) -> torch.Tensor:
    """A float64 bucket product plus its per-row bias, rounded once to
    float32 (the pool's type)."""
    if bias is not None:
        s += bias[:, None, :]
    return s.to(torch.float32)


class IVFBase(VectorIndex):
    def __init__(self, metric: Metric = Metric.L2, nlist: int = 64, nprobe: int = 8,
                 device="cuda", **params):
        super().__init__(metric, device=device, nlist=nlist, nprobe=nprobe, **params)
        self.nlist = nlist
        self.nprobe = nprobe
        self.centroids: torch.Tensor | None = None  # [nlist, d] on the device
        self.list_offsets: torch.Tensor | None = None  # [nlist+1] int64, host
        self.row_ids: torch.Tensor | None = None  # [n] list order -> original row

    def _partition(self, x: torch.Tensor) -> torch.Tensor:
        """Cluster and build the CSR layout; returns x permuted to list
        order (a stable sort by assignment)."""
        self.centroids, assign = kmeans(x, min(self.nlist, max(1, len(x))), seed=0)
        self.nlist = len(self.centroids)
        order = torch.sort(assign, stable=True).indices
        counts = torch.bincount(assign, minlength=self.nlist).cpu()
        self.list_offsets = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
        self.row_ids = order
        return x[order].contiguous()

    def _effective_nprobe(self) -> int:
        return int(self.params.get("nprobe", self.nprobe))

    def _probe_lists(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """[nq, nprobe] most promising list ids per query (-1 = padded)."""
        nprobe = min(nprobe, self.nlist)
        _vals, idx = ops.topk_scan(q, self.centroids, nprobe, metric=scan_metric(self.metric))
        return idx

    def _queries(self, queries) -> torch.Tensor:
        return normalize_if_cosine(self.metric, _as_rows(queries, self.device))

    def _valid_perm(self, valid):
        return None if valid is None else valid.to(self.device)[self.row_ids]

    # ------------------------------------------------- batched scan pipeline
    def _bucket_scorer(self, q: torch.Tensor, valid_perm, sched):
        """``(score_fn, q_offset)``: ``score_fn(bucket) -> [B, G, W]``
        min-semantics scores with dead slots at +inf, and an optional
        per-query constant ``q_offset [nq]`` added to the pooled candidates
        afterwards (it changes no per-query ranking)."""
        raise NotImplementedError

    def _row_bias(self, b: ops.IVFBucket, valid_perm, base=None):
        """Per-row additive bias [B, W]: ``base`` values (or zero) with +inf
        on padding and invisible rows; None when there is nothing to add."""
        dead = None if b.full else ~b.wmask
        if valid_perm is not None:
            bad = ~valid_perm[b.rows]
            dead = bad if dead is None else (dead | bad)
        if base is None:
            if dead is None:
                return None
            bias = torch.zeros(b.rows.shape, dtype=torch.float32, device=self.device)
        else:
            bias = base[b.rows]
        if dead is not None:
            bias = bias.masked_fill(dead, float("inf"))
        return bias

    def _pool_candidates(self, q: torch.Tensor, k: int, valid_perm, probes: torch.Tensor):
        """Bucketed gather-scan of the probed lists; returns the candidate
        pool ``(scores [nq, nprobe*k], ids [nq, nprobe*k])`` in the metric's
        natural scale with original row ids (-1 = empty slot)."""
        sched = ops.ivf_probe_schedule(probes, self.list_offsets, device=self.device)
        score_fn, q_offset = self._bucket_scorer(q, valid_perm, sched)
        pool_s, pool_rows = ops.ivf_gather_topk(sched, k, score_fn, self.device)
        if q_offset is not None:
            pool_s = pool_s + q_offset[:, None]  # fills stay +inf
        ids = torch.where(
            pool_rows >= 0, self.row_ids[pool_rows.clamp(0, len(self.row_ids) - 1)], -1
        )
        if self.metric is not Metric.L2:  # back to descending similarity
            pool_s = torch.where(ids >= 0, -pool_s, float("-inf"))
        return pool_s, ids

    def search(self, queries, k, valid=None):
        q = self._queries(queries)
        probes = self._probe_lists(q, self._effective_nprobe()).cpu()
        pool_s, ids = self._pool_candidates(q, k, self._valid_perm(valid), probes)
        return ops.merge_topk(pool_s, ids, k, metric=scan_metric(self.metric))

    @classmethod
    def search_batched(cls, indexes, queries, k: int, valids=None):
        """All co-located IVF units of one spec: shared query prep, every
        unit's centroid probe in ONE segmented scan launch and one read-back,
        then per-unit gather-scans; raw candidate pools, unreduced."""
        if not indexes:
            return super().search_batched(indexes, queries, k, valids)
        if valids is None:
            valids = [None] * len(indexes)
        head = indexes[0]
        q = head._queries(queries).contiguous()
        widths = [min(ix._effective_nprobe(), ix.nlist) for ix in indexes]
        kp = max(widths)
        _vals, probes = ops.topk_scan_segmented(
            q, [ix.centroids for ix in indexes], kp, metric=scan_metric(head.metric)
        )
        probes = probes.cpu()
        ss, ii, splits = [], [], [0]
        for u, (ix, v) in enumerate(zip(indexes, valids)):
            s, i = ix._pool_candidates(q, k, ix._valid_perm(v), probes[:, u * kp : u * kp + widths[u]])
            ss.append(s)
            ii.append(i)
            splits.append(splits[-1] + s.shape[1])
        return torch.cat(ss, 1), torch.cat(ii, 1), splits

    # ------------------------------------------------- scalar reference path
    def _scan_range(self, q, lo: int, hi: int, k: int, valid_perm):
        """Top-k of one list (rows ``lo:hi`` of the permuted storage)."""
        raise NotImplementedError

    def _list_queries(self, q: torch.Tensor, lst: int) -> torch.Tensor:
        """The queries as one list's scan takes them."""
        return q

    def _search_reference(self, queries, k, valid=None):
        """The per-list loop, kept as the equivalence oracle for the batched
        pipeline: each probed list is scanned once against the queries that
        probe it, then every query's pool is merged."""
        q = self._queries(queries)
        nq = len(q)
        probes = self._probe_lists(q, self._effective_nprobe())
        valid_perm = self._valid_perm(valid)
        metric = scan_metric(self.metric)
        pools: list[list[tuple[torch.Tensor, torch.Tensor]]] = [[] for _ in range(nq)]
        offsets = self.list_offsets.tolist()
        for lst in torch.unique(probes).tolist():
            if lst < 0:
                continue
            qmask = (probes == lst).any(dim=1)
            lo, hi = offsets[lst], offsets[lst + 1]
            if hi <= lo or not bool(qmask.any()):
                continue
            rows = torch.nonzero(qmask).squeeze(1)
            s, i = self._scan_range(
                self._list_queries(q[rows], lst), lo, hi, min(k, hi - lo), valid_perm
            )
            gi = torch.where(i >= 0, self.row_ids[(i + lo).clamp(0, len(self.row_ids) - 1)], -1)
            for r_local, r in enumerate(rows.tolist()):
                pools[r].append((s[r_local], gi[r_local]))
        width = max([sum(len(s) for s, _ in p) for p in pools] + [1])
        pool_s = torch.full((nq, width), worst_score(self.metric), device=self.device)
        pool_p = torch.full((nq, width), -1, dtype=torch.int64, device=self.device)
        for r, p in enumerate(pools):
            if p:
                s = torch.cat([s for s, _ in p])
                pool_s[r, : len(s)] = s
                pool_p[r, : len(s)] = torch.cat([i for _, i in p])
        return ops.merge_topk(pool_s, pool_p, k, metric=metric)

    def _base_state(self) -> dict:
        return {
            "centroids": host_array(self.centroids),
            "list_offsets": host_array(self.list_offsets).astype("int64"),
            "row_ids": host_array(self.row_ids).astype("int64"),
        }

    def _load_base_state(self, state) -> None:
        self.centroids = device_tensor(state["centroids"], self.device, torch.float32)
        self.list_offsets = device_tensor(state["list_offsets"], "cpu", torch.int64)
        self.row_ids = device_tensor(state["row_ids"], self.device, torch.int64)
        self.nlist = len(self.centroids)


class IVFFlatIndex(IVFBase):
    KIND = "ivf_flat"

    def __init__(self, metric: Metric = Metric.L2, nlist: int = 64, nprobe: int = 8,
                 device="cuda", **params):
        super().__init__(metric, nlist=nlist, nprobe=nprobe, device=device, **params)
        self.storage: torch.Tensor | None = None  # permuted vectors
        self._row_norms: torch.Tensor | None = None  # lazy, not serialized

    def build(self, vectors) -> None:
        x = normalize_if_cosine(self.metric, _as_rows(vectors, self.device))
        self.storage = self._partition(x)
        self._row_norms = None
        self.num_rows = len(x)

    def _bucket_scorer(self, q, valid_perm, sched):
        # L2 = qn - 2 q.x + rn: the -2 folds into the query operand, rn
        # (cached per row) joins the masking bias, qn is deferred.
        l2 = self.metric is Metric.L2
        if l2 and self._row_norms is None:
            self._row_norms = (self.storage * self.storage).sum(1)
        qs = (-2.0 * q if l2 else -q).double()
        base = self._row_norms if l2 else None

        def score(b: ops.IVFBucket) -> torch.Tensor:
            tile = self.storage[b.rows].double()  # [B, W, d]
            s = torch.bmm(qs[b.q_idx], tile.transpose(1, 2))  # [B, G, W]
            return _round_scores(s, self._row_bias(b, valid_perm, base))

        return score, ((q * q).sum(1) if l2 else None)

    def _scan_range(self, q, lo, hi, k, valid_perm):
        v = None if valid_perm is None else valid_perm[lo:hi]
        return ops.topk_scan(q, self.storage[lo:hi], k, metric=scan_metric(self.metric), valid=v)

    def _state(self):
        return {**self._base_state(), "storage": host_array(self.storage)}

    def _load_state(self, state):
        self._load_base_state(state)
        self.storage = device_tensor(state["storage"], self.device, torch.float32)
        self._row_norms = None
        self.num_rows = len(self.storage)


class IVFSQIndex(IVFBase):
    KIND = "ivf_sq"

    def __init__(self, metric: Metric = Metric.L2, nlist: int = 64, nprobe: int = 8,
                 device="cuda", **params):
        super().__init__(metric, nlist=nlist, nprobe=nprobe, device=device, **params)
        self.codes: torch.Tensor | None = None  # [n, d] uint8, list order
        self.vmin: torch.Tensor | None = None
        self.vmax: torch.Tensor | None = None
        self._row_norms: torch.Tensor | None = None  # decoded-row norms, lazy

    def build(self, vectors) -> None:
        x = normalize_if_cosine(self.metric, _as_rows(vectors, self.device))
        xp = self._partition(x)
        self.vmin, self.vmax = xp.min(dim=0).values, xp.max(dim=0).values
        self.codes = ops.sq_encode(xp, self.vmin, self.vmax)
        self._row_norms = None
        self.num_rows = len(x)

    def _decoded_norms(self) -> torch.Tensor:
        """||decode(code)||^2 per row, computed once (chunked decode)."""
        if self._row_norms is None:
            out = torch.empty(len(self.codes), dtype=torch.float32, device=self.device)
            for lo in range(0, len(self.codes), _CHUNK):
                y = ops.sq_decode(self.codes[lo : lo + _CHUNK], self.vmin, self.vmax)
                out[lo : lo + _CHUNK] = (y * y).sum(1)
            self._row_norms = out
        return self._row_norms

    def _bucket_scorer(self, q, valid_perm, sched):
        # Fused dequantization: with y = code*scale + vmin, q.y runs on the
        # cast codes with the scale folded into the query operand and q.vmin
        # into the deferred per-query constant.
        scale = ops.sq_scale(self.vmin, self.vmax).double()
        l2 = self.metric is Metric.L2
        q64 = q.double()
        qs = (-2.0 * q64 if l2 else -q64) * scale
        base = self._decoded_norms() if l2 else None

        def score(b: ops.IVFBucket) -> torch.Tensor:
            tile = self.codes[b.rows].to(torch.float64)  # [B, W, d]
            s = torch.bmm(qs[b.q_idx], tile.transpose(1, 2))
            return _round_scores(s, self._row_bias(b, valid_perm, base))

        qv = q64 @ self.vmin.double()
        return score, ((q64 * q64).sum(1) - 2.0 * qv if l2 else -qv).to(torch.float32)

    def _scan_range(self, q, lo, hi, k, valid_perm):
        v = None if valid_perm is None else valid_perm[lo:hi]
        return ops.sq_topk_scan(
            q, self.codes[lo:hi], self.vmin, self.vmax, k, metric=scan_metric(self.metric),
            valid=v,
        )

    def _state(self):
        return {
            **self._base_state(),
            "codes": host_array(self.codes),
            "vmin": host_array(self.vmin),
            "vmax": host_array(self.vmax),
        }

    def _load_state(self, state):
        self._load_base_state(state)
        self.codes = device_tensor(state["codes"], self.device, torch.uint8)
        self.vmin = device_tensor(state["vmin"], self.device, torch.float32)
        self.vmax = device_tensor(state["vmax"], self.device, torch.float32)
        self._row_norms = None
        self.num_rows = len(self.codes)


class IVFPQIndex(IVFBase):
    KIND = "ivf_pq"

    def __init__(self, metric: Metric = Metric.L2, nlist: int = 64, nprobe: int = 8,
                 m: int = 8, ksub: int = 256, device="cuda", **params):
        super().__init__(metric, nlist=nlist, nprobe=nprobe, m=m, ksub=ksub, device=device,
                         **params)
        self.m, self.ksub = m, ksub
        self.codebooks: torch.Tensor | None = None
        self.codes: torch.Tensor | None = None  # [n, m] uint8 (ksub <= 256) or int32
        self._perm_assign: torch.Tensor | None = None  # list id per permuted row
        self._scan_bias: torch.Tensor | None = None  # per-row scan bias, lazy
        self._cb_flat: torch.Tensor | None = None  # [m*ksub, dsub] flat codebook
        self._codes_off: torch.Tensor | None = None  # codes + j*ksub offsets

    def build(self, vectors) -> None:
        x = normalize_if_cosine(self.metric, _as_rows(vectors, self.device))
        xp = self._partition(x)
        counts = (self.list_offsets[1:] - self.list_offsets[:-1]).to(self.device)
        assign = torch.repeat_interleave(torch.arange(self.nlist, device=self.device), counts)
        residual = xp - self.centroids[assign]
        self.codebooks = train_pq_codebooks(residual, self.m, self.ksub)
        self.codes = _device_codes(pq_encode(residual, self.codebooks), self.ksub)
        self._perm_assign = assign.to(torch.int32)
        self._scan_bias = self._cb_flat = self._codes_off = None
        self.num_rows = len(x)

    def _decode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Residual reconstructions for a row-index tile [...] -> [..., d]:
        one gather from the flat codebook."""
        if self._codes_off is None:
            m, ksub, _dsub = self.codebooks.shape
            self._cb_flat = self.codebooks.reshape(m * ksub, -1).contiguous()
            self._codes_off = self.codes.to(torch.int64) + (
                torch.arange(m, device=self.device) * ksub
            )
        rec = self._cb_flat[self._codes_off[rows]]  # [..., m, dsub]
        return rec.reshape(tuple(rows.shape) + (-1,))

    def _ensure_scan_bias(self) -> torch.Tensor:
        """Per-row scan bias, computed once per loaded index (chunked).  For
        reconstruction r of a row in list l: L2 ||c_l + r||^2, IP c_l.r
        (see the reference for the identity)."""
        if self._scan_bias is None:
            cents = self.centroids[self._perm_assign.to(torch.int64)]
            out = torch.empty(len(self.codes), dtype=torch.float32, device=self.device)
            l2 = self.metric is Metric.L2
            for lo in range(0, len(self.codes), _CHUNK):
                hi = min(lo + _CHUNK, len(self.codes))
                rec = self._decode_rows(torch.arange(lo, hi, device=self.device))
                c = cents[lo:hi]
                if l2:
                    y = c + rec
                    out[lo:hi] = (y * y).sum(1)
                else:
                    out[lo:hi] = (c * rec).sum(1)
            self._scan_bias = out
        return self._scan_bias

    def _bucket_scorer(self, q, valid_perm, sched):
        # Batched residual ADC via the reconstruction identity: one product
        # per bucket over decoded code tiles, a per-row bias, and (L2) a
        # per-(query, list) constant -2 q.c_l.
        l2 = self.metric is Metric.L2
        base = self._ensure_scan_bias()
        qs = -2.0 * q if l2 else -q
        pair_const = None
        if l2:
            pc = self.centroids[sched.pair_list]
            pair_const = -2.0 * (q[sched.pair_q] * pc).sum(1)

        def score(b: ops.IVFBucket) -> torch.Tensor:
            rec = self._decode_rows(b.rows)  # [B, W, d]
            s = torch.bmm(qs[b.q_idx], rec.transpose(1, 2))
            if pair_const is not None:
                s += pair_const[b.pair_idx][:, :, None]
            bias = self._row_bias(b, valid_perm, base)
            if bias is not None:
                s += bias[:, None, :]
            return s

        return score, ((q * q).sum(1) if l2 else None)

    def _list_queries(self, q, lst):
        return q - self.centroids[lst][None, :]

    def _scan_range(self, q, lo, hi, k, valid_perm):
        # Residual ADC: q here is already shifted by the list's centroid.
        luts = adc_tables(q, self.codebooks, self.metric)
        v = None if valid_perm is None else valid_perm[lo:hi]
        s, i = ops.pq_adc_topk(luts, self.codes[lo:hi], k, valid=v)
        if self.metric is not Metric.L2:
            s = -s
        return s, i

    def _state(self):
        return {
            **self._base_state(),
            "codebooks": host_array(self.codebooks),
            "codes": host_array(self.codes).astype("int32"),
            "perm_assign": host_array(self._perm_assign).astype("int32"),
        }

    def _load_state(self, state):
        self._load_base_state(state)
        self.codebooks = device_tensor(state["codebooks"], self.device, torch.float32)
        self.m, self.ksub = self.codebooks.shape[0], self.codebooks.shape[1]
        self.codes = _device_codes(device_tensor(state["codes"], self.device), self.ksub)
        self._perm_assign = device_tensor(state["perm_assign"], self.device, torch.int32)
        self._scan_bias = self._cb_flat = self._codes_off = None
        self.num_rows = len(self.codes)
