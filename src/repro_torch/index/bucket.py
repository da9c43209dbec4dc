"""Bucketed hierarchical-k-means index, the paper's SSD design (§4.4)
(mirrors ``repro.index.bucket``).

Hierarchical k-means packs the vectors into buckets of at most
``BUCKET_ROW_QUANTUM`` rows; ``replicas`` independent clusterings put each
row into that many buckets (the paper's multi-assignment).  The bucket
centres, the slot -> row map and the (SQ-compressed) payload live on the
index's device.

Search:

1. **probe** -- the ``l2_topk`` kernel over the centres, ``nprobe_buckets``
   per query, read back once;
2. **scan** -- per query, ONE segmented scan over its probed buckets' slot
   slices (the ``sq_l2_topk`` kernel on codes, ``l2_topk`` uncompressed).
   Each block equals that (query, bucket) pair's own scan, as in the
   reference's per-bucket loop;
3. **dedup** -- the reference keeps each multi-assigned row's best
   occurrence with a stable sort and a host ``seen`` set.  That is
   ``merge_topk``'s contract with row ids as pks (dedup, ties by pool
   column, empties as (fill, -1)), so one ``merge_topk`` over the
   [nq, nprobe * k_b] pool built in probe order gives the same answer.
"""

from __future__ import annotations

import numpy as np
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
from .kmeans import _as_rows, balanced_kmeans

#: Rows per bucket quantum (the reference's "4 KB page" analogue).
BUCKET_ROW_QUANTUM = 128


class BucketIndex(VectorIndex):
    KIND = "bucket"

    def __init__(
        self,
        metric: Metric = Metric.L2,
        target_bucket_rows: int = 96,
        replicas: int = 2,
        nprobe_buckets: int = 8,
        compress: bool = True,
        device="cuda",
        **params,
    ):
        super().__init__(
            metric,
            device=device,
            target_bucket_rows=target_bucket_rows,
            replicas=replicas,
            nprobe_buckets=nprobe_buckets,
            compress=compress,
            **params,
        )
        self.target_bucket_rows = target_bucket_rows
        self.replicas = replicas
        self.nprobe_buckets = nprobe_buckets
        self.compress = compress
        self.centers: torch.Tensor | None = None  # [B, d] on the device
        self.bucket_offsets: torch.Tensor | None = None  # [B+1] int64, host
        self.bucket_rows: torch.Tensor | None = None  # [n_slots] slot -> original row
        self.storage: torch.Tensor | None = None  # f32 [n_slots, d] or uint8 SQ codes
        self.vmin: torch.Tensor | None = None
        self.vmax: torch.Tensor | None = None

    def build(self, vectors) -> None:
        x = normalize_if_cosine(self.metric, _as_rows(vectors, self.device))
        n, d = x.shape
        self.num_rows = n
        if n == 0:
            self.centers = torch.zeros((0, d), dtype=torch.float32, device=self.device)
            self.bucket_offsets = torch.zeros(1, dtype=torch.int64)
            self.bucket_rows = torch.zeros(0, dtype=torch.int64, device=self.device)
            self.storage = torch.zeros((0, d), dtype=torch.float32, device=self.device)
            return
        centers, slot_rows, counts = [], [], []
        max_rows = BUCKET_ROW_QUANTUM
        for rep in range(self.replicas):
            c, assign = balanced_kmeans(
                x,
                target_cluster_size=min(self.target_bucket_rows, max_rows),
                max_cluster_size=max_rows,
                seed=1000 + rep,
            )
            # Every row lands in one non-empty bucket; a stable sort by
            # bucket lists each bucket's rows in ascending order.
            centers.append(c)
            slot_rows.append(torch.sort(assign, stable=True).indices)
            counts.append(torch.bincount(assign, minlength=len(c)).cpu())
        self.centers = torch.cat(centers).to(torch.float32).contiguous()
        self.bucket_offsets = torch.cat(
            [torch.zeros(1, dtype=torch.int64), torch.cumsum(torch.cat(counts), 0)]
        )
        self.bucket_rows = torch.cat(slot_rows).to(torch.int64)
        payload = x[self.bucket_rows].contiguous()
        if self.compress:
            self.vmin, self.vmax = payload.min(dim=0).values, payload.max(dim=0).values
            self.storage = ops.sq_encode(payload, self.vmin, self.vmax)
        else:
            self.storage = payload

    def _scan_buckets(self, q, segs, k, valids):
        if self.compress:
            return ops.sq_topk_scan_segmented(
                q, segs, self.vmin, self.vmax, k, metric=scan_metric(self.metric), valids=valids
            )
        return ops.topk_scan_segmented(q, segs, k, metric=scan_metric(self.metric), valids=valids)

    def search(self, queries, k, valid=None):
        q = normalize_if_cosine(self.metric, _as_rows(queries, self.device))
        nq = len(q)
        if self.num_rows == 0 or len(self.centers) == 0:
            return (
                torch.full((nq, k), worst_score(self.metric), dtype=torch.float32,
                           device=self.device),
                torch.full((nq, k), -1, dtype=torch.int64, device=self.device),
            )
        nprobe = min(int(self.params.get("nprobe_buckets", self.nprobe_buckets)),
                     len(self.centers))
        _cs, probes = ops.topk_scan(q, self.centers, nprobe, metric=scan_metric(self.metric))
        valid_slots = None if valid is None else valid.to(self.device)[self.bucket_rows]
        offsets = self.bucket_offsets.tolist()
        # The reference scans each bucket at k_b = min(k, its rows); one k
        # for every block, no smaller than any bucket's k_b, pads the same
        # candidates with empties.
        k_seg = min(k, int((self.bucket_offsets[1:] - self.bucket_offsets[:-1]).max()))
        pool_s, pool_i = [], []
        for r, row in enumerate(probes.cpu().tolist()):
            bounds = [(offsets[b], offsets[b + 1]) if b >= 0 else (0, 0) for b in row]
            segs = [self.storage[lo:hi] for lo, hi in bounds]
            vs = None if valid_slots is None else [valid_slots[lo:hi] for lo, hi in bounds]
            s, i = self._scan_buckets(q[r : r + 1], segs, k_seg, vs)
            pool_s.append(s)
            pool_i.append(i)
        pool_s, pool_i = torch.cat(pool_s), torch.cat(pool_i)
        lo = self.bucket_offsets.to(self.device)[probes.clamp(min=0)]
        slots = (pool_i + lo.repeat_interleave(k_seg, dim=1)).clamp(0, len(self.bucket_rows) - 1)
        ids = torch.where(pool_i >= 0, self.bucket_rows[slots], -1)
        return ops.merge_topk(pool_s, ids, k, metric=scan_metric(self.metric))

    def _state(self):
        state = {
            "centers": host_array(self.centers),
            "bucket_offsets": host_array(self.bucket_offsets).astype(np.int64),
            "bucket_rows": host_array(self.bucket_rows).astype(np.int64),
            "storage": host_array(self.storage),
            "compress": np.int64(1 if self.compress else 0),
        }
        if self.compress:
            state["vmin"] = host_array(self.vmin)
            state["vmax"] = host_array(self.vmax)
        return state

    def _load_state(self, state):
        self.compress = bool(int(state["compress"]))
        self.centers = device_tensor(state["centers"], self.device, torch.float32)
        self.bucket_offsets = device_tensor(state["bucket_offsets"], "cpu", torch.int64)
        self.bucket_rows = device_tensor(state["bucket_rows"], self.device, torch.int64)
        self.storage = device_tensor(
            state["storage"], self.device, torch.uint8 if self.compress else torch.float32
        )
        if self.compress:
            self.vmin = device_tensor(state["vmin"], self.device, torch.float32)
            self.vmax = device_tensor(state["vmax"], self.device, torch.float32)
        self.num_rows = int(self.bucket_rows.max()) + 1 if len(self.bucket_rows) else 0
