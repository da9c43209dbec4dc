"""Time travel: checkpoint + WAL replay restore (paper §4.3); mirrors
``repro.core.time_travel``.

A checkpoint stores the collection's segment map (sealed segment ids and
the per-shard WAL replay positions), not data.  Restoring to time T loads
the closest checkpoint at or before T, loads its sealed segments from the
binlog onto ``device``, replays each shard's WAL from the checkpointed
position up to T into one reconstruction segment per shard, and lets MVCC
visibility at T do the rest.  ``RestoredCollection.search`` scans the
restored segments with ``ops.topk_scan`` (``l2_topk`` on the card) and
reduces with ``ops.merge_topk``.

``expire(before_ts)`` is the retention policy: drop WAL entries and
checkpoints older than the horizon.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .binlog import load_segment
from .log import EntryType, LogBroker, dml_channel
from .object_store import ObjectStore
from .segment import Segment
from .timestamp import physical_of


def _ckpt_key(collection: str, ts: int) -> str:
    return f"checkpoint/{collection}/{ts:020d}"


@dataclass
class Checkpoint:
    collection: str
    ts: int
    sealed_segment_ids: list[int]
    replay_positions: dict[str, int]  # channel -> position


class TimeTravel:
    def __init__(self, broker: LogBroker, store: ObjectStore):
        self.broker = broker
        self.store = store

    # ----------------------------------------------------------- checkpoint
    def checkpoint(
        self,
        collection: str,
        ts: int,
        sealed_segment_ids: list[int],
        num_shards: int,
        replay_positions: dict[str, int] | None = None,
    ) -> Checkpoint:
        if replay_positions is None:
            replay_positions = {dml_channel(collection, s): 0 for s in range(num_shards)}
        ckpt = Checkpoint(collection, ts, sorted(sealed_segment_ids), replay_positions)
        self.store.put(
            _ckpt_key(collection, ts),
            json.dumps(
                {
                    "collection": ckpt.collection,
                    "ts": ckpt.ts,
                    "sealed_segment_ids": ckpt.sealed_segment_ids,
                    "replay_positions": ckpt.replay_positions,
                }
            ).encode(),
        )
        return ckpt

    def checkpoints(self, collection: str) -> list[Checkpoint]:
        out = []
        for m in self.store.list(f"checkpoint/{collection}/"):
            d = json.loads(self.store.get(m.key).decode())
            out.append(
                Checkpoint(d["collection"], d["ts"], d["sealed_segment_ids"], d["replay_positions"])
            )
        return sorted(out, key=lambda c: c.ts)

    def closest_before(self, collection: str, target_ts: int) -> Checkpoint | None:
        best = None
        for c in self.checkpoints(collection):
            if c.ts <= target_ts:
                best = c
        return best

    # -------------------------------------------------------------- restore
    def restore(
        self, collection: str, target_ts: int, num_shards: int, dim: int, device="cuda"
    ) -> "RestoredCollection":
        device = resolve_device(device)
        ckpt = self.closest_before(collection, target_ts)
        segments: list[Segment] = []
        replay_from: dict[str, int] = {}
        if ckpt is not None:
            for sid in ckpt.sealed_segment_ids:
                segments.append(load_segment(self.store, collection, sid, device=device))
            replay_from = dict(ckpt.replay_positions)
        for shard in range(num_shards):
            replay_from.setdefault(dml_channel(collection, shard), 0)

        # Replay the WAL into one reconstruction segment per shard.
        recon: dict[int, Segment] = {}
        deletes: list[tuple[np.ndarray, int]] = []
        known_sealed = {s.segment_id for s in segments}
        for channel, pos in replay_from.items():
            shard = int(channel.rsplit("/", 1)[1])
            for entry in self.broker.read(channel, pos):
                if entry.ts > target_ts:
                    break
                if entry.type in (EntryType.INSERT, EntryType.UPSERT):
                    p = entry.payload
                    if entry.type is EntryType.UPSERT:
                        # The delete half applies even where the insert half
                        # is already materialized from a sealed binlog.
                        deletes.append((p["pk"], entry.ts))
                    if p["segment_id"] in known_sealed:
                        continue  # already materialized from binlog
                    seg = recon.get(shard)
                    if seg is None:
                        seg = Segment(-1000 - shard, collection, shard, dim, device=device)
                        recon[shard] = seg
                    n = len(p["pk"])
                    seg.append(p["pk"], p["vector"], np.full(n, entry.ts, np.int64))
                elif entry.type is EntryType.DELETE:
                    deletes.append((entry.payload["pk"], entry.ts))
        segments.extend(recon.values())
        for pks, ts in deletes:
            for seg in segments:
                seg.delete(pks, ts)
        return RestoredCollection(collection, target_ts, segments)

    # ------------------------------------------------------------ retention
    def expire(self, collection: str, before_ts: int, num_shards: int) -> int:
        dropped = 0
        for shard in range(num_shards):
            dropped += self.broker.truncate_before(dml_channel(collection, shard), before_ts)
        for c in self.checkpoints(collection):
            if c.ts < before_ts:
                self.store.delete(_ckpt_key(collection, c.ts))
        return dropped


class RestoredCollection:
    """A standalone, queryable snapshot of the collection at ``ts``."""

    def __init__(self, name: str, ts: int, segments: list[Segment]):
        self.name = name
        self.ts = ts
        self.segments = segments

    def num_rows(self) -> int:
        return int(sum(int(s.visible_mask(self.ts).sum()) for s in self.segments))

    def pks(self) -> torch.Tensor:
        parts = [s.pks()[s.visible_mask(self.ts)] for s in self.segments]
        if not parts:
            return torch.empty(0, dtype=torch.int64)
        return torch.sort(torch.cat([p.to(parts[0].device) for p in parts])).values

    def search(self, queries, k: int, metric_str: str = "l2"):
        """Top-k over the rows visible at ``ts``: one ``ops.topk_scan`` per
        restored segment, one ``ops.merge_topk`` over the pools.  Returns
        ``(scores [nq, k], pks [nq, k])`` tensors on the segments' device."""
        from ..kernels import ops

        dev = self.segments[0].device if self.segments else torch.device("cpu")
        q = queries if torch.is_tensor(queries) else torch.from_numpy(np.asarray(queries))
        q = q.to(dev, torch.float32).contiguous()
        pools_s, pools_p = [], []
        for seg in self.segments:
            mask = seg.visible_mask(self.ts)
            if not bool(mask.any()):
                continue
            s, i = ops.topk_scan(q, seg.vectors(), k, metric=metric_str, valid=mask)
            pks = seg.pks()
            pools_s.append(s)
            pools_p.append(torch.where(i >= 0, pks[i.clamp(0, len(pks) - 1)], -1))
        nq = len(q)
        if not pools_s:
            fill = float("inf") if metric_str == "l2" else float("-inf")
            return (
                torch.full((nq, k), fill, dtype=torch.float32, device=dev),
                torch.full((nq, k), -1, dtype=torch.int64, device=dev),
            )
        return ops.merge_topk(torch.cat(pools_s, 1), torch.cat(pools_p, 1), k, metric=metric_str)


def physical_time_of(ts: int) -> int:
    return physical_of(ts)
