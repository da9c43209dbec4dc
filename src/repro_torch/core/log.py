"""The log backbone (paper §3.3); a copy of ``repro.core.log`` (host
Python and numpy: WAL payloads stay host arrays, and each subscriber copies
a payload to its device once, on consume).

Manu structures the entire system as log publish/subscribe services: the
WAL is the incremental part, the binlog the base part.  We reproduce the
WAL side here as a multi-channel broker with:

* durable, append-only channels (Kafka/Pulsar stand-in),
* positional subscription (``subscribe(from_position)``) and ``seek`` —
  required for failure recovery and time travel replay,
* **time-ticks**: special control entries inserted periodically into every
  channel signalling event-time progress (the watermark mechanism behind
  delta consistency),
* logical (not physical) log entries: each entry records an *event*
  (insert/delete/ddl/coordination), so different subscribers consume the
  same log in different ways (data node → binlog, query node → in-memory
  growing segment, ...).

Channel layout (paper: "multiple logical channels ... to prevent different
types of requests from interfering"):

* ``ddl``                    — data-definition requests
* ``coord``                  — system-coordination messages
* ``dml/<collection>/<shard>`` — data-manipulation requests, hashed by PK
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterator

import numpy as np


class EntryType(Enum):
    INSERT = "insert"
    DELETE = "delete"
    # One atomic record carrying a delete-by-pk half AND an insert half:
    # MVCC visibility of the old and new row versions flips at the record's
    # single LSN (the paper's row-level ACID upsert idiom).
    UPSERT = "upsert"
    DDL = "ddl"
    COORD = "coord"
    TIME_TICK = "time_tick"


@dataclass(frozen=True)
class LogEntry:
    """One logical log record.

    ``ts`` is the HLC timestamp (LSN) assigned by the TSO at publish time.
    ``payload`` is a dict for control entries; INSERT entries carry numpy
    arrays in ``payload`` (rows: pks, vectors, labels, numerics).
    """

    ts: int
    type: EntryType
    payload: dict[str, Any]
    channel: str = ""
    position: int = -1  # offset within the channel, set by the broker


@dataclass
class _Channel:
    name: str
    entries: list[LogEntry] = field(default_factory=list)
    last_tick_ts: int = 0
    bytes_published: int = 0


def _entry_nbytes(entry: LogEntry) -> int:
    total = 64
    for v in entry.payload.values():
        if isinstance(v, np.ndarray):
            total += v.nbytes
        elif isinstance(v, (bytes, str)):
            total += len(v)
        else:
            total += 16
    return total


class LogBroker:
    """In-process multi-channel durable log (Kafka/Pulsar stand-in).

    The API mirrors what Manu needs from a cloud message queue: create
    channels, append (publish), read from an offset, and truncate below a
    retention point.  All reads are positional so any subscriber can
    replay independently — the property the whole architecture leans on.
    """

    def __init__(self) -> None:
        self._channels: dict[str, _Channel] = {}
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)

    # --------------------------------------------------------------- admin
    def create_channel(self, name: str) -> None:
        with self._lock:
            if name not in self._channels:
                self._channels[name] = _Channel(name)

    def has_channel(self, name: str) -> bool:
        with self._lock:
            return name in self._channels

    def channels(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(c for c in self._channels if c.startswith(prefix))

    def drop_channel(self, name: str) -> None:
        with self._lock:
            self._channels.pop(name, None)

    # ------------------------------------------------------------- publish
    def publish(self, channel: str, entry: LogEntry) -> int:
        with self._cv:
            ch = self._channels.get(channel)
            if ch is None:
                raise KeyError(f"unknown channel: {channel}")
            if ch.entries and entry.ts < ch.entries[-1].ts:
                raise ValueError(
                    f"out-of-order publish on {channel}: "
                    f"{entry.ts} < {ch.entries[-1].ts}"
                )
            position = len(ch.entries)
            stamped = LogEntry(
                ts=entry.ts,
                type=entry.type,
                payload=entry.payload,
                channel=channel,
                position=position,
            )
            ch.entries.append(stamped)
            ch.bytes_published += _entry_nbytes(stamped)
            if entry.type is EntryType.TIME_TICK:
                ch.last_tick_ts = entry.ts
            self._cv.notify_all()
            return position

    # ------------------------------------------------------------ consume
    def read(self, channel: str, from_position: int, max_entries: int | None = None) -> list[LogEntry]:
        with self._lock:
            ch = self._channels.get(channel)
            if ch is None:
                raise KeyError(f"unknown channel: {channel}")
            end = len(ch.entries)
            if max_entries is not None:
                end = min(end, from_position + max_entries)
            return ch.entries[from_position:end]

    def end_position(self, channel: str) -> int:
        with self._lock:
            return len(self._channels[channel].entries)

    def last_tick(self, channel: str) -> int:
        with self._lock:
            return self._channels[channel].last_tick_ts

    def stats(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {
                name: {
                    "entries": len(ch.entries),
                    "bytes": ch.bytes_published,
                    "last_tick": ch.last_tick_ts,
                }
                for name, ch in self._channels.items()
            }

    def wait_for_tick(self, channel: str, min_ts: int, timeout_s: float | None = None) -> bool:
        """Block until the channel's last time-tick >= min_ts."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._channels[channel].last_tick_ts >= min_ts, timeout=timeout_s
            )

    def entries_between(self, channel: str, ts_lo: int, ts_hi: int) -> Iterator[LogEntry]:
        """Entries with ts in (ts_lo, ts_hi], skipping time-ticks (replay API)."""
        for e in self.read(channel, 0):
            if ts_lo < e.ts <= ts_hi and e.type is not EntryType.TIME_TICK:
                yield e

    # ----------------------------------------------------------- retention
    def truncate_before(self, channel: str, ts: int) -> int:
        """Drop entries with timestamp < ts (log expiration, paper §4.3).
        As in the reference, the kept entries' positions are not rebased."""
        with self._lock:
            ch = self._channels[channel]
            keep_from = next(
                (i for i, e in enumerate(ch.entries) if e.ts >= ts), len(ch.entries)
            )
            ch.entries = ch.entries[keep_from:]
            return keep_from


class Subscription:
    """A positional cursor over one channel.

    Subscribers pull entries and track their own progress — the broker holds
    no per-subscriber state (exactly the Kafka consumer model).  ``seek``
    supports failure recovery: a new node resumes from a checkpointed
    position.
    """

    def __init__(self, broker: LogBroker, channel: str, from_position: int = 0):
        self.broker = broker
        self.channel = channel
        self.position = from_position
        self.last_tick_seen = 0

    def poll(self, max_entries: int | None = None) -> list[LogEntry]:
        entries = self.broker.read(self.channel, self.position, max_entries)
        if entries:
            self.position = entries[-1].position + 1
            for e in entries:
                if e.type is EntryType.TIME_TICK:
                    self.last_tick_seen = max(self.last_tick_seen, e.ts)
        return entries

    def seek(self, position: int) -> None:
        self.position = position

    def lag(self) -> int:
        return self.broker.end_position(self.channel) - self.position


# --------------------------------------------------------------------------
# Channel naming helpers
# --------------------------------------------------------------------------

DDL_CHANNEL = "ddl"
COORD_CHANNEL = "coord"


def dml_channel(collection: str, shard: int) -> str:
    return f"dml/{collection}/{shard}"


def shard_of_channel(channel: str) -> int:
    """Inverse of :func:`dml_channel`: the shard a DML channel carries."""
    return int(channel.rsplit("/", 1)[1])


_HASH_MASK = 0x7FFFFFFF


def shard_of_pk(pk: int | str, num_shards: int) -> int:
    """Consistent hash of a primary key onto a shard (paper Fig. 4).

    String keys hash their unicode codepoints through a Horner polynomial —
    the scalar twin of the vectorized :func:`shards_of_pks`, which the write
    pipeline uses to split whole batches without per-row Python loops."""
    if isinstance(pk, str):
        h = 0
        for c in pk:
            h = (h * 131 + ord(c)) & _HASH_MASK
        return h % num_shards
    return int(pk) % num_shards


def shards_of_pks(pks: np.ndarray, num_shards: int) -> np.ndarray:
    """Vectorized :func:`shard_of_pk` over a whole pk batch.

    Integer keys are one modulo; string keys view the fixed-width unicode
    buffer as a [n, width] codepoint matrix and run the Horner hash one
    *column* at a time (loop over max string length, not over rows),
    skipping NUL padding so short and long keys agree with the scalar hash.
    """
    pks = np.asarray(pks)
    if pks.size == 0:
        return np.empty(0, np.int64)
    if pks.dtype.kind in "iu":
        return (pks.astype(np.int64) % num_shards).astype(np.int64)
    codes = (
        np.ascontiguousarray(pks.astype(np.str_))
        .view(np.uint32)
        .reshape(len(pks), -1)
        .astype(np.int64)
    )
    h = np.zeros(len(pks), np.int64)
    for col in range(codes.shape[1]):
        c = codes[:, col]
        h = np.where(c > 0, (h * 131 + c) & _HASH_MASK, h)
    return h % num_shards
