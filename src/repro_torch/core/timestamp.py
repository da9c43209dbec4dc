"""Hybrid logical clock (HLC) timestamps and the central TSO.

Manu assigns every state-changing request a logical sequence number (LSN)
drawn from a central time service oracle (TSO).  Each timestamp is a hybrid
logical clock value: a physical component tracking wall time (milliseconds)
and a logical component disambiguating events within one physical tick.

The packed representation is a single int64:

    ts = (physical_ms << LOGICAL_BITS) | logical

which is totally ordered, cheap to compare, and directly usable as an MVCC
version.  ``physical_of(ts)`` recovers wall-clock milliseconds so users can
express staleness tolerances (the paper's "grace time" tau) in physical
units.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

LOGICAL_BITS = 18
LOGICAL_MASK = (1 << LOGICAL_BITS) - 1
MAX_LOGICAL = LOGICAL_MASK

#: Sentinel: "no staleness bound" (eventual consistency).
INFINITE_STALENESS = float("inf")


def pack(physical_ms: int, logical: int) -> int:
    if logical > MAX_LOGICAL:
        raise ValueError(f"logical component {logical} overflows {LOGICAL_BITS} bits")
    return (int(physical_ms) << LOGICAL_BITS) | int(logical)


def physical_of(ts: int) -> int:
    """Wall-clock milliseconds encoded in ``ts``."""
    return ts >> LOGICAL_BITS


def logical_of(ts: int) -> int:
    return ts & LOGICAL_MASK


def delta_ms(ts_a: int, ts_b: int) -> float:
    """Physical-time difference ``ts_a - ts_b`` in milliseconds."""
    return float(physical_of(ts_a) - physical_of(ts_b))


def add_ms(ts: int, ms: float) -> int:
    """Timestamp ``ms`` milliseconds after ``ts`` (logical reset to 0)."""
    return pack(physical_of(ts) + int(ms), 0)


@dataclass(frozen=True)
class Timestamp:
    """Unpacked view of an HLC timestamp (for debugging / display)."""

    physical_ms: int
    logical: int

    @classmethod
    def unpack(cls, ts: int) -> "Timestamp":
        return cls(physical_of(ts), logical_of(ts))

    def packed(self) -> int:
        return pack(self.physical_ms, self.logical)

    def __repr__(self) -> str:
        return f"HLC({self.physical_ms}ms+{self.logical})"


class Clock:
    """Wall clock abstraction; swap in ``ManualClock`` for deterministic tests."""

    def now_ms(self) -> int:
        return time.time_ns() // 1_000_000


class ManualClock(Clock):
    """A clock advanced explicitly — used by tests and simulations."""

    def __init__(self, start_ms: int = 0):
        self._now = int(start_ms)
        self._lock = threading.Lock()

    def now_ms(self) -> int:
        with self._lock:
            return self._now

    def advance(self, ms: int) -> int:
        with self._lock:
            self._now += int(ms)
            return self._now

    def set(self, ms: int) -> None:
        with self._lock:
            if ms < self._now:
                raise ValueError("manual clock cannot move backwards")
            self._now = int(ms)


class TSO:
    """Central timestamp oracle.

    Issues strictly increasing HLC timestamps.  Physical component never runs
    behind the wall clock; the logical component increments when multiple
    timestamps are issued within one millisecond.  This is the single
    source of event ordering for the whole system (paper §3.4).
    """

    def __init__(self, clock: Clock | None = None):
        self.clock = clock or Clock()
        self._last_physical = 0
        self._last_logical = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            now = self.clock.now_ms()
            if now > self._last_physical:
                self._last_physical = now
                self._last_logical = 0
            else:
                self._last_logical += 1
                if self._last_logical > MAX_LOGICAL:
                    # Logical overflow within one ms: push physical forward.
                    self._last_physical += 1
                    self._last_logical = 0
            return pack(self._last_physical, self._last_logical)

    def next_batch(self, n: int) -> list[int]:
        return [self.next() for _ in range(n)]

    def advance_to(self, ts: int) -> None:
        """Floor the oracle at ``ts``: every subsequently issued timestamp is
        strictly greater.  Crash recovery seeds a fresh TSO from the largest
        timestamp found in the durable log so ordering survives a restart
        even under a frozen manual clock."""
        with self._lock:
            p, l = physical_of(ts), logical_of(ts)
            if (p, l) > (self._last_physical, self._last_logical):
                self._last_physical = p
                self._last_logical = l

    def last_issued(self) -> int:
        with self._lock:
            return pack(self._last_physical, self._last_logical)
