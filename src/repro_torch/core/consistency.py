"""Delta consistency (paper §3.4).

A query carries its issue timestamp ``L_r`` (assigned by the TSO) and a
user staleness tolerance ``tau`` in physical milliseconds.  A subscriber
whose consumed watermark is ``L_s`` may execute the query iff

    physical(L_r) - physical(L_s) < tau        (equivalently L_s > L_r - tau)

otherwise it must wait for the next time-tick.  tau = 0 gives strong
consistency (wait for *all* data up to the query's issue time), tau = inf
gives eventual consistency (never wait).

``ConsistencyLevel`` provides the named presets Manu exposes to users.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .timestamp import INFINITE_STALENESS, delta_ms


class ConsistencyLevel(Enum):
    STRONG = "strong"
    BOUNDED = "bounded"
    EVENTUAL = "eventual"
    SESSION = "session"  # read-your-writes: wait for the caller's last write ts


def staleness_ms_of(level: ConsistencyLevel, bounded_ms: float = 2_000.0) -> float:
    if level is ConsistencyLevel.STRONG:
        return 0.0
    if level is ConsistencyLevel.BOUNDED:
        return bounded_ms
    return INFINITE_STALENESS


@dataclass(frozen=True)
class GuaranteeTs:
    """What a query must wait for before executing."""

    query_ts: int  # L_r
    staleness_ms: float  # tau
    session_ts: int = 0  # for session consistency: caller's last write LSN

    def satisfied_by(self, watermark_ts: int) -> bool:
        if self.session_ts and watermark_ts < self.session_ts:
            return False
        if self.staleness_ms == INFINITE_STALENESS:
            return True
        return delta_ms(self.query_ts, watermark_ts) < self.staleness_ms or (
            watermark_ts >= self.query_ts
        )

    def wait_target_ts(self) -> int:
        """The minimal watermark that satisfies this guarantee."""
        import math

        from .timestamp import pack, physical_of

        if self.staleness_ms == INFINITE_STALENESS:
            return self.session_ts
        if self.staleness_ms <= 0:
            # strong: wm >= query_ts is the (only) satisfying condition
            return max(self.query_ts, self.session_ts)
        # smallest integer physical ms with (q_phys - p) < tau; wm >= query_ts
        # always satisfies too, so the minimal target is the min of the two
        phys_min = math.floor(physical_of(self.query_ts) - self.staleness_ms) + 1
        target = min(pack(max(phys_min, 0), 0), self.query_ts)
        return max(target, self.session_ts)
