"""Typed retry/timeout/backoff plane (paper §6.3); a copy of
``repro.core.retry`` (host Python, no device state).

The exception taxonomy separates *retryable* infrastructure faults from
fatal ones, ``RetryPolicy`` is a seeded jittered exponential backoff with an
attempt budget, and the ``Retrying*`` wrappers put it in front of the object
store, the meta store and the log broker.  The fault injector raises exactly
these types; anything else (an injected ``Crash`` included) propagates: a
retry loop never eats a process kill or a logic error.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable

from .object_store import ObjectStore

# --------------------------------------------------------------------------
# Exception taxonomy
# --------------------------------------------------------------------------


class TransientError(RuntimeError):
    """Base class for retryable infrastructure faults."""


class TransientStoreError(TransientError):
    """Object-store put/get/delete/list failed transiently (S3 5xx, timeout)."""


class TransientMetaError(TransientError):
    """Meta-store RPC failed transiently (etcd unavailable, leader election)."""


class TransientLogError(TransientError):
    """Log-broker publish/read failed transiently (broker rebalance, timeout)."""


class RetryExhaustedError(RuntimeError):
    """The attempt budget ran out; carries the last transient error."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"retry budget exhausted at {site} after {attempts} attempts: {last!r}"
        )
        self.site = site
        self.attempts = attempts
        self.last = last


# --------------------------------------------------------------------------
# Policy
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with a bounded attempt budget.

    Deterministic: jitter comes from a ``random.Random(seed)`` owned by the
    caller (each wrapper keeps its own), so a seeded chaos run replays
    bit-for-bit.  ``sleep`` is pluggable — cooperative (ManualClock) systems
    pass ``None`` and backoff is accounting-only, threaded systems pass
    ``time.sleep``.
    """

    max_attempts: int = 6
    base_delay_ms: float = 1.0
    multiplier: float = 2.0
    max_delay_ms: float = 64.0
    jitter: float = 0.5  # +/- fraction of the computed delay
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    def delay_ms(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(
            self.base_delay_ms * (self.multiplier ** (attempt - 1)),
            self.max_delay_ms,
        )
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(raw, 0.0)


class _Retrier:
    """Shared engine for the retrying wrappers below."""

    def __init__(
        self,
        policy: RetryPolicy,
        *,
        metrics=None,
        event_log=None,
        sleep: Callable[[float], None] | None = None,
        retry_on: tuple[type, ...] = (TransientError,),
    ):
        self.policy = policy
        self.metrics = metrics
        self.event_log = event_log
        self.sleep = sleep
        self.retry_on = retry_on
        self.rng = random.Random(policy.seed)

    def run(self, site: str, fn: Callable[[], Any]) -> Any:
        last: BaseException | None = None
        for attempt in range(1, self.policy.max_attempts + 1):
            try:
                out = fn()
                if attempt > 1:
                    if self.metrics is not None:
                        self.metrics.inc(
                            "retry_recovered_total", labels={"site": site}
                        )
                return out
            except self.retry_on as exc:  # fatal types propagate untouched
                last = exc
                if self.metrics is not None:
                    self.metrics.inc("retry_attempts_total", labels={"site": site})
                if attempt == self.policy.max_attempts:
                    break
                delay = self.policy.delay_ms(attempt, self.rng)
                if self.sleep is not None and delay > 0:
                    self.sleep(delay / 1e3)
        if self.metrics is not None:
            self.metrics.inc("retry_exhausted_total", labels={"site": site})
        if self.event_log is not None:
            self.event_log.emit(
                "retry_exhausted",
                source="retry",
                site=site,
                attempts=self.policy.max_attempts,
                error=repr(last),
            )
        raise RetryExhaustedError(site, self.policy.max_attempts, last)


# --------------------------------------------------------------------------
# Retrying wrappers
# --------------------------------------------------------------------------


class RetryingObjectStore(ObjectStore):
    """Wraps any ``ObjectStore`` with the retry policy.

    Composed *outside* a ``FaultyObjectStore`` so retries absorb injected
    transients: ``RetryingObjectStore(FaultyObjectStore(real, inj), policy)``.
    Unknown attributes (``put_count`` etc.) delegate to the inner store.
    """

    def __init__(
        self,
        inner: ObjectStore,
        policy: RetryPolicy | None = None,
        *,
        metrics=None,
        event_log=None,
        sleep: Callable[[float], None] | None = None,
    ):
        self.inner = inner
        self._retrier = _Retrier(
            policy or RetryPolicy(), metrics=metrics, event_log=event_log, sleep=sleep
        )

    # -- retried I/O ------------------------------------------------------
    def put(self, key: str, data: bytes):
        return self._retrier.run("object_store.put", lambda: self.inner.put(key, data))

    def get(self, key: str) -> bytes:
        return self._retrier.run("object_store.get", lambda: self.inner.get(key))

    def exists(self, key: str) -> bool:
        return self._retrier.run("object_store.exists", lambda: self.inner.exists(key))

    def delete(self, key: str) -> bool:
        return self._retrier.run("object_store.delete", lambda: self.inner.delete(key))

    def list(self, prefix: str = ""):
        # materialized so transient errors surface inside the retry scope
        return self._retrier.run(
            "object_store.list", lambda: list(self.inner.list(prefix))
        )

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class RetryingMetaStore:
    """Duck-typed retrying wrapper over ``MetaStore``.

    Only genuine RPC transients are retried; a ``cas`` that returns ``False``
    is a *semantic* conflict (someone else won the race) and flows back to the
    caller's CAS loop untouched.
    """

    def __init__(
        self,
        inner,
        policy: RetryPolicy | None = None,
        *,
        metrics=None,
        event_log=None,
        sleep: Callable[[float], None] | None = None,
    ):
        self.inner = inner
        self._retrier = _Retrier(
            policy or RetryPolicy(), metrics=metrics, event_log=event_log, sleep=sleep
        )

    def put(self, key, value, lease_id=None):
        return self._retrier.run(
            "meta.put", lambda: self.inner.put(key, value, lease_id=lease_id)
        )

    def get(self, key, default=None):
        return self._retrier.run("meta.get", lambda: self.inner.get(key, default))

    def get_rev(self, key):
        return self._retrier.run("meta.get_rev", lambda: self.inner.get_rev(key))

    def delete(self, key):
        return self._retrier.run("meta.delete", lambda: self.inner.delete(key))

    def cas(self, key, expected_rev, value):
        return self._retrier.run(
            "meta.cas", lambda: self.inner.cas(key, expected_rev, value)
        )

    def scan(self, prefix):
        return self._retrier.run("meta.scan", lambda: self.inner.scan(prefix))

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class RetryingLogBroker:
    """Duck-typed retrying wrapper over ``LogBroker``.

    Covers every publisher and subscriber in one place (coordinators, nodes,
    ``Subscription`` cursors all go through the broker handle).  Retrying a
    publish is safe here because an injected transient raises *before* the
    inner append lands — a failed attempt never half-publishes; real brokers
    get the same property from idempotent producers.
    """

    def __init__(
        self,
        inner,
        policy: RetryPolicy | None = None,
        *,
        metrics=None,
        event_log=None,
        sleep: Callable[[float], None] | None = None,
    ):
        self.inner = inner
        self._retrier = _Retrier(
            policy or RetryPolicy(), metrics=metrics, event_log=event_log, sleep=sleep
        )

    def publish(self, channel, entry):
        return self._retrier.run(
            "log.publish", lambda: self.inner.publish(channel, entry)
        )

    def read(self, channel, from_position, max_entries=None):
        return self._retrier.run(
            "log.read", lambda: self.inner.read(channel, from_position, max_entries)
        )

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


def default_sleep(threaded: bool) -> Callable[[float], None] | None:
    """Backoff sleeper: real sleep in threaded mode, accounting-only otherwise."""
    return time.sleep if threaded else None
