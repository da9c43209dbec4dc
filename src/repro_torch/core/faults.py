"""Deterministic fault injection at the infrastructure boundaries (§6.3);
a copy of ``repro.core.faults`` (host Python, no device state).

A seeded ``FaultInjector`` holds step-addressable fault rules, and thin
``Faulty*`` wrappers at the object-store / meta-store / log-broker
boundaries (plus the node entry points in ``ManuSystem.pump``) consult it on
every call.  Fault kinds:

- ``transient``     — raise the matching ``Transient*Error`` (absorbed by the
                      retry plane in ``core/retry.py``)
- ``latency``       — inject a delay spike (ManualClock advance or real sleep)
- ``duplicate``     — re-deliver already-consumed log entries on ``read`` (an
                      at-least-once broker), exercising LSN-keyed dedup
- ``cas_conflict``  — make ``MetaStore.cas`` lose the race without applying
- ``crash``         — raise ``Crash``, which ``ManuSystem.pump`` converts into
                      a node kill; recovery is then a ``restart_*`` call

Every injected fault is recorded in the ``EventLog`` / ``MetricsRegistry``.
Rules draw from ``random.Random(seed)``, as the reference's do: the same
seed and workload give the same faults in both packages.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from .object_store import ObjectStore
from .retry import (
    TransientLogError,
    TransientMetaError,
    TransientStoreError,
)


class Crash(BaseException):
    """Simulated process kill.

    Deliberately a ``BaseException`` (like ``KeyboardInterrupt``): a real
    ``kill -9`` runs no ``except Exception`` cleanup, so claim releases and
    rollback paths must NOT fire — recovery has to cope with the leaked
    state instead.  Only ``ManuSystem.pump`` (and tests) catch it, turning
    it into a node death."""

    def __init__(self, site: str, step: int, key: str = ""):
        super().__init__(f"injected crash at {site} step {step} key={key!r}")
        self.site = site
        self.step = step
        self.key = key


KINDS = ("transient", "latency", "duplicate", "cas_conflict", "crash")


@dataclass
class FaultRule:
    """One fault to inject; matched by call site + optional key substring."""

    site: str  # "" matches every site (for global-op addressing)
    kind: str
    match: str = ""  # substring of the key/channel, "" matches all
    prob: float = 0.0  # probabilistic firing (seeded)
    at_steps: frozenset[int] = frozenset()  # 1-based indices of *matching* calls
    at_ops: frozenset[int] = frozenset()  # 1-based global op indices
    max_fires: int | None = None  # total budget, None = unbounded
    burst: int = 2  # max consecutive fires (keeps retries convergent)
    delay_ms: float = 5.0  # for kind="latency"
    rewind: int = 2  # for kind="duplicate": entries re-delivered
    seen: int = 0  # matching invocations so far
    fires: int = 0
    _consec: int = 0

    def matches(self, site: str, key: str) -> bool:
        if self.site and self.site != site:
            return False
        return self.match in key


class FaultInjector:
    """Seeded, step-addressable fault plans, consulted by the Faulty* wrappers."""

    def __init__(self, seed: int = 0, *, metrics=None, event_log=None, clock=None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        self.metrics = metrics
        self.event_log = event_log
        self.clock = clock  # ManualClock -> latency advances it; else real sleep
        self.armed = True
        self.ops = 0  # global invocation counter across all sites

    # -- wiring (ManuSystem attaches its telemetry after construction) -----
    def bind(self, *, metrics=None, event_log=None, clock=None) -> "FaultInjector":
        if metrics is not None:
            self.metrics = metrics
        if event_log is not None:
            self.event_log = event_log
        if clock is not None:
            self.clock = clock
        return self

    # -- rule construction -------------------------------------------------
    def add(self, rule: FaultRule) -> FaultRule:
        if rule.kind not in KINDS:
            raise ValueError(f"unknown fault kind {rule.kind!r}")
        self.rules.append(rule)
        return rule

    def transient(self, site: str, prob: float, *, match: str = "",
                  burst: int = 2, max_fires: int | None = None) -> FaultRule:
        return self.add(FaultRule(site, "transient", match=match, prob=prob,
                                  burst=burst, max_fires=max_fires))

    def latency(self, site: str, prob: float, *, delay_ms: float = 5.0,
                match: str = "", max_fires: int | None = None) -> FaultRule:
        return self.add(FaultRule(site, "latency", match=match, prob=prob,
                                  delay_ms=delay_ms, max_fires=max_fires))

    def duplicates(self, prob: float, *, match: str = "", rewind: int = 2,
                   max_fires: int | None = None) -> FaultRule:
        return self.add(FaultRule("log.read", "duplicate", match=match, prob=prob,
                                  rewind=rewind, max_fires=max_fires))

    def cas_conflicts(self, prob: float, *, match: str = "", burst: int = 2,
                      max_fires: int | None = None) -> FaultRule:
        return self.add(FaultRule("meta.cas", "cas_conflict", match=match,
                                  prob=prob, burst=burst, max_fires=max_fires))

    def crash_at(self, site: str, step: int, *, match: str = "") -> FaultRule:
        return self.add(FaultRule(site, "crash", match=match,
                                  at_steps=frozenset({step}), max_fires=1,
                                  burst=1))

    def crash_at_op(self, op: int) -> FaultRule:
        """Crash at the N-th faultable operation anywhere in the system."""
        return self.add(FaultRule("", "crash", at_ops=frozenset({op}),
                                  max_fires=1, burst=1))

    def disarm(self) -> None:
        """Stop injecting (e.g. after the recovery phase of a chaos test)."""
        self.armed = False

    def arm(self) -> None:
        self.armed = True

    # -- the hot path --------------------------------------------------------
    def check(self, site: str, key: str = "") -> FaultRule | None:
        """Called by wrappers on every operation; returns the firing rule."""
        self.ops += 1
        if not self.armed or not self.rules:
            return None
        fired: FaultRule | None = None
        for rule in self.rules:
            if not rule.matches(site, key):
                continue
            rule.seen += 1
            if fired is not None:
                continue  # still count `seen` on later rules, fire first only
            if rule.max_fires is not None and rule.fires >= rule.max_fires:
                rule._consec = 0
                continue
            hit = (
                rule.seen in rule.at_steps
                or self.ops in rule.at_ops
                or (rule.prob > 0.0 and self.rng.random() < rule.prob)
            )
            if hit and rule._consec >= rule.burst:
                hit = False  # bounded consecutive fires: let retries converge
            if not hit:
                rule._consec = 0
                continue
            rule.fires += 1
            rule._consec += 1
            fired = rule
        if fired is not None:
            self._record(fired, site, key)
        return fired

    def _record(self, rule: FaultRule, site: str, key: str) -> None:
        if self.metrics is not None:
            self.metrics.inc("faults_injected_total",
                             labels={"site": site, "kind": rule.kind})
        if self.event_log is not None:
            self.event_log.emit("fault_injected", source="faults", site=site,
                                fault_kind=rule.kind, key=key, step=rule.seen,
                                op=self.ops)

    # -- fault realizations shared by the wrappers ---------------------------
    def sleep_ms(self, ms: float) -> None:
        if self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(ms)
        else:
            time.sleep(ms / 1e3)

    def apply(self, rule: FaultRule | None, site: str, key: str,
              error: type[Exception]) -> None:
        """Standard realization: latency sleeps, transient raises, crash kills."""
        if rule is None:
            return
        if rule.kind == "latency":
            self.sleep_ms(rule.delay_ms)
        elif rule.kind == "transient":
            raise error(f"injected transient at {site} key={key!r}")
        elif rule.kind == "crash":
            raise Crash(site, rule.seen, key)
        # duplicate / cas_conflict are realized by the specific wrapper


# --------------------------------------------------------------------------
# Boundary wrappers
# --------------------------------------------------------------------------


class FaultyObjectStore(ObjectStore):
    """Injects faults in front of any ``ObjectStore``."""

    def __init__(self, inner: ObjectStore, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def _gate(self, op: str, key: str) -> None:
        site = f"object_store.{op}"
        rule = self.injector.check(site, key)
        self.injector.apply(rule, site, key, TransientStoreError)

    def put(self, key: str, data: bytes):
        self._gate("put", key)
        return self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        self._gate("get", key)
        return self.inner.get(key)

    def exists(self, key: str) -> bool:
        self._gate("exists", key)
        return self.inner.exists(key)

    def delete(self, key: str) -> bool:
        self._gate("delete", key)
        return self.inner.delete(key)

    def list(self, prefix: str = ""):
        self._gate("list", prefix)
        return self.inner.list(prefix)

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class FaultyMetaStore:
    """Injects faults (incl. CAS conflict storms) in front of ``MetaStore``."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def _gate(self, op: str, key: str) -> FaultRule | None:
        site = f"meta.{op}"
        rule = self.injector.check(site, key)
        self.injector.apply(rule, site, key, TransientMetaError)
        return rule

    def put(self, key, value, lease_id=None):
        self._gate("put", key)
        return self.inner.put(key, value, lease_id=lease_id)

    def get(self, key, default=None):
        self._gate("get", key)
        return self.inner.get(key, default)

    def get_rev(self, key):
        self._gate("get_rev", key)
        return self.inner.get_rev(key)

    def delete(self, key):
        self._gate("delete", key)
        return self.inner.delete(key)

    def cas(self, key, expected_rev, value):
        rule = self._gate("cas", key)
        if rule is not None and rule.kind == "cas_conflict":
            return False  # lost the race; nothing applied
        return self.inner.cas(key, expected_rev, value)

    def scan(self, prefix):
        self._gate("scan", prefix)
        return self.inner.scan(prefix)

    def __getattr__(self, name: str):
        return getattr(self.inner, name)


class FaultyLogBroker:
    """Injects faults in front of ``LogBroker``; ``duplicate`` rules turn
    ``read`` into an at-least-once delivery (entries below ``from_position``
    are re-delivered), which is exactly what Kafka/Pulsar consumers must
    tolerate and what the subscribers' LSN-keyed dedup absorbs."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def publish(self, channel, entry):
        site = "log.publish"
        rule = self.injector.check(site, channel)
        self.injector.apply(rule, site, channel, TransientLogError)
        return self.inner.publish(channel, entry)

    def read(self, channel, from_position, max_entries=None):
        site = "log.read"
        rule = self.injector.check(site, channel)
        self.injector.apply(rule, site, channel, TransientLogError)
        if rule is not None and rule.kind == "duplicate" and from_position > 0:
            start = max(0, from_position - rule.rewind)
            return self.inner.read(channel, start, max_entries)
        return self.inner.read(channel, from_position, max_entries)

    def __getattr__(self, name: str):
        return getattr(self.inner, name)
