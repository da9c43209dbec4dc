"""etcd-like metadata store (a copy of ``repro.core.meta_store``: pure
Python, no device state).

The coordinators keep system status and collection metadata in a
highly-available transactional KV (etcd in the paper).  We reproduce the
etcd feature subset Manu relies on:

* versioned get/put/delete with a global revision counter,
* compare-and-swap (the primitive behind etcd transactions),
* prefix scans,
* watches (callbacks on key/prefix changes) — used to synchronize
  coordinator caches,
* leases with TTL — used for worker liveness (a node that stops renewing
  its lease is declared dead and its work reassigned).

Values are JSON-serializable dicts; we store deep copies to avoid aliasing.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from .timestamp import Clock


@dataclass
class KV:
    value: Any
    create_rev: int
    mod_rev: int


@dataclass
class Lease:
    lease_id: int
    ttl_ms: int
    expires_at_ms: int
    keys: set[str] = field(default_factory=set)


WatchFn = Callable[[str, Any | None], None]  # (key, new_value|None-on-delete)


class MetaStore:
    def __init__(self, clock: Clock | None = None):
        self._kv: dict[str, KV] = {}
        self._rev = 0
        self._lock = threading.RLock()
        self._watches: list[tuple[str, WatchFn]] = []
        self._leases: dict[int, Lease] = {}
        self._next_lease = 1
        self._clock = clock or Clock()

    # ------------------------------------------------------------------ kv
    def put(self, key: str, value: Any, lease_id: int | None = None) -> int:
        with self._lock:
            self._rev += 1
            prev = self._kv.get(key)
            self._kv[key] = KV(
                value=copy.deepcopy(value),
                create_rev=prev.create_rev if prev else self._rev,
                mod_rev=self._rev,
            )
            if lease_id is not None:
                lease = self._leases.get(lease_id)
                if lease is None:
                    raise KeyError(f"unknown lease {lease_id}")
                lease.keys.add(key)
            rev = self._rev
        self._notify(key, value)
        return rev

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            self._expire_leases()
            kv = self._kv.get(key)
            return copy.deepcopy(kv.value) if kv else default

    def get_rev(self, key: str) -> int | None:
        with self._lock:
            kv = self._kv.get(key)
            return kv.mod_rev if kv else None

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = key in self._kv
            if existed:
                self._rev += 1
                del self._kv[key]
        if existed:
            self._notify(key, None)
        return existed

    def cas(self, key: str, expected_rev: int | None, value: Any) -> bool:
        """Compare-and-swap on mod revision (None = key must not exist)."""
        with self._lock:
            kv = self._kv.get(key)
            current = kv.mod_rev if kv else None
            if current != expected_rev:
                return False
            self._rev += 1
            self._kv[key] = KV(
                value=copy.deepcopy(value),
                create_rev=kv.create_rev if kv else self._rev,
                mod_rev=self._rev,
            )
        self._notify(key, value)
        return True

    def scan(self, prefix: str) -> dict[str, Any]:
        with self._lock:
            self._expire_leases()
            return {
                k: copy.deepcopy(v.value)
                for k, v in sorted(self._kv.items())
                if k.startswith(prefix)
            }

    def revision(self) -> int:
        with self._lock:
            return self._rev

    # -------------------------------------------------------------- watches
    def watch(self, prefix: str, fn: WatchFn) -> Callable[[], None]:
        entry = (prefix, fn)
        with self._lock:
            self._watches.append(entry)

        def cancel() -> None:
            with self._lock:
                try:
                    self._watches.remove(entry)
                except ValueError:
                    pass

        return cancel

    def _notify(self, key: str, value: Any | None) -> None:
        with self._lock:
            targets = [fn for prefix, fn in self._watches if key.startswith(prefix)]
        for fn in targets:
            fn(key, copy.deepcopy(value))

    # --------------------------------------------------------------- leases
    def grant_lease(self, ttl_ms: int) -> int:
        with self._lock:
            lease_id = self._next_lease
            self._next_lease += 1
            self._leases[lease_id] = Lease(
                lease_id=lease_id,
                ttl_ms=ttl_ms,
                expires_at_ms=self._clock.now_ms() + ttl_ms,
            )
            return lease_id

    def keepalive(self, lease_id: int) -> bool:
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None:
                return False
            lease.expires_at_ms = self._clock.now_ms() + lease.ttl_ms
            return True

    def revoke_lease(self, lease_id: int) -> None:
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            keys = list(lease.keys) if lease else []
        for key in keys:
            self.delete(key)

    def _expire_leases(self) -> None:
        # Caller holds the lock.
        now = self._clock.now_ms()
        expired = [l for l in self._leases.values() if l.expires_at_ms <= now]
        for lease in expired:
            del self._leases[lease.lease_id]
        # Delete outside lock is unsafe here; inline minimal delete + defer notify.
        doomed: list[str] = []
        for lease in expired:
            for key in lease.keys:
                if key in self._kv:
                    self._rev += 1
                    del self._kv[key]
                    doomed.append(key)
        if doomed:
            # Fire watches after mutation; best-effort ordering.
            threading.Thread(
                target=lambda: [self._notify(k, None) for k in doomed], daemon=True
            ).start()

    def segment_map(self) -> "SegmentMap":
        return SegmentMap(self)

    def expire_now(self) -> list[str]:
        """Force lease expiry sweep (deterministic variant for tests)."""
        with self._lock:
            now = self._clock.now_ms()
            expired = [l for l in self._leases.values() if l.expires_at_ms <= now]
            doomed: list[str] = []
            for lease in expired:
                del self._leases[lease.lease_id]
                for key in lease.keys:
                    if key in self._kv:
                        self._rev += 1
                        del self._kv[key]
                        doomed.append(key)
        for k in doomed:
            self._notify(k, None)
        return doomed


# ---------------------------------------------------------------------------
# Versioned segment mapping
# ---------------------------------------------------------------------------

SEGMENT_MAP_HISTORY = 16


class SegmentMap:
    """Versioned segment-mapping epochs, stored under ``segment_map/<coll>``.

    The value is the authoritative answer to "which sealed segments make up
    this collection right now":

        {"epoch": E, "live": [segment ids], "updated_ts": HLC,
         "history": [{"epoch", "ts", "added", "removed"}, ...]}

    Every seal and every compaction swap bumps the epoch through a CAS, so
    concurrent coordinators serialize on the revision and an epoch number
    uniquely identifies one mapping.  Query nodes are *driven* by coord-
    channel messages (load/retire), but recovery and audit read this map:
    a query pinned at ``ts`` corresponds to the newest epoch with
    ``updated_ts <= ts``.
    """

    def __init__(self, meta: MetaStore):
        self.meta = meta

    def key(self, collection: str) -> str:
        return f"segment_map/{collection}"

    def get(self, collection: str) -> dict:
        return self.meta.get(self.key(collection)) or {
            "epoch": 0,
            "live": [],
            "updated_ts": 0,
            "history": [],
        }

    def epoch(self, collection: str) -> int:
        return int(self.get(collection)["epoch"])

    def live(self, collection: str) -> list[int]:
        return list(self.get(collection)["live"])

    def apply(self, collection: str, add=(), remove=(), ts: int = 0) -> dict:
        """CAS-bump the epoch, adding/removing segment ids atomically."""
        key = self.key(collection)
        while True:
            rev = self.meta.get_rev(key)
            cur = self.get(collection)
            live = (set(cur["live"]) - set(remove)) | set(add)
            entry = {
                "epoch": cur["epoch"] + 1,
                "ts": ts,
                "added": sorted(add),
                "removed": sorted(remove),
            }
            new = {
                "epoch": cur["epoch"] + 1,
                "live": sorted(live),
                "updated_ts": ts,
                "history": (cur.get("history") or [])[-(SEGMENT_MAP_HISTORY - 1):]
                + [entry],
            }
            if self.meta.cas(key, rev, new):
                return new
