"""S3-like object store abstraction.

Manu persists binlogs, sealed segments, and index files in object storage
(S3 / MinIO / local FS).  We expose the minimal S3 verb surface —
put/get/list/delete/exists with ETags — behind one interface, with two
implementations:

* ``MemoryObjectStore`` — in-process dict.
* ``FileObjectStore``   — directory-backed; objects are files under a root,
  keys map to paths, and a put commits atomically (``os.replace``).

Values are opaque ``bytes``.  Higher layers (binlog, index files, train
checkpoints) serialize with numpy ``.npz`` / msgpack-like headers on top.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True)
class ObjectMeta:
    key: str
    size: int
    etag: str


class ObjectStore:
    """Abstract S3-like store."""

    def put(self, key: str, data: bytes) -> ObjectMeta:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        """Remove ``key``; True iff an object was actually deleted.

        Implementations keep reclamation counters (``delete_count``,
        ``bytes_deleted``) covering only *real* removals, so GC benches and
        tests can assert reclaimed bytes.
        """
        raise NotImplementedError

    def list(self, prefix: str = "") -> Iterator[ObjectMeta]:
        raise NotImplementedError

    # -- convenience -------------------------------------------------------
    def get_or_none(self, key: str) -> bytes | None:
        return self.get(key) if self.exists(key) else None

    def copy(self, src: str, dst: str) -> ObjectMeta:
        return self.put(dst, self.get(src))


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class MemoryObjectStore(ObjectStore):
    """Objects in a dict.  Each object's ETag is computed once, at ``put``,
    and kept beside it, as S3 keeps it: ``list`` does not hash the stored
    bytes again (a checkpoint's objects run to gigabytes)."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._etags: dict[str, str] = {}
        self._lock = threading.RLock()
        self.put_count = 0
        self.get_count = 0
        self.delete_count = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.bytes_deleted = 0

    def put(self, key: str, data: bytes) -> ObjectMeta:
        if not isinstance(data, (bytes, bytearray)):
            raise TypeError(f"object value must be bytes, got {type(data)}")
        data = bytes(data)
        etag = _etag(data)
        with self._lock:
            self._objects[key] = data
            self._etags[key] = etag
            self.put_count += 1
            self.bytes_written += len(data)
            return ObjectMeta(key, len(data), etag)

    def get(self, key: str) -> bytes:
        with self._lock:
            if key not in self._objects:
                raise KeyError(f"object not found: {key}")
            data = self._objects[key]
            self.get_count += 1
            self.bytes_read += len(data)
            return data

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def delete(self, key: str) -> bool:
        with self._lock:
            data = self._objects.pop(key, None)
            if data is None:
                return False
            del self._etags[key]
            self.delete_count += 1
            self.bytes_deleted += len(data)
            return True

    def list(self, prefix: str = "") -> Iterator[ObjectMeta]:
        with self._lock:
            keys = sorted(k for k in self._objects if k.startswith(prefix))
            metas = [ObjectMeta(k, len(self._objects[k]), self._etags[k]) for k in keys]
        yield from metas


class FileObjectStore(ObjectStore):
    """Objects as files under ``root``.  Keys may contain '/'."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.RLock()
        self._tmp_seq = 0
        self.put_count = 0
        self.get_count = 0
        self.delete_count = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.bytes_deleted = 0

    def _path(self, key: str) -> str:
        if ".." in key.split("/"):
            raise ValueError(f"illegal key: {key}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> ObjectMeta:
        path = self._path(key)
        with self._lock:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # A private staging file per put: a kill mid-write strands at
            # most this file (list/get skip it), never a torn object, and
            # os.replace is the atomic commit point, like an S3 PUT.
            self._tmp_seq += 1
            tmp = f"{path}.{os.getpid()}.{self._tmp_seq}.tmp"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
            self.put_count += 1
            self.bytes_written += len(data)
        return ObjectMeta(key, len(data), _etag(data))

    def get(self, key: str) -> bytes:
        path = self._path(key)
        if not os.path.isfile(path):
            raise KeyError(f"object not found: {key}")
        with open(path, "rb") as f:
            data = f.read()
        with self._lock:
            self.get_count += 1
            self.bytes_read += len(data)
        return data

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def delete(self, key: str) -> bool:
        path = self._path(key)
        with self._lock:
            if not os.path.isfile(path):
                return False
            size = os.path.getsize(path)
            os.remove(path)
            self.delete_count += 1
            self.bytes_deleted += size
            return True

    def list(self, prefix: str = "") -> Iterator[ObjectMeta]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                if fn.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(ObjectMeta(key, os.path.getsize(full), ""))
        yield from sorted(out, key=lambda m: m.key)
