"""Object-store abstraction: the durability + coordination substrate.

The reference coordinates independent writer processes through shared
object storage with optimistic-concurrency manifest commits (reference:
rust/lancedb/src/io/object_store.rs, SURVEY.md §2.7). We keep the same
design: every table is a directory of immutable data files plus a
monotonically-versioned manifest; `put_if_absent` is the single
atomic primitive the MVCC layer is built on.

Backends:
  * LocalStore   — POSIX dirs; atomicity via O_EXCL + rename.
  * MemoryStore  — process-local dict keyed by URI; `memory://` databases
                   (the reference supports the same scheme for tests).
  * IoTrackingStore — wrapper counting IOPS/bytes for tests and
                   `analyze_plan` (reference: io/object_store/io_tracking.rs).

S3/GCS/Azure are gated out in this environment (zero egress); the
interface is the extension point.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Iterator

from ..errors import InvalidInputError


class ObjectStore:
    """Minimal object-store interface used by the storage layer."""

    scheme: str = ""

    # ---- reads ----
    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, start: int, length: int) -> bytes:
        """Random-access range read (used by blob columns)."""
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> Iterator[str]:
        """Yield paths under `prefix` (non-recursive for dirs with '/')."""
        raise NotImplementedError

    # ---- writes ----
    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def put_if_absent(self, path: str, data: bytes) -> bool:
        """Atomically create `path`; return False if it already exists.

        This is the commit primitive for manifest MVCC.
        """
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        for p in list(self.list(prefix)):
            self.delete(p)

    def rename_prefix(self, old: str, new: str) -> None:
        raise NotImplementedError

    # local filesystem path for zero-copy mmap readers, if available
    def local_path(self, path: str) -> str | None:
        return None


class LocalStore(ObjectStore):
    scheme = "file"

    def __init__(self, root: str = "/"):
        self.root = root

    def _abs(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        return os.path.join(self.root, path)

    def read_bytes(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def read_range(self, path: str, start: int, length: int) -> bytes:
        with open(self._abs(path), "rb") as f:
            f.seek(start)
            return f.read(length)

    def size(self, path: str) -> int:
        return os.path.getsize(self._abs(path))

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def list(self, prefix: str) -> Iterator[str]:
        p = self._abs(prefix)
        if not os.path.isdir(p):
            return
        for name in sorted(os.listdir(p)):
            yield os.path.join(prefix, name)

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        # tmp name must be unique per WRITER, not per process: two
        # threads replacing the same path would otherwise share a tmp
        # file and one os.replace() races the other into FileNotFoundError
        import uuid as _uuid

        tmp = p + ".tmp.%s" % _uuid.uuid4().hex
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def put_if_absent(self, path: str, data: bytes) -> bool:
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        try:
            fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        return True

    def delete(self, path: str) -> None:
        p = self._abs(path)
        if os.path.isdir(p):
            import shutil

            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)

    def rename_prefix(self, old: str, new: str) -> None:
        os.replace(self._abs(old), self._abs(new))

    def local_path(self, path: str) -> str | None:
        return self._abs(path)


@dataclass
class _MemEntry:
    data: bytes


class MemoryStore(ObjectStore):
    """In-process store backing `memory://` databases."""

    scheme = "memory"

    # class-level registry so that connect("memory://name") twice in one
    # process sees the same data, like the reference's memory object store
    _registries: dict[str, "MemoryStore"] = {}
    _registry_lock = threading.Lock()

    def __init__(self):
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    @classmethod
    def for_uri(cls, name: str) -> "MemoryStore":
        with cls._registry_lock:
            if name not in cls._registries:
                cls._registries[name] = cls()
            return cls._registries[name]

    def read_bytes(self, path: str) -> bytes:
        with self._lock:
            if path not in self._objects:
                raise FileNotFoundError(path)
            return self._objects[path]

    def read_range(self, path: str, start: int, length: int) -> bytes:
        return self.read_bytes(path)[start : start + length]

    def size(self, path: str) -> int:
        return len(self.read_bytes(path))

    def exists(self, path: str) -> bool:
        with self._lock:
            if path in self._objects:
                return True
            prefix = path.rstrip("/") + "/"
            return any(k.startswith(prefix) for k in self._objects)

    def list(self, prefix: str) -> Iterator[str]:
        prefix = prefix.rstrip("/") + "/"
        with self._lock:
            keys = sorted(self._objects)
        seen = set()
        for k in keys:
            if k.startswith(prefix):
                rest = k[len(prefix) :]
                child = prefix + rest.split("/", 1)[0]
                if child not in seen:
                    seen.add(child)
                    yield child

    def write_bytes(self, path: str, data: bytes) -> None:
        with self._lock:
            self._objects[path] = bytes(data)

    def put_if_absent(self, path: str, data: bytes) -> bool:
        with self._lock:
            if path in self._objects:
                return False
            self._objects[path] = bytes(data)
            return True

    def delete(self, path: str) -> None:
        with self._lock:
            self._objects.pop(path, None)
            prefix = path.rstrip("/") + "/"
            for k in [k for k in self._objects if k.startswith(prefix)]:
                del self._objects[k]

    def rename_prefix(self, old: str, new: str) -> None:
        old_p = old.rstrip("/") + "/"
        new_p = new.rstrip("/") + "/"
        with self._lock:
            for k in [k for k in self._objects if k.startswith(old_p)]:
                self._objects[new_p + k[len(old_p) :]] = self._objects.pop(k)
            if old in self._objects:
                self._objects[new] = self._objects.pop(old)


@dataclass
class IoStats:
    read_iops: int = 0
    read_bytes: int = 0
    write_iops: int = 0
    write_bytes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "read_iops": self.read_iops,
                "read_bytes": self.read_bytes,
                "write_iops": self.write_iops,
                "write_bytes": self.write_bytes,
            }


class IoTrackingStore(ObjectStore):
    """Wraps another store counting IOPS/bytes.

    Reference: rust/lancedb/src/io/object_store/io_tracking.rs:18-36.
    """

    def __init__(self, inner: ObjectStore, stats: IoStats | None = None):
        self.inner = inner
        self.stats = stats or IoStats()
        self.scheme = inner.scheme

    def read_bytes(self, path: str) -> bytes:
        data = self.inner.read_bytes(path)
        with self.stats._lock:
            self.stats.read_iops += 1
            self.stats.read_bytes += len(data)
        return data

    def read_range(self, path: str, start: int, length: int) -> bytes:
        data = self.inner.read_range(path, start, length)
        with self.stats._lock:
            self.stats.read_iops += 1
            self.stats.read_bytes += len(data)
        return data

    def size(self, path: str) -> int:
        return self.inner.size(path)

    def exists(self, path: str) -> bool:
        return self.inner.exists(path)

    def list(self, prefix: str):
        return self.inner.list(prefix)

    def write_bytes(self, path: str, data: bytes) -> None:
        self.inner.write_bytes(path, data)
        with self.stats._lock:
            self.stats.write_iops += 1
            self.stats.write_bytes += len(data)

    def put_if_absent(self, path: str, data: bytes) -> bool:
        ok = self.inner.put_if_absent(path, data)
        if ok:
            with self.stats._lock:
                self.stats.write_iops += 1
                self.stats.write_bytes += len(data)
        return ok

    def delete(self, path: str) -> None:
        self.inner.delete(path)

    def rename_prefix(self, old: str, new: str) -> None:
        self.inner.rename_prefix(old, new)

    def local_path(self, path: str) -> str | None:
        return self.inner.local_path(path)


class MirroringStore(ObjectStore):
    """Writes go to primary and secondary; reads from primary.

    Reference: rust/lancedb/src/io/object_store.rs `MirroringObjectStore`.
    """

    def __init__(self, primary: ObjectStore, secondary: ObjectStore):
        self.primary = primary
        self.secondary = secondary
        self.scheme = primary.scheme

    def read_bytes(self, path: str) -> bytes:
        return self.primary.read_bytes(path)

    def read_range(self, path: str, start: int, length: int) -> bytes:
        return self.primary.read_range(path, start, length)

    def size(self, path: str) -> int:
        return self.primary.size(path)

    def exists(self, path: str) -> bool:
        return self.primary.exists(path)

    def list(self, prefix: str):
        return self.primary.list(prefix)

    def write_bytes(self, path: str, data: bytes) -> None:
        self.secondary.write_bytes(path, data)
        self.primary.write_bytes(path, data)

    def put_if_absent(self, path: str, data: bytes) -> bool:
        ok = self.primary.put_if_absent(path, data)
        if ok:
            self.secondary.write_bytes(path, data)
        return ok

    def delete(self, path: str) -> None:
        self.primary.delete(path)
        self.secondary.delete(path)

    def rename_prefix(self, old: str, new: str) -> None:
        self.primary.rename_prefix(old, new)
        self.secondary.rename_prefix(old, new)

    def local_path(self, path: str) -> str | None:
        return self.primary.local_path(path)


class LockTableCommitHandler:
    """External lock-table commit handler for stores without an atomic
    create-if-absent primitive (the reference's DynamoDB commit handler:
    reference rust/lancedb/src/io/object_store.rs:4, SURVEY.md §2.7).

    Serializes manifest creates through an auxiliary store that DOES
    have an atomic `put_if_absent` (local filesystem, memory, or a real
    lock service): acquire `<lock_root>/<sha1(path)>.lock`, then
    check-and-write the manifest, then release. Stale locks (older than
    `ttl_seconds`, e.g. a crashed committer) are broken.
    """

    def __init__(self, lock_store: "ObjectStore", lock_root: str, ttl_seconds: float = 30.0):
        self.lock_store = lock_store
        self.lock_root = lock_root.rstrip("/")
        self.ttl = ttl_seconds

    def _lock_key(self, path: str) -> str:
        import hashlib

        return f"{self.lock_root}/{hashlib.sha1(path.encode()).hexdigest()}.lock"

    def put_if_absent(self, store: "ObjectStore", path: str, data: bytes) -> bool:
        import json as _json
        import time as _time
        import uuid as _uuid

        key = self._lock_key(path)
        token = _uuid.uuid4().hex
        deadline = _time.time() + max(self.ttl * 2, 10.0)
        while True:
            doc = _json.dumps({"owner": token, "ts": _time.time(), "path": path})
            if self.lock_store.put_if_absent(key, doc.encode()):
                break
            try:
                held = _json.loads(self.lock_store.read_bytes(key))
                if _time.time() - float(held.get("ts", 0)) > self.ttl:
                    self.lock_store.delete(key)  # break a stale lock
                    continue
            except FileNotFoundError:
                continue  # released between put and read → retry at once
            except Exception:
                pass
            if _time.time() > deadline:
                raise TimeoutError(f"could not acquire commit lock for {path}")
            _time.sleep(0.02)
        try:
            if store.exists(path):
                return False
            store.write_bytes(path, data)
            return True
        finally:
            self.lock_store.delete(key)


class FsspecStore(ObjectStore):
    """Cloud object storage through fsspec (s3://, gs://, az://, oss://).

    The reference reaches S3/GCS/Azure/OSS through the Rust
    `object_store` crate (Cargo.toml:120-147); here any fsspec
    filesystem provides the same backends. `storage_options` pass
    through to the filesystem constructor (credentials, endpoints —
    reference connection.rs:860-877).

    `put_if_absent` (the manifest-commit primitive) is atomic when
    either (a) the backend supports conditional creates — fsspec
    `pipe_file(..., mode="create")` maps to S3 `If-None-Match: *` /
    GCS generation-0 preconditions — or (b) a `commit_handler` is
    configured (storage_options key ``lock_table_uri`` or
    ``commit_handler``), mirroring the reference's DynamoDB handler.
    Without both it falls back to check-then-write, which is safe only
    for a single writer.
    """

    def __init__(
        self,
        protocol: str,
        storage_options: dict | None = None,
        commit_handler: LockTableCommitHandler | None = None,
    ):
        import fsspec

        storage_options = dict(storage_options or {})
        commit_handler = storage_options.pop("commit_handler", commit_handler)
        lock_uri = storage_options.pop("lock_table_uri", None)
        if commit_handler is None and lock_uri is not None:
            lock_store, lock_root = resolve_uri(str(lock_uri))
            commit_handler = LockTableCommitHandler(lock_store, lock_root)
        self.commit_handler = commit_handler
        try:
            self.fs = fsspec.filesystem(protocol, **storage_options)
        except (ImportError, ValueError) as e:
            raise InvalidInputError(
                f"object-store scheme '{protocol}://' needs the fsspec "
                f"implementation for {protocol!r} installed: {e}"
            ) from e
        self.scheme = protocol

    def read_bytes(self, path: str) -> bytes:
        return self.fs.cat_file(path)

    def read_range(self, path: str, start: int, length: int) -> bytes:
        return self.fs.cat_file(path, start=start, end=start + length)

    def size(self, path: str) -> int:
        return self.fs.size(path)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def list(self, prefix: str) -> Iterator[str]:
        try:
            for p in self.fs.ls(prefix, detail=False):
                yield p
        except FileNotFoundError:
            return

    def write_bytes(self, path: str, data: bytes) -> None:
        self.fs.pipe_file(path, data)

    def put_if_absent(self, path: str, data: bytes) -> bool:
        if self.commit_handler is not None:
            return self.commit_handler.put_if_absent(self, path, data)
        # conditional create: S3 If-None-Match:* / GCS generation-0
        try:
            self.fs.pipe_file(path, data, mode="create")
            return True
        except FileExistsError:
            return False
        except (TypeError, ValueError, NotImplementedError):
            pass  # backend lacks conditional create — degrade below
        # single-writer fallback: check-then-write (NOT atomic; configure
        # lock_table_uri for concurrent committers on such backends)
        if self.fs.exists(path):
            return False
        self.fs.pipe_file(path, data)
        return True

    def delete(self, path: str) -> None:
        try:
            self.fs.rm_file(path)
        except FileNotFoundError:
            pass

    def rename_prefix(self, old: str, new: str) -> None:
        self.fs.mv(old, new, recursive=True)


def resolve_uri(uri: str, storage_options: dict | None = None) -> tuple[ObjectStore, str]:
    """Map a database/table URI to (store, root_path).

    URI routing mirrors reference connection.rs:1040-1063:
      * ``memory://``  → MemoryStore
      * ``db://``      → remote database (handled by the caller, not here)
      * ``s3://`` etc. → FsspecStore (needs the protocol's fsspec impl)
      * anything else  → LocalStore directory
    """
    if uri.startswith("memory://"):
        name = uri[len("memory://") :] or "_default"
        return MemoryStore.for_uri(name), name
    if uri.startswith("file://"):
        return LocalStore(), uri[len("file://") :]
    for scheme in ("s3", "gs", "az", "oss", "abfs", "gcs"):
        if uri.startswith(scheme + "://"):
            return FsspecStore(scheme, storage_options), uri[len(scheme) + 3 :]
    if uri.startswith("db://"):
        raise InvalidInputError("db:// URIs must be opened through the remote client")
    return LocalStore(), os.path.abspath(uri)
