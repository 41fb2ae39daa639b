"""The commit primitive of lancedb_tpu_torch's local store
(``LocalStore.put_if_absent``): a manifest becomes visible only whole,
and of racing committers exactly one wins.

The store writes the bytes to a temporary file, fsyncs it and publishes
it with ``os.link``. The pause below blocks the committer inside that
fsync, so the cases are deterministic: while it is blocked, the path is
not listed, the previous version stays the latest, and a second
committer that publishes first wins. Every thread a test starts is
joined with a timeout and checked to have ended.
"""

import os
import sys
import threading

import pyarrow as pa
import pytest

import lancedb_tpu_torch
from lancedb_tpu_torch.io.object_store import LocalStore, LockTableCommitHandler
from lancedb_tpu_torch.storage.dataset import Dataset
from lancedb_tpu_torch.storage.manifest import VERSIONS_DIR, manifest_path

TIMEOUT = 30


class PausedFsync:
    """Replaces ``os.fsync``: in the thread named ``victim`` it signals
    ``entered`` and waits for ``release`` before syncing; other threads
    sync at once."""

    def __init__(self, monkeypatch, victim: str):
        self.victim = victim
        self.entered, self.release = threading.Event(), threading.Event()
        self._fsync = os.fsync
        monkeypatch.setattr(os, "fsync", self)

    def __call__(self, fd):
        if threading.current_thread().name == self.victim:
            self.entered.set()
            assert self.release.wait(TIMEOUT)
        return self._fsync(fd)


def _start(name: str, fn, *args) -> tuple[threading.Thread, list]:
    out: list = []
    t = threading.Thread(target=lambda: out.append(fn(*args)), name=name, daemon=True)
    t.start()
    return t, out


def _join(*threads):
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def _table(path):
    db = lancedb_tpu_torch.connect(str(path), device="cpu")
    return db.create_table("t", pa.table({"id": list(range(10)), "v": [float(i) for i in range(10)]}))


def _next_manifest(store, root: str) -> tuple[str, bytes]:
    ds = Dataset.open(store, root)
    draft = ds.manifest.child("test_commit")
    return manifest_path(root, draft.version), draft.to_json_bytes()


def test_paused_commit_is_invisible_until_whole(tmp_path, monkeypatch):
    tbl = _table(tmp_path)
    store, root = LocalStore(), str(tmp_path / "t.lance")
    assert Dataset._latest_version(store, root) == 1
    path, data = _next_manifest(store, root)
    pause = PausedFsync(monkeypatch, "committer")
    t, won = _start("committer", store.put_if_absent, path, data)
    try:
        assert pause.entered.wait(TIMEOUT)
        # the bytes are written but not published
        assert path not in list(store.list(f"{root}/{VERSIONS_DIR}"))
        assert not store.exists(path)
        assert Dataset._latest_version(store, root) == 1
        assert Dataset.open(store, root).version == 1
        assert tbl.count_rows() == 10
    finally:
        pause.release.set()
        _join(t)
    assert won == [True]
    assert Dataset._latest_version(store, root) == 2
    assert store.read_bytes(path) == data
    # the temporary file is gone
    assert sorted(os.listdir(os.path.dirname(path))) == [
        os.path.basename(manifest_path(root, v)) for v in (1, 2)]


def test_first_to_publish_wins(tmp_path, monkeypatch):
    """A committer paused before it publishes loses to one that started
    later and published first; the loser leaves no file behind and the
    path holds the winner's bytes."""
    store = LocalStore()
    path = str(tmp_path / "v" / "42.json")
    pause = PausedFsync(monkeypatch, "slow")
    slow, slow_won = _start("slow", store.put_if_absent, path, b"slow")
    try:
        assert pause.entered.wait(TIMEOUT)
        assert store.put_if_absent(path, b"fast") is True
    finally:
        pause.release.set()
        _join(slow)
    assert slow_won == [False]
    assert store.read_bytes(path) == b"fast"
    assert os.listdir(tmp_path / "v") == ["42.json"]
    assert store.put_if_absent(path, b"late") is False


@pytest.mark.parametrize("n", [2, 8])
def test_racing_committers_one_winner(tmp_path, n):
    """``n`` threads released together on each of 20 paths: exactly one
    True per path, and the path holds that winner's bytes."""
    store = LocalStore()
    for trial in range(20):
        path = str(tmp_path / "v" / f"{trial:020d}.json")
        barrier = threading.Barrier(n)
        results: dict = {}

        def commit(i, path=path, barrier=barrier, results=results):
            barrier.wait(TIMEOUT)
            results[i] = store.put_if_absent(path, b"committer-%d" % i)

        threads = [threading.Thread(target=commit, args=(i,), daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        _join(*threads)
        winners = [i for i, ok in results.items() if ok]
        assert len(results) == n and len(winners) == 1
        assert store.read_bytes(path) == b"committer-%d" % winners[0]
    assert len(os.listdir(tmp_path / "v")) == 20  # no temporary file left


def test_reader_that_sees_a_version_reads_it_whole(tmp_path):
    """Readers poll the newest version and decode its manifest while a
    writer commits 30 versions with large manifests (1 MB config each),
    the switch interval shortened: every version a reader lists decodes
    whole, and versions only move forward."""
    _table(tmp_path)
    store, root = LocalStore(), str(tmp_path / "t.lance")
    errors, stop = [], threading.Event()

    def write():
        try:
            for _ in range(30):
                ds = Dataset.open(store, root)
                draft = ds.manifest.child("test_commit")
                draft.config = {"pad": "x" * (1 << 20)}
                ds.commit(draft)
        except Exception as e:  # reported below
            errors.append(e)

    def read():
        try:
            last = 0
            while not stop.is_set():
                v = Dataset._latest_version(store, root)
                m = Dataset._read_manifest(store, root, v)
                assert m.version == v >= last
                last = v
        except Exception as e:  # reported below
            errors.append(e)

    readers = [threading.Thread(target=read, daemon=True) for _ in range(4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in readers:
            t.start()
        writer = threading.Thread(target=write, daemon=True)
        writer.start()
        _join(writer)
    finally:
        stop.set()
        sys.setswitchinterval(switch)
    _join(*readers)
    assert not errors, errors
    assert Dataset._latest_version(store, root) == 31


def test_lock_table_documents_are_whole(tmp_path, monkeypatch):
    """The lock-table handler's lock document goes through the same
    primitive on a local lock store: while its writer is paused, a second
    committer neither sees the lock nor decodes a partial document, and
    the handler still lets exactly one committer create the path."""
    locks = LocalStore()
    handler = LockTableCommitHandler(locks, str(tmp_path / "locks"))
    data_store = LocalStore()
    path = str(tmp_path / "v" / "1.json")
    key = handler._lock_key(path)
    pause = PausedFsync(monkeypatch, "holder")
    holder, held = _start("holder", locks.put_if_absent, key, b'{"owner": "a", "ts": 1e18}')
    try:
        assert pause.entered.wait(TIMEOUT)
        assert not locks.exists(key)
        assert handler.put_if_absent(data_store, path, b"b") is True
    finally:
        pause.release.set()
        _join(holder)
    assert held == [True]  # the handler released its own lock before the holder published
    locks.delete(key)
    assert handler.put_if_absent(data_store, path, b"c") is False
    assert data_store.read_bytes(path) == b"b"
