"""LSM / MemWAL ingest path: high-frequency upserts without base-table
rewrites.

Reference semantics being matched (SURVEY.md §2.1 "Update/Delete/
Merge" + "LSM checkpoint"; rust table.rs:379-530 sharding specs,
table/merge/lsm.rs ShardWriter cache `:322-380` + maintained-index
resolution `:134-176`, checkpoint.rs client-driven checkpoint; lance
MemWAL generation model):

* ``set_lsm_write_spec`` installs a sharding spec — rows route to a
  shard by hashed key (bucket), direct integer key (identity), or a
  single shard (unsharded). The spec also records which indexes the
  LSM path maintains (``None`` = every index, snapshotted at install
  time — merge/lsm.rs:134-176) and writer config defaults.
* ``merge_insert(...).use_lsm()`` routes rows through cached
  ``ShardWriter``s: each put lands as an immutable Arrow IPC WAL entry
  in the shard's CURRENT GENERATION — O(rows written), durable on
  return, no join against the base table.
* Generations: a shard's WAL is a sequence of generations. ``seal``
  closes the current generation with a conditional-create marker
  (exactly one concurrent sealer wins); writers observing the marker
  start the next generation. Flush folds only sealed generations, so
  concurrent writers land in a fresh generation and are never lost.
* Reads with LSM enabled merge WAL rows over the base table with
  last-write-wins PK dedup ordered by (generation, sequence).
* ``flush_lsm`` seals + folds sealed generations into the base table
  through the normal single-commit merge_insert, drops the consumed
  entries, and leaves FLUSHED markers as generation history.
  ``checkpoint_lsm`` seals once then flushes until the sealed
  watermark is durable — the reference's convergence loop.

Layout under the table root::

    _lsm/spec.json
    _lsm/shard_<k>/gen_<G>/<seq>-<uuid>.arrow   (WAL entries)
    _lsm/shard_<k>/SEAL_<G>                     (generation sealed)
    _lsm/shard_<k>/FLUSHED_<G>                  (generation folded)
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

from .errors import InvalidInputError
from .storage.manifest import new_uuid

LSM_DIR = "_lsm"
_GEN_W = 10  # zero-pad widths keep lexicographic == numeric order

DEFAULT_WRITER_CONFIG = {
    # entries this large (rows) are written as-is; smaller puts still
    # land immediately (durability) — the knob exists for parity with
    # the reference's writer_config_defaults (table.rs set_lsm_write_spec)
    "max_entry_rows": 100_000,
}


class LsmSpec:
    def __init__(
        self,
        mode: str,
        key_columns: list[str],
        num_shards: int = 1,
        maintained_indexes: list[str] | None = None,
        writer_config: dict | None = None,
    ):
        if mode not in ("bucket", "identity", "unsharded"):
            raise InvalidInputError(f"unknown LSM sharding mode {mode!r}")
        if not key_columns:
            raise InvalidInputError("LSM spec needs key columns (the primary key)")
        if mode == "bucket" and num_shards < 1:
            raise InvalidInputError("bucket sharding needs num_shards >= 1")
        self.mode = mode
        self.key_columns = list(key_columns)
        self.num_shards = num_shards if mode == "bucket" else (num_shards or 1)
        self.maintained_indexes = maintained_indexes
        self.writer_config = {**DEFAULT_WRITER_CONFIG, **(writer_config or {})}

    def to_json(self) -> dict:
        return {
            "mode": self.mode,
            "key_columns": self.key_columns,
            "num_shards": self.num_shards,
            "maintained_indexes": self.maintained_indexes,
            "writer_config": self.writer_config,
        }

    @staticmethod
    def from_json(d: dict) -> "LsmSpec":
        return LsmSpec(
            d["mode"],
            d["key_columns"],
            d.get("num_shards", 1),
            d.get("maintained_indexes"),
            d.get("writer_config"),
        )

    def shard_of(self, key_values: tuple) -> int:
        if self.mode == "unsharded":
            return 0
        if self.mode == "identity":
            v = key_values[0]
            if not isinstance(v, (int, np.integer)):
                raise InvalidInputError("identity sharding needs an integer key")
            return int(v) % self.num_shards
        blob = "\x1f".join(repr(v) for v in key_values).encode()
        return int.from_bytes(hashlib.md5(blob).digest()[:8], "little") % self.num_shards


class ShardWriter:
    """One shard's cached WAL writer (reference merge/lsm.rs:322-380).

    Tracks the shard's current generation and a per-writer sequence;
    every ``put`` writes one immutable WAL entry (durable on return)
    and updates the in-memory manifest used by the read path to
    snapshot this shard without re-listing."""

    def __init__(self, store, shard_dir: str):
        self._store = store
        self._dir = shard_dir
        self._lock = threading.Lock()
        self.generation = _current_generation(store, shard_dir)
        self.seq = 0
        self.entries_written = 0
        self.rows_written = 0

    def put(self, part: pa.Table) -> str:
        with self._lock:
            # a concurrent sealer may have closed our generation: re-check
            # the marker lazily (cheap exists) every put
            if self._store.exists(_seal_marker(self._dir, self.generation)):
                self.generation = _current_generation(self._store, self._dir)
            sink = io.BytesIO()
            with ipc.new_file(sink, part.schema) as w:
                for b in part.to_batches():
                    w.write_batch(b)
            # entry names order by WALL CLOCK within a generation so
            # last-write-wins survives writer restarts (a fresh writer's
            # counter would otherwise restart below existing entries and
            # silently lose newer values); the uuid disambiguates ties
            path = (
                f"{self._dir}/gen_{self.generation:0{_GEN_W}d}/"
                f"{time.time_ns():020d}-{new_uuid()}.arrow"
            )
            self._store.write_bytes(path, sink.getvalue())
            self.seq += 1
            self.entries_written += 1
            self.rows_written += part.num_rows
            return path

    def seal(self) -> int:
        """Seal the current generation; exactly one concurrent sealer
        wins the conditional create. Returns the sealed generation."""
        with self._lock:
            gen = self.generation
            # conditional create: losing to another sealer is the same outcome
            self._store.put_if_absent(_seal_marker(self._dir, gen), b"")
            self.generation = gen + 1
            return gen

    def manifest(self) -> dict:
        """In-memory view (reference merge/lsm.rs:376-380)."""
        return {
            "generation": self.generation,
            "entries_written": self.entries_written,
            "rows_written": self.rows_written,
        }


def _seal_marker(shard_dir: str, gen: int) -> str:
    return f"{shard_dir}/SEAL_{gen:0{_GEN_W}d}"


def _flushed_marker(shard_dir: str, gen: int) -> str:
    return f"{shard_dir}/FLUSHED_{gen:0{_GEN_W}d}"


def _current_generation(store, shard_dir: str) -> int:
    """max sealed generation + 1 (0 when the shard is fresh)."""
    best = -1
    try:
        names = [p.rsplit("/", 1)[-1] for p in store.list(shard_dir)]
    except FileNotFoundError:
        return 0
    for n in names:
        if n.startswith("SEAL_"):
            best = max(best, int(n[len("SEAL_") :]))
    return best + 1


class LsmStore:
    """Host-side manager for one table's WAL state, caching one
    ShardWriter per shard for the session (reference's per-table
    writer cache, merge/lsm.rs:322-334)."""

    def __init__(self, dataset):
        self._ds = dataset
        self._store = dataset.store
        self._root = dataset.root
        self._writers: dict[int, ShardWriter] = {}
        self._writers_lock = threading.Lock()

    # ------------------------------------------------------------- spec
    def _spec_path(self) -> str:
        return f"{self._root}/{LSM_DIR}/spec.json"

    def _shard_dir(self, shard: int) -> str:
        return f"{self._root}/{LSM_DIR}/shard_{shard}"

    def set_spec(self, spec: LsmSpec) -> None:
        for c in spec.key_columns:
            if c not in self._ds.schema.names:
                raise InvalidInputError(f"LSM key column {c!r} not in schema")
        # resolve the maintained-index selection against the live indices
        # (reference merge/lsm.rs:134-176): None = everything, snapshotted
        # now; explicit names must exist
        index_names = [ix.name for ix in self._ds.manifest.indices]
        if spec.maintained_indexes is None:
            spec.maintained_indexes = index_names
        else:
            missing = set(spec.maintained_indexes) - set(index_names)
            if missing:
                raise InvalidInputError(
                    f"maintained indexes not found on the table: {sorted(missing)}"
                )
        self._store.write_bytes(self._spec_path(), json.dumps(spec.to_json()).encode())

    def get_spec(self) -> LsmSpec | None:
        try:
            return LsmSpec.from_json(json.loads(self._store.read_bytes(self._spec_path())))
        except FileNotFoundError:
            return None

    def drop_spec(self, *, force: bool = False) -> None:
        if not force and self.total_wal_rows() > 0:
            raise InvalidInputError("LSM WAL is not empty; flush first or pass force=True")
        self.close_writers()
        self._store.delete(f"{self._root}/{LSM_DIR}")

    # ----------------------------------------------------------- writers
    def writer(self, shard: int) -> ShardWriter:
        with self._writers_lock:
            w = self._writers.get(shard)
            if w is None:
                w = self._writers[shard] = ShardWriter(self._store, self._shard_dir(shard))
            return w

    def close_writers(self) -> None:
        """Drain the cache (reference close_lsm_writers, merge/lsm.rs:312)."""
        with self._writers_lock:
            self._writers.clear()

    def writer_manifests(self) -> dict[int, dict]:
        with self._writers_lock:
            return {s: w.manifest() for s, w in self._writers.items()}

    # ------------------------------------------------------------ write
    def append(self, data: pa.Table) -> dict:
        """Route rows to shard WALs through the cached writers; one WAL
        entry per touched shard."""
        spec = self.get_spec()
        if spec is None:
            raise InvalidInputError("no LSM write spec installed; call set_lsm_write_spec")
        data = self._ds._align_to_schema(data)
        keys = list(zip(*[data.column(c).to_pylist() for c in spec.key_columns]))
        shard_rows: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            shard_rows.setdefault(spec.shard_of(k), []).append(i)
        written = {}
        max_rows = spec.writer_config["max_entry_rows"]
        for shard, rows in shard_rows.items():
            w = self.writer(shard)
            for start in range(0, len(rows), max_rows):
                part = data.take(pa.array(rows[start : start + max_rows]))
                w.put(part)
            written[shard] = len(rows)
        return {"num_rows": data.num_rows, "shards": written}

    # ------------------------------------------------------------- read
    def _entries(self, sealed_only: bool = False, max_generation: dict | None = None):
        """(sort_key, path) for live WAL entries across shards.

        ``max_generation`` maps shard -> highest generation to include
        (the per-shard seal watermark a flush targets)."""
        base = f"{self._root}/{LSM_DIR}"
        out = []
        try:
            shard_dirs = [
                p for p in self._store.list(base) if p.rsplit("/", 1)[-1].startswith("shard_")
            ]
        except FileNotFoundError:
            return []
        for sd in shard_dirs:
            shard = int(sd.rsplit("shard_", 1)[-1])
            names = list(self._store.list(sd))
            sealed = {
                int(p.rsplit("/", 1)[-1][len("SEAL_") :])
                for p in names
                if p.rsplit("/", 1)[-1].startswith("SEAL_")
            }
            for p in names:
                leaf = p.rsplit("/", 1)[-1]
                if not leaf.startswith("gen_"):
                    continue
                gen = int(leaf[len("gen_") :])
                if sealed_only and gen not in sealed:
                    continue
                if max_generation is not None and gen > max_generation.get(shard, -1):
                    continue
                for e in self._store.list(p):
                    if e.endswith(".arrow"):
                        out.append(((gen, e.rsplit("/", 1)[-1]), e))
        out.sort()
        return out

    def wal_rows(self, sealed_only: bool = False, max_generation: dict | None = None):
        """All live WAL rows, PK-deduped latest-wins by (gen, seq)."""
        spec = self.get_spec()
        if spec is None:
            return None
        parts = []
        for _, path in self._entries(sealed_only=sealed_only, max_generation=max_generation):
            data = self._store.read_bytes(path)
            parts.append(ipc.open_file(pa.BufferReader(data)).read_all())
        if not parts:
            return None
        merged = pa.concat_tables(parts)  # (generation, seq) chronological
        keys = list(zip(*[merged.column(c).to_pylist() for c in spec.key_columns]))
        last_index: dict = {}
        for i, k in enumerate(keys):
            last_index[k] = i
        keep = sorted(last_index.values())
        return merged.take(pa.array(keep))

    def total_wal_rows(self) -> int:
        t = self.wal_rows()
        return t.num_rows if t is not None else 0

    # ---------------------------------------------------------- maintain
    def seal_all(self) -> dict[int, int]:
        """Seal the current generation of every shard that has entries;
        returns shard -> sealed generation (the flush watermark)."""
        watermark: dict[int, int] = {}
        base = f"{self._root}/{LSM_DIR}"
        try:
            shard_dirs = [
                p for p in self._store.list(base) if p.rsplit("/", 1)[-1].startswith("shard_")
            ]
        except FileNotFoundError:
            return watermark
        for sd in shard_dirs:
            shard = int(sd.rsplit("shard_", 1)[-1])
            w = self.writer(shard)
            gen_dir = f"{sd}/gen_{w.generation:0{_GEN_W}d}"
            has_entries = any(
                p.endswith(".arrow") for p in self._store.list(gen_dir)
            )
            if has_entries:
                watermark[shard] = w.seal()
            else:
                # nothing new: the watermark is the last sealed generation
                watermark[shard] = w.generation - 1
        return watermark

    def flush(self, max_generation: dict | None = None) -> dict:
        """Seal, then fold sealed WAL generations into the base table
        (one merge_insert commit) and drop the consumed entries."""
        spec = self.get_spec()
        if spec is None:
            raise InvalidInputError("no LSM spec installed")
        if max_generation is None:
            max_generation = self.seal_all()
        entries = self._entries(sealed_only=True, max_generation=max_generation)
        if not entries:
            return {"rows_flushed": 0, "entries_removed": 0}
        rows = self.wal_rows(sealed_only=True, max_generation=max_generation)
        stats = self._ds.merge_insert(
            rows,
            on=spec.key_columns,
            when_matched_update_all=True,
            when_not_matched_insert_all=True,
        )
        flushed_gens: set[tuple[int, int]] = set()
        for (gen, _), path in entries:
            shard = int(path.split("/shard_")[-1].split("/")[0])
            self._store.delete(path)
            flushed_gens.add((shard, gen))
        for shard, gen in flushed_gens:
            marker = _flushed_marker(self._shard_dir(shard), gen)
            if not self._store.exists(marker):
                self._store.write_bytes(marker, b"")
        return {
            "rows_flushed": rows.num_rows,
            "entries_removed": len(entries),
            "generations_flushed": sorted(flushed_gens),
            "merge": stats,
        }

    def checkpoint(self, timeout: float = 60.0) -> dict:
        """Seal once, flush until the sealed watermark is durable in the
        base table (reference checkpoint.rs: seal → compact → poll
        generations until the initial L0 is gone)."""
        watermark = self.seal_all()
        deadline = time.monotonic() + timeout
        flushed = {"rows_flushed": 0, "entries_removed": 0}
        while time.monotonic() < deadline:
            res = self.flush(max_generation=watermark)
            flushed["rows_flushed"] += res["rows_flushed"]
            flushed["entries_removed"] += res["entries_removed"]
            if not self._entries(sealed_only=True, max_generation=watermark):
                return {"sealed_watermark": watermark, **flushed}
            time.sleep(0.05)
        raise TimeoutError("checkpoint_lsm did not converge")

    def stats(self) -> dict:
        spec = self.get_spec()
        if spec is None:
            return {"enabled": False}
        shards: dict[int, dict] = {}
        total_rows = 0
        total_bytes = 0
        for (gen, _), path in self._entries():
            shard = int(path.split("/shard_")[-1].split("/")[0])
            size = self._store.size(path)
            data = self._store.read_bytes(path)
            nrows = ipc.open_file(pa.BufferReader(data)).read_all().num_rows
            s = shards.setdefault(
                shard, {"entries": 0, "rows": 0, "bytes": 0, "generations": set()}
            )
            s["entries"] += 1
            s["rows"] += nrows
            s["bytes"] += size
            s["generations"].add(gen)
            total_rows += nrows
            total_bytes += size
        for s in shards.values():
            s["generations"] = sorted(s["generations"])
            s["segments"] = s["entries"]  # back-compat alias
        return {
            "enabled": True,
            "spec": spec.to_json(),
            "shards": shards,
            "writers": self.writer_manifests(),
            "total_wal_rows": total_rows,
            "total_wal_bytes": total_bytes,
        }
