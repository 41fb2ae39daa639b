"""The LSM write path: lancedb_tpu_torch (device="cpu") against
lancedb_tpu, mirroring tests/test_lsm.py and the LSM cases of
tests/test_table_api.py.

Each case runs the same operations on a table of each package and
compares what they return: specs, last-write-wins scans, generations,
seals, flushes, checkpoints and stats. The WAL's layout under ``_lsm/``
is the reference's, so a WAL written by either package is flushed by the
other into the same table. Every thread a test starts is joined with a
timeout.
"""

import threading
import uuid

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.lsm as ref_lsm
import lancedb_tpu_torch
import lancedb_tpu_torch.lsm as port_lsm
from lancedb_tpu_torch.errors import InvalidInputError

PKGS = ("port", "ref")
LSM = {"port": port_lsm, "ref": ref_lsm}
ROWS = [{"id": i, "val": f"v{i}", "n": i * 10} for i in range(20)]


def _connect(pkg, uri):
    if pkg == "port":
        return lancedb_tpu_torch.connect(str(uri), device="cpu")
    return lancedb_tpu.connect(str(uri))


@pytest.fixture
def tables():
    return {pkg: _connect(pkg, f"memory://{uuid.uuid4().hex}").create_table("t", ROWS)
            for pkg in PKGS}


def upsert(t, rows):
    return (t.merge_insert("id").when_matched_update_all().when_not_matched_insert_all()
            .use_lsm().execute(rows))


def both(tables, fn):
    """fn(table) on each package's table: equal results, the port's returned."""
    got, want = (fn(tables[p]) for p in PKGS)
    assert got == want
    return got


def _scan(t, where=None):
    q = t.query().use_lsm()
    return sorted((q.where(where) if where else q).to_arrow().to_pylist(),
                  key=lambda r: r["id"])


def _wal_view(stats: dict) -> dict:
    """The stats without byte counts (IPC files of equal rows may differ
    in size by their metadata)."""
    out = {k: v for k, v in stats.items() if k != "total_wal_bytes"}
    out["shards"] = {s: {k: v for k, v in d.items() if k != "bytes"}
                     for s, d in stats.get("shards", {}).items()}
    return out


# ------------------------------------------------------------------ the spec


def test_install_describe_drop(tables):
    spec = both(tables, lambda t: (t.set_lsm_write_spec("bucket", key_columns=["id"],
                                                        num_shards=4), t.describe_lsm_spec())[1])
    assert spec["mode"] == "bucket" and spec["key_columns"] == ["id"]
    assert spec["num_shards"] == 4
    assert spec["maintained_indexes"] == []  # a snapshot of (no) indexes
    assert spec["writer_config"]["max_entry_rows"] > 0
    both(tables, lambda t: (t.drop_lsm_spec(), t.describe_lsm_spec()))
    assert tables["port"].describe_lsm_spec() is None


def test_get_and_unset_spec(tables):
    assert both(tables, lambda t: t.get_lsm_write_spec()) is None
    both(tables, lambda t: (t.set_lsm_write_spec("unsharded", key_columns="id"),
                            t.get_lsm_write_spec())[1])
    both(tables, lambda t: (t.unset_lsm_write_spec(), t.get_lsm_write_spec()))
    assert tables["port"].get_lsm_stats() is None
    assert tables["port"].lsm_stats() == {"enabled": False}


@pytest.mark.parametrize("bad", ["no spec", "ghost key", "bad mode", "wrong keys",
                                 "not an upsert", "delete missing"])
def test_refusals(tables, bad):
    def run(t):
        if bad == "ghost key":
            t.set_lsm_write_spec("bucket", key_columns=["ghost"], num_shards=2)
        elif bad == "bad mode":
            t.set_lsm_write_spec("range", key_columns=["id"])
        if bad != "no spec":
            t.set_lsm_write_spec("unsharded", key_columns=["id"])
        if bad == "wrong keys":
            t.merge_insert("val").when_matched_update_all().when_not_matched_insert_all() \
                .use_lsm().execute([{"id": 1, "val": "x", "n": 0}])
        elif bad == "not an upsert":
            t.merge_insert("id").when_not_matched_insert_all().use_lsm().execute(
                [{"id": 1, "val": "x", "n": 0}])
        elif bad == "delete missing":
            t.merge_insert("id").when_not_matched_by_source_delete().use_lsm().execute(
                [{"id": 1, "val": "x", "n": 0}])
        else:
            upsert(t, [{"id": 1, "val": "x", "n": 0}])

    errs = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            run(tables[pkg])
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1] and errs[0][0] == "InvalidInputError"


# ------------------------------------------------------------ write and read


def test_wal_append_and_overlay(tables):
    both(tables, lambda t: t.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=4))
    stats = both(tables, lambda t: upsert(t, [{"id": 3, "val": "updated", "n": 333},
                                              {"id": 99, "val": "new", "n": 990}]))
    assert stats["num_rows"] == 2
    assert both(tables, lambda t: t.count_rows()) == 20  # the table is untouched
    rows = both(tables, _scan)
    by_id = {r["id"]: r for r in rows}
    assert len(rows) == 21 and by_id[3]["val"] == "updated" and by_id[99]["val"] == "new"
    assert {r["id"] for r in both(tables, lambda t: _scan(t, "n >= 300"))} >= {3, 99}
    # projection, row ids (a WAL row has the invalid one), offset and limit
    out = both(tables, lambda t: t.query().use_lsm().select(["val"]).with_row_id(True)
               .offset(18).limit(5).to_arrow().to_pylist())
    assert [r["_rowid"] for r in out][-1] == np.iinfo(np.uint64).max
    sizes = both(tables, lambda t: [b.num_rows for b in t.query().use_lsm().to_batches(8)])
    assert sum(sizes) == 21 and max(sizes) == 8


def test_last_write_wins(tables):
    both(tables, lambda t: t.set_lsm_write_spec("unsharded", key_columns=["id"]))
    both(tables, lambda t: upsert(t, [{"id": 5, "val": "first", "n": 1}]))
    both(tables, lambda t: upsert(t, [{"id": 5, "val": "second", "n": 2}]))
    rows = both(tables, lambda t: _scan(t, "id = 5"))
    assert len(rows) == 1 and rows[0]["val"] == "second"


def test_sharding_distribution(tables):
    both(tables, lambda t: t.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=4))
    both(tables, lambda t: upsert(t, [{"id": i, "val": "x", "n": 0} for i in range(100, 140)]))
    stats = both(tables, lambda t: _wal_view(t.lsm_stats()))
    assert stats["enabled"] and len(stats["shards"]) > 1
    assert stats["total_wal_rows"] == 40


def test_identity_sharding(tables):
    both(tables, lambda t: t.set_lsm_write_spec("identity", key_columns=["id"], num_shards=3))
    both(tables, lambda t: upsert(t, [{"id": 7, "val": "x", "n": 0}]))
    assert list(both(tables, lambda t: _wal_view(t.lsm_stats()))["shards"]) == [7 % 3]


def test_search_builders_refuse_use_lsm(tables):
    t = _connect("port", f"memory://{uuid.uuid4().hex}").create_table(
        "tv", {"id": np.arange(8), "vector": list(np.eye(8, 4, dtype=np.float32))})
    for call in (lambda: t.search(np.zeros(4, np.float32)).use_lsm().to_arrow(),
                 lambda: t.query().use_lsm().nearest_to([1.0, 0.0, 0.0, 0.0]).to_arrow()):
        with pytest.raises(InvalidInputError, match="use_lsm"):
            call()
    with pytest.raises(InvalidInputError, match="fragment"):
        tables["port"].query().use_lsm().fragment_ids([0]).to_arrow()
    q = tables["port"].query().use_lsm().to_query_object()
    assert q["use_lsm"] is True and q == tables["ref"].query().use_lsm().to_query_object()


# ---------------------------------------------------------------- maintenance


def test_flush_folds_into_base(tables):
    both(tables, lambda t: t.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=2))
    both(tables, lambda t: upsert(t, [{"id": 3, "val": "updated", "n": 0},
                                      {"id": 50, "val": "new", "n": 0}]))
    out = both(tables, lambda t: {k: v for k, v in t.flush_lsm().items() if k != "merge"})
    assert out["rows_flushed"] == 2
    merge = both(tables, lambda t: t._lsm.flush())  # nothing left
    assert merge == {"rows_flushed": 0, "entries_removed": 0}
    assert both(tables, lambda t: t.count_rows()) == 21
    assert both(tables, lambda t: t.count_rows("val = 'updated'")) == 1
    assert both(tables, lambda t: t.lsm_stats()["total_wal_rows"]) == 0
    assert both(tables, lambda t: t.to_arrow().sort_by("id").to_pylist())[3]["val"] == "updated"


def test_flush_merge_stats(tables):
    both(tables, lambda t: t.set_lsm_write_spec("unsharded", key_columns=["id"]))
    both(tables, lambda t: upsert(t, [{"id": 3, "val": "u", "n": 0}, {"id": 51, "val": "n", "n": 0}]))
    merge = both(tables, lambda t: t.flush_lsm()["merge"])
    assert merge["num_updated_rows"] == 1 and merge["num_inserted_rows"] == 1


def test_checkpoint(tables):
    both(tables, lambda t: t.set_lsm_write_spec("unsharded", key_columns=["id"]))
    both(tables, lambda t: upsert(t, [{"id": 200, "val": "wal", "n": 1}]))
    out = both(tables, lambda t: t.checkpoint_lsm(timeout=10))
    assert out["rows_flushed"] == 1 and out["sealed_watermark"] == {0: 0}
    assert both(tables, lambda t: t.count_rows("id = 200")) == 1
    assert both(tables, lambda t: t.lsm_stats()["total_wal_rows"]) == 0


def test_compact_lsm_runs_as_a_job(tables):
    both(tables, lambda t: t.set_lsm_write_spec("unsharded", key_columns=["id"]))
    both(tables, lambda t: upsert(t, [{"id": 300, "val": "job", "n": 0}]))
    job = tables["port"].compact_lsm()
    assert job.wait(timeout=30)["rows_flushed"] == 1 and job.status().value == "SUCCEEDED"
    assert tables["port"]._conn.list_jobs()[0]["type"] == "compact_lsm"
    tables["ref"].compact_lsm().wait(timeout=30)
    assert both(tables, lambda t: t.to_arrow().sort_by("id").to_pylist())[-1]["val"] == "job"


def test_drop_nonempty_requires_force(tables):
    both(tables, lambda t: t.set_lsm_write_spec("unsharded", key_columns=["id"]))
    both(tables, lambda t: upsert(t, [{"id": 300, "val": "x", "n": 0}]))
    for t in tables.values():
        with pytest.raises(Exception, match="not empty"):
            t.drop_lsm_spec()
    both(tables, lambda t: (t.drop_lsm_spec(force=True), t.describe_lsm_spec()))


# ---------------------------------------------------------------- generations


def test_seal_advances_generation(tables):
    def run(t):
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        upsert(t, [{"id": 1, "val": "a", "n": 0}])
        w = t._lsm.writer(0)
        before = w.generation
        sealed = w.seal()
        upsert(t, [{"id": 2, "val": "b", "n": 0}])
        return before, sealed, w.generation, t.lsm_stats()["shards"][0]["generations"]

    assert both(tables, run) == (0, 0, 1, [0, 1])


def test_flush_targets_the_sealed_watermark_only(tables):
    """Rows written after the seal survive the flush in the next generation."""
    def run(t):
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        upsert(t, [{"id": 100, "val": "old-gen", "n": 0}])
        watermark = t._lsm.seal_all()
        upsert(t, [{"id": 101, "val": "new-gen", "n": 0}])
        out = t._lsm.flush(max_generation=watermark)
        return (out["rows_flushed"], t.count_rows("id = 100"), t.count_rows("id = 101"),
                t.lsm_stats()["total_wal_rows"])

    assert both(tables, run) == (1, 1, 0, 1)


def test_a_second_writer_discovers_the_seal(tables):
    def run(t):
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        lsm = t._lsm
        upsert(t, [{"id": 1, "val": "x", "n": 0}])
        g1 = lsm.writer(0).seal()
        pkg = "port" if isinstance(t, lancedb_tpu_torch.Table) else "ref"
        return g1, LSM[pkg].ShardWriter(lsm._store, lsm._shard_dir(0)).generation

    assert both(tables, run) == (0, 1)


def test_writer_cache_persists_across_upserts(tables):
    def run(t):
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        upsert(t, [{"id": 1, "val": "a", "n": 0}])
        upsert(t, [{"id": 2, "val": "b", "n": 0}])
        before = t._lsm.writer_manifests()
        t.close_lsm_writers()
        return before, t._lsm.writer_manifests()

    before, after = both(tables, run)
    assert before[0]["entries_written"] == 2 and before[0]["rows_written"] == 2
    assert after == {}


def test_latest_wins_across_generations_and_writer_restarts(tables):
    def run(t):
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        upsert(t, [{"id": 7, "val": "gen0", "n": 0}])
        t._lsm.seal_all()
        upsert(t, [{"id": 7, "val": "gen1", "n": 0}])
        across_gens = _scan(t, "id = 7")
        upsert(t, [{"id": 7, "val": "second", "n": 0}])
        t.close_lsm_writers()  # a fresh writer must not rank its entries first
        upsert(t, [{"id": 7, "val": "newest", "n": 0}])
        restarted = _scan(t, "id = 7")
        t.flush_lsm()
        return across_gens, restarted, t.count_rows("val = 'newest'")

    assert both(tables, run) == ([{"id": 7, "val": "gen1", "n": 0}],
                                 [{"id": 7, "val": "newest", "n": 0}], 1)


def test_idle_flush_mints_no_markers(tables):
    def run(t):
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        upsert(t, [{"id": 1, "val": "x", "n": 0}])
        t.flush_lsm()
        lsm = t._lsm
        gen = lsm.writer(0).generation
        flushed = [t.flush_lsm()["rows_flushed"] for _ in range(5)]
        names = sorted(p.rsplit("/", 1)[-1] for p in lsm._store.list(lsm._shard_dir(0)))
        return gen, flushed, lsm.writer(0).generation, names

    gen, flushed, gen_after, names = both(tables, run)
    assert flushed == [0] * 5 and gen_after == gen
    assert [n for n in names if n.startswith("SEAL_")] == ["SEAL_0000000000"]


def test_maintained_indexes_validated_and_refreshed(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    base = pa.table({"id": np.arange(200), "vector": pa.FixedSizeListArray.from_arrays(
        pa.array(x.ravel()), 16)})
    new = pa.table({"id": 1000 + np.arange(5), "vector": pa.FixedSizeListArray.from_arrays(
        pa.array(rng.standard_normal(80).astype(np.float32)), 16)})
    outs = {}
    for pkg in PKGS:
        t = _connect(pkg, tmp_path / pkg).create_table("t", base)
        t.create_index(index_type="IVF_FLAT", num_partitions=4, name="vi")
        with pytest.raises(Exception, match="not found"):
            t.set_lsm_write_spec("unsharded", key_columns=["id"], maintained_indexes=["ghost"])
        t.set_lsm_write_spec("unsharded", key_columns=["id"])
        assert t.describe_lsm_spec()["maintained_indexes"] == ["vi"]
        upsert(t, new)
        out = t.flush_lsm()
        outs[pkg] = (out["rows_flushed"], out["indexes_refreshed"],
                     t.index_stats("vi")["num_unindexed_rows"],
                     t.search(new["vector"][2].as_py()).nprobes(4).limit(3).to_arrow()["id"]
                     .to_pylist())
    assert outs["port"] == outs["ref"] and outs["port"][:3] == (5, 1, 0)
    assert outs["port"][3][0] == 1002


# ------------------------------------------------------ across the packages


@pytest.mark.parametrize("writer", PKGS)
def test_a_wal_written_by_either_package_flushes_in_the_other(tmp_path, writer):
    """One package installs the spec and writes the WAL (over two
    generations); the other reads it with use_lsm and flushes it. The
    table is the one a flush by the writer gives."""
    reader = PKGS[1 - PKGS.index(writer)]
    results = {}
    for flusher in (writer, reader):
        path = tmp_path / f"flushed_by_{flusher}"
        t = _connect(writer, path).create_table("t", ROWS)
        t.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=3)
        upsert(t, [{"id": i, "val": f"w{i}", "n": -i} for i in range(15, 30)])
        t._lsm.seal_all()
        upsert(t, [{"id": i, "val": f"z{i}", "n": i} for i in range(0, 40, 7)])
        f = _connect(flusher, path).open_table("t")
        scan = _scan(f)
        out = f.flush_lsm()
        assert out["rows_flushed"] == 19 and f.lsm_stats()["total_wal_rows"] == 0
        reopened = _connect(writer, path).open_table("t")
        results[flusher] = (scan, reopened.to_arrow().sort_by("id").to_pylist(),
                            sorted(out["generations_flushed"]))
    assert results[writer] == results[reader]
    scan, table, _ = results[reader]
    assert scan == table and len(table) == 31


def test_async_lsm_spec_methods(tmp_path):
    import asyncio

    async def main(pkg):
        if pkg == "port":
            db = await lancedb_tpu_torch.connect_async(str(tmp_path / pkg), device="cpu")
        else:
            db = await lancedb_tpu.connect_async(str(tmp_path / pkg))
        t = await db.create_table("t", ROWS)
        before = await t.get_lsm_write_spec()
        t._t.set_lsm_write_spec("unsharded", key_columns=["id"])
        spec = await t.get_lsm_write_spec()
        await t.unset_lsm_write_spec()
        return before, spec, await t.get_lsm_write_spec()

    got, want = (asyncio.run(asyncio.wait_for(main(p), timeout=60)) for p in PKGS)
    assert got == want and got[1]["key_columns"] == ["id"]


# ------------------------------------------------------------- concurrency


def test_concurrent_sealers_and_writers(tables):
    """Writers put while sealers seal the same shard: each generation is
    sealed once (one marker, one winner), no write is lost, and a
    checkpoint folds every row."""
    t = tables["port"]
    t.set_lsm_write_spec("unsharded", key_columns=["id"])
    lsm = t._lsm
    upsert(t, [{"id": 1000, "val": "seed", "n": 0}])
    errs, sealed = [], []

    def writer(w):
        try:
            for j in range(10):
                upsert(t, [{"id": 2000 + 100 * w + j, "val": f"w{w}", "n": j}])
        except Exception as e:  # pragma: no cover - the assertion reports it
            errs.append(repr(e))

    def sealer():
        try:
            for _ in range(5):
                sealed.append(port_lsm.ShardWriter(lsm._store, lsm._shard_dir(0)).seal())
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
    threads += [threading.Thread(target=sealer) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errs, errs
    names = [p.rsplit("/", 1)[-1] for p in lsm._store.list(lsm._shard_dir(0))]
    seals = [n for n in names if n.startswith("SEAL_")]
    assert len(seals) == len(set(seals)) and seals
    assert t.lsm_stats()["total_wal_rows"] == 31
    assert t.checkpoint_lsm(timeout=30)["rows_flushed"] > 0
    t.flush_lsm()  # generations opened after the checkpoint's seal
    assert t.count_rows() == 20 + 31 and t.lsm_stats()["total_wal_rows"] == 0
