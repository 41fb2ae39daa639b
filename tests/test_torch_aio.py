"""The async surface of lancedb_tpu_torch (device="cpu") against
lancedb_tpu's: connect_async, AsyncConnection, AsyncTable and the async
builders, with the streaming to_batches.

Each test runs the same coroutine on both packages over two copies of one
seeded table (a reference-built IVF_PQ index where it searches) and
compares the results: tables sorted by id exactly, search hits row for
row with distances to rtol 1.3e-5 (PERF.md §7). Every coroutine runs
under a 60 s asyncio timeout, so no test can hang.
"""

import asyncio
import shutil

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu.index import IvfPq as RefIvfPq

N, DIM, NQ = 1500, 16, 6
_RNG = np.random.default_rng(11)
X = _RNG.standard_normal((N, DIM)).astype(np.float32)
Q = _RNG.standard_normal((NQ, DIM)).astype(np.float32)
_WORDS = np.array(["alpha", "beta", "gamma", "delta"])
TABLE = pa.table({
    "id": np.arange(N, dtype=np.int64),
    "category": np.arange(N, dtype=np.int64) % 10,
    "text": [" ".join(_WORDS[_RNG.integers(0, 4, 3)]) for _ in range(N)],
    "vector": pa.FixedSizeListArray.from_arrays(pa.array(X.ravel()), DIM),
})
NEW = pa.table({
    "id": np.array([1, 2, N + 1], dtype=np.int64),
    "category": np.array([7, 7, 7], dtype=np.int64),
    "text": ["alpha", "beta", "gamma"],
    "vector": pa.FixedSizeListArray.from_arrays(pa.array((Q[:3] + 0.001).ravel()), DIM),
})


def arun(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    path = tmp_path_factory.mktemp("aio_base")
    t = lancedb_tpu.connect(str(path)).create_table("t", TABLE)
    t.create_index(config=RefIvfPq(num_partitions=4, num_sub_vectors=4, max_iterations=10))
    t.create_fts_index("text")
    return path


@pytest.fixture()
def dbs(base, tmp_path):
    """(port, reference) async connect coroutines over two copies."""
    for side in ("port", "ref"):
        shutil.copytree(base, tmp_path / side)
    return (lambda **kw: lancedb_tpu_torch.connect_async(str(tmp_path / "port"), device="cpu",
                                                         **kw),
            lambda **kw: lancedb_tpu.connect_async(str(tmp_path / "ref"), **kw))


def _sync_port(dbs):
    """A sync handle on the port's copy."""
    return lancedb_tpu_torch.connect(arun(dbs[0]()).uri, device="cpu").open_table("t")


def _both(dbs, body):
    return [arun(body(connect)) for connect in dbs]


def _same_hits(got: pa.Table, want: pa.Table) -> None:
    assert got.column_names == want.column_names and got.num_rows == want.num_rows
    for col in ("id", "query_index"):
        if col in want.column_names:
            np.testing.assert_array_equal(np.asarray(got[col]), np.asarray(want[col]))
    for col in ("_distance", "_score", "_relevance_score"):
        if col in want.column_names:
            np.testing.assert_allclose(np.asarray(got[col]), np.asarray(want[col]),
                                       rtol=1.3e-5, atol=1e-6)


SEARCHES = {
    "vector": lambda t: t.search(Q).nprobes(4).refine_factor(2).where("id < 900").limit(5),
    "vector_options": lambda t: t.search(Q[0]).distance_type("l2").minimum_nprobes(2)
    .maximum_nprobes(4).ef(8).distance_range(None, 1e9).limit(7),
    "postfilter": lambda t: t.search(Q[1]).nprobes(4).where("category < 5").postfilter()
    .limit(8),
    "bypass": lambda t: t.search(Q[2]).bypass_vector_index().select(["id"]).offset(2).limit(4),
    "fts": lambda t: t.search("gamma", query_type="fts").limit(6),
    "hybrid": lambda t: t.search((Q[3], "beta"), query_type="hybrid").nprobes(4).limit(5),
    "scan": lambda t: t.query().where("category = 2").select(["id", "text"]).order_by("id")
    .offset(3).limit(9),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_async_search_matches_sync_and_reference(dbs, case):
    async def body(connect):
        db = await connect()
        t = await db.open_table("t")
        return await SEARCHES[case](t).to_arrow()

    got, want = _both(dbs, body)
    if case == "scan":
        assert got.equals(want)
    else:
        _same_hits(got, want)
    assert SEARCHES[case](_sync_port(dbs)).to_arrow().equals(got)


@pytest.mark.parametrize("scan", ["all", "filtered"])
def test_async_batches_stream_like_the_sync_scan(dbs, scan):
    make = ((lambda t: t.query()) if scan == "all"
            else (lambda t: t.query().where("category < 3").offset(10).limit(300)))

    async def body(connect):
        t = await (await connect()).open_table("t")
        sizes, parts = [], []
        async for batch in make(t).to_batches(max_batch_length=100):
            sizes.append(batch.num_rows)
            parts.append(batch)
        return sizes, pa.Table.from_batches(parts)

    (sizes, got), (ref_sizes, want) = _both(dbs, body)
    assert sizes == ref_sizes and max(sizes) <= 100
    assert got.equals(want)
    assert got.equals(make(_sync_port(dbs)).to_arrow())


def test_async_stream_propagates_errors_and_stops_on_exit(dbs):
    async def body(connect):
        t = await (await connect()).open_table("t")
        with pytest.raises(TimeoutError):
            async for _ in t.query().to_batches(max_batch_length=10, timeout=0.0):
                await asyncio.sleep(0.01)
        it = t.query().to_batches(max_batch_length=10)
        async for _ in it:
            break  # the consumer leaves after one batch
        await it.aclose()  # returns once the producer has stopped
        n = 0
        async for batch in t.query():  # __aiter__
            n += batch.num_rows
        return n

    assert _both(dbs, body) == [N, N]


def test_async_table_surface_matches_reference(dbs):
    async def body(connect):
        db = await connect()
        t = await db.open_table("t")
        out = {"v0": await t.version(), "schema": (await t.schema()).names}
        out["merge"] = await t.merge_insert("id", NEW)
        out["update"] = await t.update(where="id = 5", values={"text": "zeta"})
        out["delete"] = await t.delete("id >= 1400")
        await t.add(NEW.slice(2).set_column(0, "id", pa.array([N + 5], pa.int64())))
        await t.create_scalar_index("category", index_type="BITMAP")
        await t.wait_for_index(["category_idx"], timeout=5)
        await t.prewarm_index("vector_idx")
        out["indices"] = await t.list_indices()
        out["unindexed"] = (await t.index_stats("vector_idx"))["num_unindexed_rows"]
        out["hit"] = (await t.vector_search(Q[0] + 0.001, limit=1, nprobes=4))["id"].to_pylist()
        out["query_arrow"] = (await t.query_arrow(lambda s: s.search(Q[1]).nprobes(4).limit(3))
                              )["id"].to_pylist()
        out["tokens"] = [tok.text for tok in await t.tokenize("Alpha Beta")]
        await t.tags.create("mid")
        out["tags"] = sorted(await t.tags.list())
        await t.tags.update("mid", out["v0"])
        await t.create_branch("b")
        out["branches"] = sorted(await t.branches())
        out["opt"] = await t.optimize()
        await t.drop_index("category_idx")
        out["stats_rows"] = (await t.stats())["num_rows"]
        out["count"] = await t.count_rows("category = 7")
        await t.add_columns({"c2": "category * 2"})
        await t.alter_columns({"path": "c2", "rename": "c3"})
        await t.drop_columns(["c3"])
        await t.set_unenforced_primary_key("id")
        await t.replace_field_metadata("text", {"k": "v"})
        await t.checkout("mid")
        out["at_tag"] = await t.count_rows()
        await t.checkout_latest()
        await t.restore(out["v0"])
        out["restored"] = await t.count_rows()
        out["versions"] = [v["metadata"] for v in await t.list_versions()]
        await t.tags.delete("mid")
        out["rows"] = (await t.to_arrow()).sort_by("id")
        t.close()
        out["open"] = t.is_open()
        return out

    got, want = _both(dbs, body)
    assert got.pop("rows").equals(want.pop("rows"))
    got_idx = got.pop("indices")
    assert got_idx == want.pop("indices")
    assert got == want
    assert got["hit"] == [1] and got["unindexed"] == 4 and got["restored"] == N


def test_async_connection_matches_reference(dbs):
    async def body(connect):
        db = await connect(read_consistency_interval=0)
        out = [await db.get_read_consistency_interval(), await db.table_names()]
        await db.create_table("n", TABLE.slice(0, 10))
        await db.rename_table("n", "m")
        out.append(await db.table_names())
        out.append(await (await db.open_table("m")).count_rows())
        await db.drop_table("m")
        await db.drop_table("m", ignore_missing=True)
        out.append(await db.table_names())
        await db.create_table("z", TABLE.slice(0, 3))
        await db.drop_all_tables()
        out.append(await db.table_names())
        return out

    got, want = _both(dbs, body)
    assert got == want == [0, ["t"], ["m", "t"], 10, ["t"], []]


def test_concurrent_async_searches(dbs):
    """Eight searches gathered at once on the bounded executor give the
    hits of the same searches one at a time."""
    async def body(connect):
        t = await (await connect()).open_table("t")
        make = lambda i: t.search(Q[i % NQ]).nprobes(4).where(f"category != {i}").limit(5)
        together = await asyncio.gather(*(make(i).to_arrow() for i in range(8)))
        alone = [await make(i).to_arrow() for i in range(8)]
        return together, alone

    (together, alone), (ref_together, _) = _both(dbs, body)
    for a, b, c in zip(together, alone, ref_together):
        assert a.equals(b)
        _same_hits(a, c)
    assert lancedb_tpu_torch.aio._executor()._max_workers <= 32


def test_async_table_identity_and_refusals(dbs):
    async def body(connect):
        t = await (await connect()).open_table("t")
        return (t.name, t.namespace, t.id, await t.initial_storage_options(),
                await t.latest_storage_options(), await t.migrate_manifest_paths_v2(),
                await t.uses_v2_manifest_paths())

    got, want = _both(dbs, body)
    assert got == want == ("t", [], "t", None, None, None, True)
    # the blob and LSM methods are served now: the same answers as the reference's
    async def served(connect):
        t = await (await connect()).open_table("t")
        with pytest.raises(Exception, match="not a blob column") as e:
            await t.fetch_blobs("text", [0])
        return (await t.blob_columns(), await t.get_lsm_write_spec(),
                await t.unset_lsm_write_spec(), type(e.value).__name__)

    got, want = _both(dbs, served)
    assert got == want == ([], None, None, "InvalidInputError")
