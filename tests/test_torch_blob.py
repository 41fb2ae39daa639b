"""Blob columns: lancedb_tpu_torch (device="cpu") against lancedb_tpu,
mirroring tests/test_blob.py.

Payloads go to ``_blobs/<uuid>.bin`` and each fragment stores a {file,
position, size} descriptor, in the same layout in both packages, so each
reads the other's blobs: a table written by one package (on disk) is
read by both, and each package's own in-memory table must give the same
bytes. Compaction moves descriptors, never payloads.
"""

import asyncio
import io
import uuid

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.blob as ref_blob
import lancedb_tpu_torch
import lancedb_tpu_torch.blob as port_blob
from lancedb_tpu_torch.errors import InvalidInputError

PKGS = ("port", "ref")
BLOB = {"port": port_blob, "ref": ref_blob}
PAYLOADS = [b"hello world", b"\x00\x01\x02" * 1000, None, b"last blob"]


def _connect(pkg, uri):
    if pkg == "port":
        return lancedb_tpu_torch.connect(str(uri), device="cpu")
    return lancedb_tpu.connect(str(uri))


def _schema(pkg, *extra):
    return pa.schema([pa.field("id", pa.int64()), *extra, BLOB[pkg].blob_field("media")])


@pytest.fixture(params=["port writes", "ref writes", "memory"])
def tables(request, tmp_path):
    """{pkg: table}: on disk, written by one package and opened by both;
    in memory, each package's own table of the same rows."""
    rows = [{"id": i, "media": p} for i, p in enumerate(PAYLOADS)]
    if request.param == "memory":
        out = {}
        for pkg in PKGS:
            t = _connect(pkg, f"memory://{uuid.uuid4().hex}").create_table("b",
                                                                          schema=_schema(pkg))
            t.add(rows)
            out[pkg] = t
        return out
    writer = request.param.split()[0]
    _connect(writer, tmp_path / "db").create_table("b", schema=_schema(writer)).add(rows)
    return {pkg: _connect(pkg, tmp_path / "db").open_table("b") for pkg in PKGS}


def _rowids(t, where=None):
    q = t.query().with_row_id(True)
    return (q.where(where) if where else q).to_arrow().column("_rowid").to_pylist()


def test_schema_is_descriptor(tables):
    f = tables["port"].schema.field("media")
    assert port_blob.is_blob_field(f) and pa.types.is_struct(f.type)
    assert tables["port"].schema.equals(tables["ref"].schema, check_metadata=True)
    assert tables["port"].blob_columns == tables["ref"].blob_columns == ["media"]


def test_scan_returns_descriptors(tables):
    got, want = (tables[p].to_arrow().column("media").to_pylist() for p in PKGS)
    assert got[0]["size"] == len(PAYLOADS[0])
    assert got[2] is None or got[2]["file"] is None
    strip = lambda ds: [None if d is None else (d["position"], d["size"]) for d in ds]  # noqa: E731
    assert strip(got) == strip(want)
    assert all(d is None or d["file"] is None or d["file"].startswith("_blobs/") for d in got)


def test_fetch_blobs(tables):
    for pkg in PKGS:
        t = tables[pkg]
        assert t.fetch_blobs("media", _rowids(t)) == PAYLOADS


def test_blob_file_seek_read(tables):
    for pkg in PKGS:
        bf = tables[pkg].fetch_blob_files("media", [_rowids(tables[pkg])[0]])[0]
        assert bf.size() == len(bf) == len(PAYLOADS[0])
        assert bf.read(5) == b"hello" and bf.tell() == 5
        bf.seek(6)
        assert bf.read() == b"world"
        bf.seek(-5, io.SEEK_END)
        assert bf.read() == b"world"
        bf.seek(-3, io.SEEK_CUR)
        assert bf.read(2) == b"rl"
        assert bf.read_range(0, 100) == PAYLOADS[0]
        with bf:
            pass
        assert bf.closed
        with pytest.raises(ValueError):
            bf.read()
    assert tables["port"].fetch_blob_files("media", [_rowids(tables["port"])[2]]) == [None]


def test_fetch_blob_ranges(tables):
    for pkg in PKGS:
        rids = _rowids(tables[pkg])
        parts = tables[pkg].fetch_blob_ranges("media", [rids[0], rids[3], rids[2]],
                                              [(0, 5), (5, 4), (0, 1)])
        assert parts == [b"hello", b"blob", None]


def test_appends_go_to_separate_files(tables, tmp_path):
    """Each package appends to its table (on disk, to the one table);
    every payload reads back in both, each append in a file of its own."""
    for i, pkg in enumerate(PKGS):
        tables[pkg].add([{"id": 10 + i, "media": f"batch from {pkg}".encode()}])
    if (tmp_path / "db").exists():  # fresh handles see both appends
        tables = {pkg: _connect(pkg, tmp_path / "db").open_table("b") for pkg in PKGS}
    for pkg in PKGS:
        t = tables[pkg]
        files = {d["file"] for d in t.to_arrow().column("media").to_pylist()
                 if d is not None and d["file"] is not None}
        writers = [w for w in PKGS if t.count_rows(f"id = {10 + PKGS.index(w)}")]
        assert len(files) == 1 + len(writers) and (pkg in writers)
        for w in writers:
            got = t.fetch_blobs("media", _rowids(t, f"id = {10 + PKGS.index(w)}"))
            assert got == [f"batch from {w}".encode()]


def test_non_blob_column_rejected(tables):
    with pytest.raises(InvalidInputError):
        tables["port"].fetch_blobs("id", [0])
    with pytest.raises(ref_blob.InvalidInputError):
        tables["ref"].fetch_blobs("id", [0])


def test_invalid_ranges_rejected(tables):
    for pkg in PKGS:
        t = tables[pkg]
        rid = _rowids(t)[0]
        with pytest.raises(Exception, match="non-negative") as e:
            t.fetch_blob_ranges("media", [rid], [(-1, 2)])
        assert type(e.value).__name__ == "InvalidInputError"
        with pytest.raises(Exception, match="ranges"):
            t.fetch_blob_ranges("media", [rid], [(0, 1), (1, 1)])
        assert t.fetch_blob_ranges("media", [rid], [(1, 3)]) == [b"ell"]


@pytest.mark.parametrize("writer", PKGS)
def test_search_with_blob_table(tmp_path, writer):
    t = _connect(writer, tmp_path / "db").create_table(
        "bv", schema=_schema(writer, pa.field("vector", pa.list_(pa.float32(), 4))))
    t.add([{"id": i, "vector": [float(i)] * 4, "media": f"blob-{i}".encode()}
           for i in range(10)])
    outs = {}
    for pkg in PKGS:
        t = _connect(pkg, tmp_path / "db").open_table("bv")
        res = t.search(np.full(4, 2.2, np.float32)).limit(3).with_row_id(True).to_arrow()
        outs[pkg] = (res["id"].to_pylist(), t.fetch_blobs("media", res["_rowid"].to_pylist()))
    assert outs["port"] == outs["ref"]
    assert outs["port"][1] == [b"blob-2", b"blob-3", b"blob-1"]


def test_create_table_with_blob_data_and_compaction(tmp_path):
    """Payloads written at create_table, then appends, then compaction
    (the descriptors move into one fragment, the payloads stay): every
    payload reads back in both packages."""
    rng = np.random.default_rng(3)
    payloads = [rng.bytes(int(n)) for n in rng.integers(1, 4096, 12)]
    data = pa.table({"id": pa.array(range(4), pa.int64()),
                     "media": pa.array(payloads[:4], pa.large_binary())},
                    schema=_schema("port"))
    t = _connect("port", tmp_path / "db").create_table("c", data)
    for s in (4, 8):
        t.add([{"id": i, "media": payloads[i]} for i in range(s, s + 4)])
    t.delete("id = 5")
    assert len(t._dataset.manifest.fragments) == 3
    assert t.compact_files()["fragments_removed"] == 3
    assert len(t._dataset.manifest.fragments) == 1
    want = [p for i, p in enumerate(payloads) if i != 5]
    for pkg in PKGS:
        t2 = _connect(pkg, tmp_path / "db").open_table("c")
        rows = t2.query().with_row_id(True).to_arrow().sort_by("id")
        assert t2.fetch_blobs("media", rows["_rowid"].to_pylist()) == want
    t.optimize()
    assert t.fetch_blobs("media", _rowids(t, "id < 2")) == payloads[:2]


def test_async_blob_surface(tmp_path):
    payloads = [b"a" * 64, b"b" * 64, None]
    out = {}

    async def main(pkg):
        if pkg == "port":
            db = await lancedb_tpu_torch.connect_async(str(tmp_path / pkg), device="cpu")
        else:
            db = await lancedb_tpu.connect_async(str(tmp_path / pkg))
        data = pa.table({"id": pa.array([0, 1, 2], pa.int64()),
                         "doc": pa.array(payloads, pa.large_binary())},
                        schema=pa.schema([pa.field("id", pa.int64()),
                                          BLOB[pkg].blob_field("doc")]))
        t = await db.create_table("t", data)
        files = await t.fetch_blob_files("doc", [0])
        return (await t.blob_columns(), await t.fetch_blobs("doc", [0, 2]),
                await t.fetch_blob_ranges("doc", [1], [(8, 16)]), files[0].read(4))

    for pkg in PKGS:
        out[pkg] = asyncio.run(asyncio.wait_for(main(pkg), timeout=60))
    assert out["port"] == out["ref"]
    assert out["port"] == (["doc"], [payloads[0], None], [payloads[1][8:24]], b"aaaa")


def test_a_table_without_blobs(tmp_path):
    t = _connect("port", tmp_path / "db").create_table("t", [{"id": 0, "x": 1.0}])
    assert t.blob_columns == []
    with pytest.raises(InvalidInputError, match="not a blob column"):
        t.fetch_blob_files("x", [0])
