"""Bounded-memory SQL in the port (``lancedb_tpu_torch/sql_spill.py``) held
to the reference (``lancedb_tpu/sql_spill.py``): the spilling GROUP BY and
the Grace hash join called directly on the same batches give the same
tables and spill statistics, and SQL statements give the same results at
the default budget and at a 200,000-byte budget that forces both spill
paths on 20,000 rows, in each package and across them.

Under a budget the aggregates sum each partition apart, and pyarrow's
threaded aggregation sums in an order of its own from run to run, so a
spilled float sum may differ from another run's in its last bits (rtol
1e-9, as tests/test_sql_spill.py allows); every other value and the
spill statistics are equal exactly. pyarrow's threaded group_by and join
also emit rows in an order of their own, so the functions' outputs are
compared sorted; a statement's rows follow its ORDER BY.
"""

import uuid

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.sql_spill as ref_spill
import lancedb_tpu_torch
import lancedb_tpu_torch.sql_spill as port_spill
from lancedb_tpu_torch.errors import InvalidInputError

BUDGET = 200_000
ROWS = 20_000


def _populate(db):
    rng = np.random.default_rng(0)
    db.create_table("big", {
        "id": np.arange(ROWS),
        "grp": (np.arange(ROWS) * 2654435761 % 97).astype(np.int64),
        "val": rng.standard_normal(ROWS),
        "cat": [f"c{i % 13}" for i in range(ROWS)],
    })
    db.create_table("dims", {"g": np.arange(90, dtype=np.int64), "w": rng.standard_normal(90)})
    return db


@pytest.fixture(scope="module")
def pair():
    ref = _populate(lancedb_tpu.connect(f"memory://spill-{uuid.uuid4().hex}"))
    port = _populate(lancedb_tpu_torch.connect(f"memory://spill-{uuid.uuid4().hex}",
                                               device="cpu"))
    yield ref, port
    ref_spill.set_sql_memory_budget(None)
    port_spill.set_sql_memory_budget(None)


QUERIES = [
    ("SELECT grp, count(*) n, sum(val) s, avg(val) a, count(DISTINCT cat) cd "
     "FROM big GROUP BY grp ORDER BY grp", "group_by"),
    ("SELECT cat, count(*) n, min(val) mn, max(id) mx FROM big WHERE id < 15000 GROUP BY cat "
     "ORDER BY cat", "group_by"),
    ("SELECT grp, min(cat) mc, max(cat) xc FROM big WHERE grp < 10 "
     "GROUP BY grp HAVING count(*) > 100 ORDER BY grp", "group_by"),
    ("SELECT grp, count(*) c, rank() OVER (ORDER BY count(*) DESC) r "
     "FROM big GROUP BY grp ORDER BY grp LIMIT 5", "group_by"),
    ("SELECT b.grp, count(*) n, sum(b.val * d.w) sw FROM big b "
     "JOIN dims d ON b.grp = d.g GROUP BY b.grp ORDER BY b.grp", "join"),
    ("SELECT count(*) n FROM (SELECT b.id x FROM big b "
     "LEFT OUTER JOIN dims d ON b.grp = d.g WHERE d.w IS NULL) q", "join"),
    ("SELECT b.id, d.w FROM big b JOIN dims d ON b.grp = d.g WHERE b.id < 300 ORDER BY b.id",
     "join"),
]


def _close(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        if want[k] and isinstance(want[k][0], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9)
        else:
            assert got[k] == want[k]


@pytest.mark.parametrize("query,path", QUERIES)
def test_budget_invariance_matches_reference(pair, monkeypatch, query, path):
    ref, port = pair
    fn = f"spilled_{path}"
    calls = []
    orig = getattr(port_spill, fn)

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(port_spill, fn, counted)
    plain = port.sql(query)
    _close(plain.to_pydict(), ref.sql(query).to_pydict())
    assert calls == []  # no budget: no spill
    for spill in (ref_spill, port_spill):
        spill.set_sql_memory_budget(BUDGET)
    try:
        assert port_spill.sql_memory_budget() == BUDGET
        spilled = port.sql(query)
        ref_spilled = ref.sql(query)
    finally:
        for spill in (ref_spill, port_spill):
            spill.set_sql_memory_budget(None)
    assert calls  # the budget took the spill path
    assert spilled.schema == plain.schema == ref_spilled.schema
    _close(spilled.to_pydict(), plain.to_pydict())
    _close(spilled.to_pydict(), ref_spilled.to_pydict())


def _rows(t: pa.Table) -> list[str]:
    return sorted(map(repr, zip(*(t.column(i).to_pylist() for i in range(t.num_columns)))))


def _batches(n, seed, batch_rows=2_000):
    rng = np.random.default_rng(seed)
    key = ((np.arange(n, dtype=np.uint64) * np.uint64(11400714819323198485))
           % np.uint64(211)).astype(np.int64)
    tbl = pa.table({"k": key, "v": rng.standard_normal(n), "s": [f"s{i % 17}" for i in range(n)]})
    return tbl.to_batches(max_chunksize=batch_rows), tbl


@pytest.mark.parametrize("keys", [["k"], ["k", "s"]], ids=["int-key", "two-keys"])
def test_spilled_group_by_matches_reference(tmp_path, keys):
    batches, tbl = _batches(ROWS, 3)
    aggs = [("v", "sum"), ([], "count_all"), ("v", "mean"), ("s", "count_distinct")]
    stats = {pkg: {} for pkg in ("ref", "port")}
    for pkg in stats:
        (tmp_path / pkg).mkdir()
    outs = {
        pkg: mod.spilled_group_by(batches, keys, aggs, BUDGET, tmp_dir=str(tmp_path / pkg),
                                  stats=stats[pkg])
        for pkg, mod in (("ref", ref_spill), ("port", port_spill))
    }
    order = [(k, "ascending") for k in keys]
    got = outs["port"].sort_by(order)
    _close(got.to_pydict(), outs["ref"].sort_by(order).to_pydict())
    assert stats["port"] == stats["ref"] and stats["port"]["partitions"] > 1
    want = tbl.group_by(keys).aggregate(aggs).sort_by(order)
    _close(got.to_pydict(), want.select(got.column_names).to_pydict())


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer"])
def test_spilled_join_matches_reference(tmp_path, join_type):
    (lb, lt), (rb, rt) = _batches(ROWS, 1), _batches(400, 2)
    stats = {pkg: {} for pkg in ("ref", "port")}
    for pkg in stats:
        (tmp_path / pkg).mkdir()
    outs = {
        pkg: pa.concat_tables(list(mod.spilled_join(
            lb, rb, ["k"], ["k"], join_type, BUDGET, right_suffix="_r",
            tmp_dir=str(tmp_path / pkg), stats=stats[pkg])))
        for pkg, mod in (("ref", ref_spill), ("port", port_spill))
    }
    assert outs["port"].schema == outs["ref"].schema
    assert _rows(outs["port"]) == _rows(outs["ref"])
    assert stats["port"] == stats["ref"] and stats["port"]["partitions"] > 1
    want = lt.join(rt, keys=["k"], join_type=join_type, right_suffix="_r")
    assert _rows(outs["port"]) == _rows(want.select(outs["port"].column_names))


def test_budget_api():
    for value in (0, -5):
        with pytest.raises(InvalidInputError):
            lancedb_tpu_torch.set_sql_memory_budget(value)
    assert lancedb_tpu_torch.sql_memory_budget() is None
    lancedb_tpu_torch.set_sql_memory_budget(1 << 20)
    try:
        assert port_spill.sql_memory_budget() == 1 << 20
        assert ref_spill.sql_memory_budget() is None  # the packages keep their own
    finally:
        lancedb_tpu_torch.set_sql_memory_budget(None)
