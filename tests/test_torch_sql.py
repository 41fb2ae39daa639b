"""SQL over the port (``lancedb_tpu_torch/sql.py``, ROADMAP A12b) held to
the reference (``lancedb_tpu/sql.py``): the same tables written through
each package, the same statements, the same results (``to_pydict()`` and
the schema equal: both engines run the same pyarrow kernels on the same
rows, so nothing is approximate), the same typed errors, the same EXPLAIN
text and EXPLAIN ANALYZE's operators with their row counts; then a
three-way differential (the port, the reference and sqlite3) over the
statements of ``scripts/fuzz_sql_diff.py``, with and without scalar
indexes.

The queries come from ``tests/test_sql.py`` and ``tests/test_sql_depth.py``.
The port runs on the CPU (``device="cpu"``); SQL itself is host code in
both packages.
"""

import random
import re
import sqlite3
import sys
import uuid
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu_torch
from lancedb_tpu_torch.errors import InvalidInputError, SqlParseError

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import fuzz_sql_diff  # noqa: E402


def _tables() -> dict:
    n = 100
    return {
        "sales": pa.table({
            "id": pa.array(np.arange(n, dtype=np.int64)),
            "cat": pa.array([f"c{i % 4}" for i in range(n)]),
            "qty": pa.array((np.arange(n) % 7 + 1).astype(np.int64)),
            "price": pa.array((np.arange(n) * 0.5).astype(np.float64)),
        }),
        "docs": pa.table({
            "id": pa.array([0, 1, 2, 3, 4, 5]),
            "text": pa.array(["the quick brown fox", "a quick silver car", "slow brown turtle",
                              "nothing to see", "quick quick fox jumps", "brown bears sleep"]),
        }),
        "nulls": pa.table({"g": pa.array(["a", None, "a", None, "b"]),
                           "v": pa.array([1, 2, 3, 4, 5])}),
        "orders": pa.Table.from_pylist([{"oid": i, "cust": i % 3, "amount": float(i * 10)}
                                        for i in range(9)]),
        "customers": pa.Table.from_pylist([{"cid": c, "name": f"cust{c}",
                                            "tier": "gold" if c == 0 else "basic"}
                                           for c in range(4)]),
        "regions": pa.Table.from_pylist([{"cid": c, "region": f"r{c}"} for c in range(3)]),
        "aux": pa.Table.from_pylist([{"cid": c, "name": f"aux{c}"} for c in range(3)]),
        "cats": pa.Table.from_pylist([{"cat": f"c{i}", "label": f"L{i}"} for i in range(4)]),
        "hot": pa.table({"c": pa.array(["c0", "c2"])}),
        "cold": pa.table({"c": pa.array(["c1", None])}),
        "probe1": pa.table({"v": pa.array([1, 2, 3])}),
        "emp": pa.table({"id": list(range(10)),
                         "dept": ["a", "a", "a", "b", "b", "b", "c", "c", "c", "c"],
                         "salary": [10, 20, 20, 5, 15, 25, 1, 2, 3, None]}),
        "dept": pa.table({"name": ["a", "b", "c", "d"], "budget": [100, 40, 5, 0]}),
        "g": pa.Table.from_pylist([{"a": 10, "b": 2}, {"a": 5, "b": 0}, {"a": 7, "b": None}]),
        "vec": pa.table({"id": pa.array([1, 2, 3]), "vector": pa.FixedSizeListArray.from_arrays(
            pa.array(np.arange(12, dtype=np.float32)), 4)}),
    }


def _populate(db):
    for name, data in _tables().items():
        db.create_table(name, data)
    db.open_table("docs").create_fts_index("text")
    return db


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference connection, port connection) over the same tables."""
    root = tmp_path_factory.mktemp("sql")
    ref = _populate(lancedb_tpu.connect(str(root / "ref")))
    port = _populate(lancedb_tpu_torch.connect(str(root / "port"), device="cpu"))
    return ref, port


QUERIES = [
    # projection, WHERE, ORDER BY, LIMIT
    "SELECT id, price * 2 AS dbl FROM sales WHERE id >= 90 ORDER BY id DESC LIMIT 3",
    "SELECT * FROM sales WHERE id < 5",
    "SELECT id, cat FROM sales WHERE cat = 'c2' AND qty > 3 ORDER BY id",
    "SELECT id FROM sales WHERE price BETWEEN 10 AND 12.5 ORDER BY id",
    "SELECT id FROM sales WHERE cat IN ('c1', 'c3') AND id < 20",
    "SELECT id, qty FROM sales WHERE NOT (qty > 2) ORDER BY id DESC LIMIT 7",
    "SELECT 1 AS one, 'a' || 'b' AS s",
    "SELECT id, vector FROM vec WHERE id > 1",
    # aggregates
    "SELECT cat, COUNT(*) AS n, SUM(qty) AS total, AVG(price) AS avg_p FROM sales "
    "GROUP BY cat ORDER BY cat",
    "SELECT COUNT(*) AS n, MIN(price) AS lo, MAX(price) AS hi FROM sales",
    "SELECT COUNT(DISTINCT cat) AS k FROM sales",
    "SELECT COUNT(DISTINCT qty) AS k, COUNT(qty) AS c FROM sales WHERE id > 30",
    "SELECT SUM(qty) / COUNT(*) AS q FROM sales",
    "SELECT SUM(qty) * 1.0 / COUNT(*) AS mean_qty FROM sales",
    "SELECT qty, COUNT(*) AS n, MIN(id) AS first FROM sales GROUP BY qty ORDER BY qty",
    "SELECT cat, qty, COUNT(*) AS n FROM sales GROUP BY cat, qty ORDER BY cat, qty",
    "SELECT cat, MAX(price) - MIN(price) AS spread FROM sales GROUP BY cat ORDER BY spread DESC, cat",
    "SELECT dept, stddev(salary) AS s, median(salary) AS m, string_agg(dept, '/') AS j FROM emp "
    "GROUP BY dept ORDER BY dept",
    # HAVING
    "SELECT cat, SUM(qty) AS total FROM sales WHERE id < 50 GROUP BY cat HAVING SUM(qty) > 50 "
    "ORDER BY total DESC",
    "SELECT cat, COUNT(*) AS n FROM sales GROUP BY cat HAVING n >= 25 ORDER BY cat",
    "SELECT cat, SUM(qty) AS total FROM sales GROUP BY cat HAVING total > 90 ORDER BY total DESC",
    "SELECT qty, AVG(price) AS a FROM sales GROUP BY qty HAVING COUNT(*) > 14 ORDER BY qty",
    # DISTINCT
    "SELECT DISTINCT cat FROM sales ORDER BY cat",
    "SELECT DISTINCT cat, qty FROM sales WHERE id < 30 ORDER BY cat, qty",
    # sub-selects, CTEs, correlated and scalar sub-queries
    "SELECT cat, COUNT(*) AS n FROM (SELECT cat FROM sales WHERE id < 8) GROUP BY cat ORDER BY cat",
    "SELECT * FROM (SELECT cat, COUNT(*) AS n FROM sales GROUP BY cat) WHERE n > 10 ORDER BY cat",
    "SELECT DISTINCT cat FROM sales WHERE cat IN (SELECT c FROM hot) ORDER BY cat",
    "SELECT DISTINCT cat FROM sales WHERE cat NOT IN (SELECT c FROM cold) ORDER BY cat",
    "SELECT COUNT(*) AS n FROM sales WHERE price > (SELECT AVG(price) FROM sales)",
    "SELECT COUNT(*) AS n FROM sales WHERE qty IN "
    "(SELECT qty FROM sales WHERE qty > (SELECT AVG(qty) FROM sales))",
    "SELECT COUNT(*) AS n FROM sales WHERE EXISTS (SELECT v FROM probe1 WHERE v > 0)",
    "SELECT COUNT(*) AS n FROM sales WHERE NOT EXISTS (SELECT v FROM probe1 WHERE v > 5)",
    "SELECT (SELECT MAX(id) FROM sales) AS m, id FROM sales LIMIT 2",
    "SELECT name, (SELECT max(salary) FROM emp e WHERE e.dept = d.name) AS m FROM dept d "
    "ORDER BY name",
    "SELECT name FROM dept d WHERE EXISTS (SELECT 1 FROM emp e WHERE e.dept = d.name "
    "AND e.salary > 18) ORDER BY name",
    "WITH big AS (SELECT id, qty FROM sales WHERE qty > 5) SELECT COUNT(*) AS n, SUM(qty) AS s FROM big",
    "WITH RECURSIVE t(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM t WHERE n < 5) "
    "SELECT n FROM t ORDER BY n",
    # OFFSET
    "SELECT id FROM sales ORDER BY id LIMIT 5 OFFSET 10",
    "SELECT id, price FROM sales ORDER BY price DESC, id LIMIT 4 OFFSET 95",
    # CASE and strings
    "SELECT id, CASE WHEN id >= 90 THEN 'big' WHEN id >= 50 THEN 'mid' ELSE 'small' END AS bucket "
    "FROM sales WHERE id IN (0, 60, 95) ORDER BY id",
    "SELECT CASE cat WHEN 'c0' THEN 'zero' ELSE 'rest' END AS k, COUNT(*) AS n FROM sales "
    "GROUP BY k ORDER BY k",
    "SELECT CASE WHEN b != 0 THEN a / b ELSE 0 END AS q FROM g ORDER BY q",
    "SELECT cat || '-' || CAST(id AS string) AS tag FROM sales WHERE id = 7",
    "SELECT concat(cat, ':', qty) AS t FROM sales WHERE id = 0",
    "SELECT upper(cat) AS u, length(cat) AS l FROM sales WHERE id < 3 ORDER BY id",
    # set operations
    "SELECT id FROM sales WHERE id < 2 UNION ALL SELECT id FROM sales WHERE id < 1",
    "SELECT cat FROM sales UNION SELECT cat FROM sales ORDER BY cat LIMIT 3",
    "SELECT id FROM sales WHERE id < 3 UNION ALL SELECT id FROM sales WHERE id < 2 "
    "ORDER BY id + 0 DESC LIMIT 3",
    "SELECT qty FROM sales WHERE id < 20 INTERSECT SELECT qty FROM sales WHERE id > 90",
    "SELECT qty FROM sales WHERE id < 20 EXCEPT SELECT qty FROM sales WHERE id > 95",
    # NULLs in groups, filters and order
    "SELECT g, SUM(v) AS s, COUNT(*) AS n FROM nulls GROUP BY g",
    "SELECT g, COUNT(g) AS c, COUNT(*) AS n, MAX(v) AS m FROM nulls GROUP BY g ORDER BY g NULLS FIRST",
    "SELECT v FROM nulls WHERE g IS NULL ORDER BY v",
    "SELECT coalesce(g, 'none') AS g2, v FROM nulls ORDER BY v DESC",
    "SELECT salary FROM emp ORDER BY salary DESC NULLS LAST, id",
    # joins
    "SELECT o.oid, c.name, o.amount FROM orders o JOIN customers c ON o.cust = c.cid "
    "WHERE o.amount > 20 ORDER BY o.oid",
    "SELECT c.tier, SUM(o.amount) AS total FROM orders o LEFT JOIN customers c ON o.cust = c.cid "
    "GROUP BY c.tier ORDER BY total DESC",
    "SELECT o.oid, c.name, r.region FROM orders o JOIN customers c ON o.cust = c.cid "
    "JOIN regions r ON o.cust = r.cid ORDER BY o.oid LIMIT 3",
    "SELECT c.name, a.name FROM customers c JOIN aux a ON c.cid = a.cid ORDER BY c.cid",
    "SELECT o.oid, big.name FROM orders o JOIN (SELECT cid, name FROM customers WHERE cid < 2) "
    "AS big ON o.cust = big.cid ORDER BY o.oid",
    "SELECT s.id, c.label FROM sales s JOIN cats c ON s.cat = c.cat WHERE s.qty > 3 "
    "ORDER BY s.id LIMIT 5",
    "SELECT c.cid, COUNT(o.oid) AS n FROM customers c LEFT JOIN orders o ON c.cid = o.cust "
    "GROUP BY c.cid ORDER BY c.cid",
    "SELECT o.oid, c.name FROM orders o RIGHT JOIN customers c ON o.cust = c.cid "
    "ORDER BY o.oid",
    # windows
    "SELECT id, row_number() OVER (PARTITION BY cat ORDER BY id) AS rn FROM sales WHERE id < 12",
    "SELECT id, sum(qty) OVER (PARTITION BY cat ORDER BY id ROWS BETWEEN 2 PRECEDING AND "
    "CURRENT ROW) AS s FROM sales WHERE id < 20",
    "SELECT id, rank() OVER (PARTITION BY dept ORDER BY salary) AS r, lag(salary) OVER "
    "(PARTITION BY dept ORDER BY id) AS lg FROM emp ORDER BY id",
    # full text through fts(table, query [, k])
    "SELECT id, _score FROM fts(docs, 'quick') ORDER BY _score DESC",
    "SELECT COUNT(*) AS n FROM fts(docs, 'brown')",
    "SELECT id FROM fts(docs, 'quick', 1)",
    'SELECT id FROM fts(docs, \'{"match": {"query": "quick brown", "operator": "AND"}}\')',
    "SELECT id, _score FROM fts(docs, 'quick fox') WHERE id > 0",
    "SELECT * FROM fts(docs, 'fox') LIMIT 2",
]

ERRORS = [
    "SELEC id FROM sales",
    "SELECT id FROM sales GROUP id",
    "SELECT price, SUM(qty) FROM sales GROUP BY cat",
    "SELECT id FROM sales trailing junk ,",
    "SELECT id FROM sales UNION ALL SELECT id, cat FROM sales",
    "SELECT id FROM sales WHERE id > (SELECT id FROM sales)",
    "SELECT id FROM sales WHERE id IN (SELECT id, qty FROM sales)",
    "SELECT * FROM orders o JOIN customers c ON o.cust > c.cid",
    "SELECT 1 + 2 || 'z' AS v FROM probe1",
    "SELECT id FROM emp WHERE row_number() OVER (ORDER BY id) < 3",
    "SELECT string_agg(dept) FROM emp",
    "SELECT id FROM fts(sales, 'x')",
    # pyarrow's hash join takes no fixed-size-list column (ROADMAP §C)
    "SELECT COUNT(*) AS n FROM vec JOIN probe1 ON vec.id = probe1.v",
]


def _rows(t: pa.Table) -> list[str]:
    return sorted(map(repr, zip(*(t.column(i).to_pylist() for i in range(t.num_columns)))))


def _same_table(got: pa.Table, want: pa.Table, ordered: bool = True) -> None:
    """The same schema and rows; in the same order where the statement
    fixes one (pyarrow's hash joins and set operations emit rows in an order
    of their own otherwise)."""
    assert got.schema == want.schema
    if ordered:
        assert got.to_pydict() == want.to_pydict()
    else:
        assert _rows(got) == _rows(want)


@pytest.mark.parametrize("query", QUERIES)
def test_sql_matches_reference(pair, query):
    ref, port = pair
    _same_table(port.sql(query), ref.sql(query), ordered="ORDER BY" in query)


@pytest.mark.parametrize("query", ERRORS)
def test_sql_errors_match_reference(pair, query):
    """The same inputs raise the same typed error with the same message."""
    ref, port = pair
    with pytest.raises(Exception) as want:
        ref.sql(query)
    with pytest.raises(Exception) as got:
        port.sql(query)
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__module__.replace("lancedb_tpu_torch", "lancedb_tpu") == \
        type(want.value).__module__
    assert str(got.value) == str(want.value)


def test_sql_typed_errors_are_the_ports():
    """The port's SQL raises the port's exception classes."""
    db = lancedb_tpu_torch.connect(f"memory://sql-{uuid.uuid4().hex}", device="cpu")
    with pytest.raises(SqlParseError):
        db.sql("SELEC 1")
    db.create_table("t", pa.table({"a": [1, 2]}))
    with pytest.raises(InvalidInputError, match="GROUP BY"):
        db.sql("SELECT a, SUM(a) FROM t GROUP BY 1 + 1")


def _spy(monkeypatch, module):
    calls = []
    orig = module.try_scalar_prefilter

    def spy(table, ast):
        out = orig(table, ast)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(module, "try_scalar_prefilter", spy)
    return calls


def test_where_pushdown_and_scalar_index(tmp_path, monkeypatch):
    """tests/test_sql.py:186 in both packages, with a spy on each one's
    try_scalar_prefilter: a WHERE over a base table filters in the scan in
    both (the spy sees no call), and gives the same rows with a BTREE and a
    BITMAP index as without; fts()'s WHERE takes the port's scalar-index
    prefilter, which the index serves, where the reference scans, with the
    same hits."""
    from lancedb_tpu.index import scalar as ref_scalar
    from lancedb_tpu_torch.index import scalar as port_scalar

    ref = _populate(lancedb_tpu.connect(str(tmp_path / "ref")))
    port = _populate(lancedb_tpu_torch.connect(str(tmp_path / "port"), device="cpu"))
    queries = ["SELECT COUNT(*) AS n FROM sales WHERE id BETWEEN 10 AND 19",
               "SELECT id, qty FROM sales WHERE cat = 'c3' AND id < 40 ORDER BY id",
               "SELECT cat, COUNT(*) AS n FROM sales WHERE cat IN ('c1', 'c2') GROUP BY cat "
               "ORDER BY cat"]
    before = [port.sql(q) for q in queries]
    for db in (ref, port):
        db.open_table("sales").create_scalar_index("id", index_type="BTREE")
        db.open_table("sales").create_scalar_index("cat", index_type="BITMAP")
        db.open_table("docs").create_scalar_index("id", index_type="BTREE")
    ref_calls, port_calls = _spy(monkeypatch, ref_scalar), _spy(monkeypatch, port_scalar)
    assert port.sql(queries[0]).column("n").to_pylist() == [10]
    for q, b in zip(queries, before):
        _same_table(port.sql(q), ref.sql(q))
        _same_table(port.sql(q), b)
    assert ref_calls == [] and port_calls == []
    q = "SELECT id, _score FROM fts(docs, 'quick brown') WHERE id < 4"
    _same_table(port.sql(q), ref.sql(q))
    assert ref_calls == [] and port_calls == [True]


def _explain_ops(plan: str) -> list[tuple[str, str | None]]:
    """Each plan line's operator and its output_rows, without times."""
    out = []
    for line in plan.splitlines():
        rows = re.search(r"output_rows=(\d+)", line)
        out.append((re.sub(r",? ?metrics=\[.*\]|elapsed=[\d.]+ms", "", line).rstrip(),
                    rows.group(1) if rows else None))
    return out


EXPLAINED = [
    "SELECT cat, SUM(qty) AS total FROM sales WHERE id > 10 GROUP BY cat HAVING SUM(qty) > 1 "
    "ORDER BY total DESC LIMIT 3",
    "SELECT cat, COUNT(*) AS n FROM sales GROUP BY cat ORDER BY n DESC",
    "SELECT s.id, c.label FROM sales s JOIN cats c ON s.cat = c.cat WHERE s.qty > 3 "
    "ORDER BY s.id LIMIT 5",
    "SELECT * FROM (SELECT cat, COUNT(*) AS n FROM sales GROUP BY cat) WHERE n > 10",
    "SELECT id FROM sales WHERE id < 2 UNION ALL SELECT id FROM sales",
    "SELECT * FROM fts(docs, 'fox') LIMIT 2",
    "WITH x AS (SELECT id FROM emp WHERE salary > 10) SELECT COUNT(*) AS n FROM x",
    "SELECT DISTINCT dept, count(*) OVER (PARTITION BY dept) AS n FROM emp ORDER BY dept",
]


@pytest.mark.parametrize("query", EXPLAINED)
def test_explain_matches_reference(pair, query):
    """EXPLAIN's (plan_type, plan) table equal; EXPLAIN ANALYZE's operators
    and row counts equal, each line without its times."""
    ref, port = pair
    _same_table(port.sql("EXPLAIN " + query), ref.sql("EXPLAIN " + query))
    got, want = port.sql("EXPLAIN ANALYZE " + query), ref.sql("EXPLAIN ANALYZE " + query)
    assert got.column("plan_type").to_pylist() == want.column("plan_type").to_pylist()
    got_ops = _explain_ops(got.column("plan")[0].as_py())
    assert got_ops == _explain_ops(want.column("plan")[0].as_py())
    assert any(rows is not None for _, rows in got_ops)  # metrics were recorded


def test_explain_analyze_counts_the_scan(pair):
    ref, port = pair
    plan = port.sql("EXPLAIN ANALYZE SELECT COUNT(*) AS n FROM sales WHERE qty > 3").column(
        "plan")[0].as_py()
    assert "ScanExec: table=sales" in plan and "output_rows=56" in plan
    assert "total: rows=1" in plan


# ------------------------------------------------- three-way differential


def _three_way(seed: int, n: int, indexes: bool, tmp_path) -> int:
    """n statements of fuzz_sql_diff's grammar, drawn from one
    random.Random(seed) after its tables (as fuzz_sql_diff.setup draws
    them), through the port, the reference and sqlite3. Returns the
    number of statements sqlite3 accepted."""
    rng = random.Random(seed)
    t1, t2 = fuzz_sql_diff.make_tables(rng)
    dbs = [lancedb_tpu.connect(str(tmp_path / "ref")),
           lancedb_tpu_torch.connect(str(tmp_path / "port"), device="cpu")]
    for db in dbs:
        tb1 = db.create_table("t1", pa.table({k: pa.array(v) for k, v in t1.items()}))
        db.create_table("t2", pa.table({k: pa.array(v) for k, v in t2.items()}))
        if indexes:
            tb1.create_scalar_index("id", index_type="BTREE")
            tb1.create_scalar_index("a", index_type="BTREE")
            tb1.create_scalar_index("b", index_type="BITMAP")
            tb1.create_scalar_index("s", index_type="BITMAP")
    con = sqlite3.connect(":memory:")
    cur = con.cursor()
    cur.execute("CREATE TABLE t1 (id INTEGER, a INTEGER, b INTEGER, c REAL, s TEXT)")
    cur.execute("CREATE TABLE t2 (a INTEGER, d INTEGER)")
    cur.executemany("INSERT INTO t1 VALUES (?,?,?,?,?)",
                    list(zip(*[t1[k] for k in ("id", "a", "b", "c", "s")])))
    cur.executemany("INSERT INTO t2 VALUES (?,?)", list(zip(t2["a"], t2["d"])))
    gen = fuzz_sql_diff.Gen(rng)
    ref, port = dbs
    accepted = 0
    for _ in range(n):
        sql = gen.statement()
        try:
            theirs = fuzz_sql_diff.run_sqlite(cur, sql)
        except sqlite3.Error:  # outside the shared dialect: the grammar's miss
            continue
        accepted += 1
        _same_table(port.sql(sql), ref.sql(sql), ordered=fuzz_sql_diff.ordered_prefix(sql))
        assert fuzz_sql_diff.compare(sql, fuzz_sql_diff.run_ours(port, sql), theirs) is None, sql
    con.close()
    return accepted


@pytest.mark.parametrize("seed,indexes", [(1, False), (2, False), (12, True), (13, True)],
                         ids=["seed1", "seed2", "seed12-indexed", "seed13-indexed"])
def test_differential_port_reference_sqlite(seed, indexes, tmp_path):
    assert _three_way(seed, 60, indexes, tmp_path) >= 50
