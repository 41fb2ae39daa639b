"""The port's spans and counters (``lancedb_tpu_torch.metrics``): the span
trees of a refined, prefiltered IVF_PQ search and of an index build, when
spans are kept, the counters a call adds, the analyze runs that the spans
time, and the benchmark's readers of spans and counters on hand-built
records (tiny sizes, CPU)."""

import collections
import gc
import threading
import uuid

import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu_torch
from lancedb_tpu_torch import metrics
from lancedb_tpu_torch.index.vector import _to_device
from portbench import spec
from portbench.trace import DeviceEvent, Trace

N, D, NQ = 2000, 16, 6
SEARCH_CHILDREN = {"query.plan", "prefilter.allowed_rowids", "searcher.slot_penalty",
                   "searcher.search", "query.hydrate", "query.finish"}
BUILD_CHILDREN = {"build.upload", "build.sample", "build.kmeans", "build.layout", "build.pq",
                  "build.write", "table.commit"}


def _rows() -> tuple[pa.Table, np.ndarray]:
    x = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)
    ids = np.arange(N)
    return pa.table({"id": ids, "category": ids % 10,
                     "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), D)}), x


def _table():
    rows, x = _rows()
    db = lancedb_tpu_torch.connect(f"memory://tracing-{uuid.uuid4().hex}", device="cpu")
    return db.create_table("t", rows), x


def _build(tbl) -> None:
    tbl.create_index(metric="l2", num_partitions=8, num_sub_vectors=4, num_bits=8,
                     max_iterations=4, sample_rate=64)


def _search(tbl, q):
    return (tbl.search(q).nprobes(4).refine_factor(4).limit(5)
            .where("category = 3", prefilter=True).to_arrow())


@pytest.fixture
def indexed():
    tbl, x = _table()
    _build(tbl)
    metrics.span_records(clear=True)
    return tbl, x


def _tree(recs, root_name):
    roots = [r for r in recs if r.name == root_name]
    assert len(roots) == 1
    root = roots[0]
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.request == root.id  # one request id a call
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1  # each child inside its parent
            assert r.thread == p.thread
    return root, {r.name for r in recs if r.parent == root.id}


def test_search_span_tree(indexed):
    tbl, x = indexed
    with metrics.tracing():
        out = _search(tbl, x[:NQ])
    recs = metrics.span_records(clear=True)
    root, children = _tree([r for r in recs if r.name != "gc"], "query.vector")
    assert root.parent is None and children == SEARCH_CHILDREN
    hydrate = [r for r in recs if r.name == "query.hydrate"]
    takes = [r for r in recs if r.name == "dataset.take_rows"]
    assert len(hydrate) == 1 and len(takes) == 1  # one take over every query's rows
    assert hydrate[0].attrs["queries"] == NQ
    assert all(r.parent == hydrate[0].id for r in takes)
    assert all(r.attrs["path"] in ("resident", "fragments") for r in takes)
    assert all(r.attrs["fragments"] == 1 for r in takes if r.attrs["path"] == "fragments")
    assert hydrate[0].attrs["rows"] == out.num_rows
    assert [r.attrs["rows"] for r in recs if r.name == "prefilter.allowed_rowids"] == [N // 10]


def test_build_span_tree():
    tbl, _ = _table()
    metrics.span_records(clear=True)
    with metrics.tracing():
        _build(tbl)
    recs = [r for r in metrics.span_records(clear=True) if r.name != "gc"]
    root, children = _tree(recs, "index.build")
    assert children == BUILD_CHILDREN
    names = [r.name for r in sorted(recs, key=lambda r: r.t0) if r.parent == root.id]
    assert names.index("build.upload") < names.index("build.kmeans") < names.index("build.pq")
    assert names[-1] == "table.commit"



HYBRID_WORDS = [f"w{i}" for i in range(40)] + ["the", "of", "and"]


@pytest.fixture(scope="module")
def hybrid_table():
    """A table with a passage a row, its vector index and its full-text index."""
    rows, x = _rows()
    rng = np.random.default_rng(5)
    passages = [" ".join(rng.choice(HYBRID_WORDS, 12)) for _ in range(N)]
    rows = rows.add_column(2, "text", pa.array(passages))
    db = lancedb_tpu_torch.connect(f"memory://tracing-{uuid.uuid4().hex}", device="cpu")
    tbl = db.create_table("t", rows)
    _build(tbl)
    tbl.create_fts_index("text")
    texts = [f"w{i} w{i + 7} the w{i}" for i in range(8)]
    return tbl, x, texts


def _hybrid(tbl, x, texts):
    b = tbl.search((x[0], texts[0]), query_type="hybrid")
    for v, t in zip(x[1:len(texts)], texts[1:]):
        b = b.add_query(v, t)
    return b.nprobes(4).refine_factor(4).limit(5).to_arrow()


def _summed_df(tbl, texts) -> int:
    meta = next(ix for ix in tbl._dataset.manifest.indices if ix.index_type == "FTS")
    col = tbl._get_fts_index(meta)._col("text")
    total = 0
    for t in texts:
        tids = {col.vocab[w] for w in col.tokenizer.tokenize(t) if w in col.vocab}
        total += int(sum(col.df[i] for i in tids))
    return total


@pytest.mark.parametrize("pairs", [8, 1], ids=["batched", "single"])
def test_hybrid_span_tree(hybrid_table, pairs):
    tbl, x, texts = hybrid_table
    texts = texts[:pairs]
    metrics.span_records(clear=True)
    before = {n: metrics.counter_totals[n] for n in ("lancedb.fts.queries",
                                                     "lancedb.fts.postings")}
    with metrics.tracing():
        out = _hybrid(tbl, x, texts)
    recs = [r for r in metrics.span_records(clear=True) if r.name != "gc"]
    root = next(r for r in recs if r.name == "query.hybrid")
    assert root.parent is None and root.attrs["queries"] == pairs
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.request == root.id  # one request id a call, whichever thread
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1
    children = collections.Counter(r.name for r in recs if r.parent == root.id)
    assert children == {"query.vector": 1, "hybrid.fts_leg": pairs, "hybrid.fts_wait": 1,
                        "hybrid.fuse": 1}
    legs = [r for r in recs if r.name == "hybrid.fts_leg"]
    assert all(r.thread != root.thread for r in legs)  # the legs run on the pool's threads
    for leg in legs:
        under = collections.Counter(r.name for r in recs if r.parent == leg.id)
        assert under == {"fts.score": 1, "dataset.take_rows": 1}
    assert {r.attrs["path"] for r in recs if r.name == "fts.score"} == {"evaluate"}
    vector = next(r for r in recs if r.name == "query.vector")
    assert {r.name for r in recs if r.parent == vector.id} >= {"searcher.search",
                                                               "query.hydrate"}
    assert out.num_rows > 0
    assert metrics.counter_totals["lancedb.fts.queries"] - before["lancedb.fts.queries"] == pairs
    assert (metrics.counter_totals["lancedb.fts.postings"] - before["lancedb.fts.postings"]
            == _summed_df(tbl, texts))


def test_a_hybrid_call_keeps_nothing_with_recording_off(hybrid_table):
    tbl, x, texts = hybrid_table
    metrics.span_records(clear=True)
    assert not metrics.recording()
    _hybrid(tbl, x, texts)
    assert metrics.span_records() == []

def test_nothing_is_kept_with_recording_off():
    tbl, x = _table()
    metrics.span_records(clear=True)
    assert not metrics.recording()
    _build(tbl)
    _search(tbl, x[:NQ])
    assert metrics.span_records() == []
    assert metrics.span("a") is metrics.span("b", op="ProjectionExec")  # one no-op object


def test_a_profiler_session_turns_recording_on_and_off(indexed):
    tbl, x = indexed
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert metrics.recording()
        _search(tbl, x[:NQ])
    assert not metrics.recording()
    kept = metrics.span_records(clear=True)
    assert sum(r.name == "query.vector" for r in kept) == 1
    _search(tbl, x[:NQ])
    assert metrics.span_records() == []


def test_threads_keep_their_own_span_stacks():
    barrier = threading.Barrier(2)

    def call(name):
        with metrics.span(name):
            barrier.wait()
            with metrics.span(name + ".child"):
                barrier.wait()

    metrics.span_records(clear=True)
    with metrics.tracing():
        threads = [threading.Thread(target=call, args=(n,)) for n in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    recs = {r.name: r for r in metrics.span_records(clear=True)}
    for n in ("a", "b"):
        assert recs[n].parent is None and recs[n].request == recs[n].id
        assert recs[n + ".child"].parent == recs[n].id
        assert recs[n + ".child"].request == recs[n].id
    assert recs["a"].thread != recs["b"].thread


def test_a_collector_pause_is_a_span_inside_the_open_one():
    metrics.span_records(clear=True)
    with metrics.tracing():
        with metrics.span("outer"):
            gc.collect()
    recs = metrics.span_records(clear=True)
    outer = next(r for r in recs if r.name == "outer")
    pauses = [r for r in recs if r.name == "gc"]
    assert pauses and all(r.parent == outer.id and r.request == outer.id for r in pauses)
    assert all(outer.t0 <= r.t0 <= r.t1 <= outer.t1 for r in pauses)


def test_a_collection_inside_the_ring_or_the_recorder_does_not_deadlock():
    """A collection may start at any allocation, also while a span is being
    kept or a counter added under its lock: with the collector run at
    nearly every allocation, spans and counters still finish."""

    def work():
        with metrics.tracing():
            for i in range(3000):
                with metrics.span("outer", i=i):
                    with metrics.span("inner", rows=[i] * 4):
                        metrics.recorder().increment_counter("tracing.test", labels={"i": i % 7})

    metrics.span_records(clear=True)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(timeout=60)
    finally:
        gc.set_threshold(*thresholds)
    assert not th.is_alive()
    recs = metrics.span_records(clear=True)
    assert sum(r.name == "inner" for r in recs) == 3000
    assert any(r.name == "gc" for r in recs)


def test_the_ring_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_CAPACITY", 4)
    monkeypatch.setattr(metrics, "_records", collections.deque(maxlen=4))
    before = metrics.counter_totals["lancedb.spans.dropped"]
    with metrics.tracing():
        for i in range(7):
            with metrics.span(f"s{i}"):
                pass
    assert [r.name for r in metrics.span_records()] == ["s3", "s4", "s5", "s6"]
    assert metrics.counter_totals["lancedb.spans.dropped"] - before == 3


def test_counter_deltas_match_the_calls(indexed):
    tbl, x = indexed
    totals = metrics.counter_totals
    assert totals["no.such.counter"] == 0.0 and "no.such.counter" not in list(totals)
    with pytest.raises(TypeError):
        totals["lancedb.queries"] = 1.0  # a read-only view
    q0, f0 = totals["lancedb.queries"], totals["lancedb.hydrate.fragment_reads"]
    t0 = totals["lancedb.hydrate.takes"]
    _search(tbl, x[:NQ])
    # one query count a call; one take and one fragment read a call (one
    # fragment, no resident copy before a projection's eighth query)
    assert totals["lancedb.queries"] - q0 == 1
    assert totals["lancedb.hydrate.takes"] - t0 == 1
    assert totals["lancedb.hydrate.fragment_reads"] - f0 == 1
    h0 = totals["lancedb.h2d_bytes"]
    _search(tbl, x[:NQ])
    assert totals["lancedb.h2d_bytes"] == h0  # a CPU table copies nothing to a device
    arr = np.arange(1000, dtype=np.float32)
    _to_device(arr, torch.device("meta"))
    assert totals["lancedb.h2d_bytes"] - h0 == arr.nbytes
    snap = metrics.snapshot_metrics()["counters"]
    assert any(c["name"] == "lancedb.h2d_bytes" and c["labels"] == {"memory": "pageable"}
               for c in snap)


def test_analyze_plan_times_the_same_operators(indexed):
    tbl, x = indexed
    plan = (tbl.search(x[:NQ]).nprobes(4).refine_factor(4).limit(5)
            .where("category = 3", prefilter=True).analyze_plan())
    timed = [line.strip().split(":", 1)[0] for line in plan.splitlines()
             if "elapsed_compute=" in line]
    assert timed == ["TakeExec", "ANNSubIndexExec", "PrefilterExec"]
    assert "PrefilterExec" in plan and f"output_rows={N // 10}" in plan
    post = tbl.search(x[0]).nprobes(4).where("category < 5").postfilter().limit(5).analyze_plan()
    assert [line.strip().split(":", 1)[0] for line in post.splitlines()
            if "elapsed_compute=" in line] == ["FilterExec", "TakeExec", "ANNSubIndexExec"]
    assert metrics.span_records() == []  # an analyze run alone keeps no spans


def test_explain_analyze_times_the_same_operators():
    tbl, _ = _table()
    db = tbl._conn
    plan = db.sql("EXPLAIN ANALYZE SELECT id FROM t WHERE category = 3 LIMIT 4").column(
        "plan")[0].as_py()
    timed = {line.strip().split(":", 1)[0] for line in plan.splitlines()
             if "elapsed_compute=" in line}
    assert {"ScanExec", "GlobalLimitExec"} <= timed
    assert "total: rows=4" in plan


@pytest.mark.cuda
def test_on_the_card_a_device_profiler_records_and_copies_are_counted():
    """A profiler session with device activity alone turns recording on (the
    benchmark's traced window), and a search's copies to the card count
    their bytes: the queries and the slot penalty, pageable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, x = _rows()
    db = lancedb_tpu_torch.connect(f"memory://tracing-{uuid.uuid4().hex}", device="cuda")
    tbl = db.create_table("t", rows)
    _build(tbl)
    _search(tbl, x[:NQ])  # the refine table's upload
    metrics.span_records(clear=True)
    h0 = metrics.counter_totals["lancedb.h2d_bytes"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert metrics.recording()
        _search(tbl, x[:NQ])
    assert not metrics.recording()
    recs = metrics.span_records(clear=True)
    _, children = _tree([r for r in recs if r.name != "gc"], "query.vector")
    assert children == SEARCH_CHILDREN
    searcher = tbl._get_searcher(tbl._dataset.manifest.indices[0])
    assert metrics.counter_totals["lancedb.h2d_bytes"] - h0 == (
        searcher.num_slots * 4 + NQ * D * 4)


# ------------------------------------------------ the benchmark's readers

DOC = spec.read_json(spec.HERE.parent / "BENCHMARK.json")
READERS = {m["name"]: spec.load_module(spec.HERE / "layer_metrics" / f"{m['name']}.py")
           for m in DOC["per_layer"]}
MS = 1_000_000


def _rec(name, t0_ms, t1_ms, rid, parent=None, request=None):
    return metrics.SpanRecord(name, t0_ms * MS, t1_ms * MS, rid, parent,
                              request if request is not None else (parent or rid), 1, None)


def _search_records():
    """Two calls in a 1 s window (ms): each call's root, its plan, slot
    penalty, search, hydration with two takes, and finish."""
    out = []
    for c, base in enumerate((100, 500)):
        r = 100 * c + 1
        out += [_rec("query.vector", base, base + 200, r),
                _rec("query.plan", base, base + 10, r + 1, r, r),
                _rec("searcher.slot_penalty", base + 10, base + 30, r + 2, r, r),
                _rec("searcher.search", base + 30, base + 60, r + 3, r, r),
                _rec("query.hydrate", base + 60, base + 160, r + 4, r, r),
                _rec("dataset.take_rows", base + 60, base + 100, r + 5, r + 4, r),
                _rec("dataset.take_rows", base + 100, base + 140, r + 6, r + 4, r),
                _rec("query.finish", base + 160, base + 170, r + 7, r, r)]
    out.append(_rec("query.vector", 1500, 1600, 999))  # outside the window
    return out


def _search_trace(dropped=0.0, counters=None):
    # the device busy from 0 to 50 ms and from 110 to 130 ms
    events = [DeviceEvent("k", 0, 50 * MS), DeviceEvent("k", 110 * MS, 130 * MS)]
    return Trace((0, 1000 * MS), calls=2, builds=0, queries=512, events=events,
                 counters={"spans_dropped": dropped, **(counters or {})})


def test_search_span_readers(monkeypatch):
    monkeypatch.setattr(metrics, "span_records", _search_records)
    t = _search_trace(counters={"fragment_reads": 512.0, "h2d_bytes": 6.0 * 2**20})
    assert READERS["plan_ms.batch"].read(t) == pytest.approx(10.0)
    # finish 10 ms + hydration's 100 ms less its takes' 80 ms
    assert READERS["finish_ms.batch"].read(t) == pytest.approx(30.0)
    assert READERS["slot_penalty_ms.filtered"].read(t) == pytest.approx(20.0)
    assert READERS["fragment_reads_per_call.filtered"].read(t) == pytest.approx(256.0)
    assert READERS["h2d_mib_per_call.filtered"].read(t) == pytest.approx(3.0)
    # idle 930 ms; named (a span below a root open) 100-270 and 500-670
    # ms, of which 110-130 is busy: 930 - (170 - 20) - 170 = 610 ms unnamed
    for tag in ("batch", "filtered"):
        assert READERS[f"idle_unnamed_pct.{tag}"].read(t) == pytest.approx(61.0)


def test_build_span_readers(monkeypatch):
    recs = [_rec("index.build", 0, 400, 1), _rec("build.upload", 0, 50, 2, 1),
            _rec("build.kmeans", 50, 250, 3, 1), _rec("build.pq", 250, 350, 4, 1),
            _rec("gc", 360, 380, 5, 1), _rec("index.build", 500, 800, 6),
            _rec("build.kmeans", 500, 700, 7, 6), _rec("build.pq", 700, 760, 8, 6),
            _rec("gc", 900, 950, 9)]
    monkeypatch.setattr(metrics, "span_records", lambda: recs)
    t = Trace((0, 1000 * MS), calls=0, builds=2, events=[DeviceEvent("k", 60 * MS, 240 * MS)],
              counters={"spans_dropped": 0.0})
    assert READERS["build_host_s"].read(t) == pytest.approx((0.7 - 0.56) / 2)
    # idle 820 ms; named 0-350, 360-380, 500-760, 900-950 less the busy
    # 180 ms: 820 - (680 - 180) = 320 ms unnamed
    assert READERS["idle_unnamed_pct.build"].read(t) == pytest.approx(32.0)


HYBRID_READERS = ["vector_leg_ms.hybrid", "fts_wait_ms.hybrid", "fts_leg_ms.hybrid",
                  "fts_score_ms.hybrid", "fuse_ms.hybrid", "takes_per_call.hybrid",
                  "idle_unnamed_pct.hybrid"]
NEW_READERS = ["plan_ms.batch", "finish_ms.batch", "idle_unnamed_pct.batch",
               "slot_penalty_ms.filtered", "idle_unnamed_pct.filtered", "build_host_s",
               "idle_unnamed_pct.build"] + HYBRID_READERS


def _hybrid_records():
    """One hybrid call of two pairs in a 1 s window (ms): its root, the
    vector leg (with its one take), two full-text legs on another thread
    (each a scorer and a take), the wait and the fusion."""
    return [_rec("query.hybrid", 100, 700, 1),
            _rec("query.vector", 100, 300, 2, 1, 1),
            _rec("dataset.take_rows", 200, 280, 3, 2, 1),
            _rec("hybrid.fts_leg", 100, 350, 4, 1, 1),
            _rec("fts.score", 100, 150, 5, 4, 1),
            _rec("dataset.take_rows", 150, 340, 6, 4, 1),
            _rec("hybrid.fts_leg", 350, 500, 7, 1, 1),
            _rec("fts.score", 350, 380, 8, 7, 1),
            _rec("dataset.take_rows", 380, 490, 9, 7, 1),
            _rec("hybrid.fts_wait", 300, 500, 10, 1, 1),
            _rec("hybrid.fuse", 500, 700, 11, 1, 1)]


def test_hybrid_span_readers(monkeypatch):
    monkeypatch.setattr(metrics, "span_records", _hybrid_records)
    t = Trace((0, 1000 * MS), calls=1, builds=0, queries=2,
              events=[DeviceEvent("k", 0, 50 * MS), DeviceEvent("k", 200 * MS, 250 * MS)],
              counters={"spans_dropped": 0.0, "fts_postings": 12345.0})
    assert READERS["vector_leg_ms.hybrid"].read(t) == pytest.approx(200.0)
    assert READERS["fts_wait_ms.hybrid"].read(t) == pytest.approx(200.0)
    assert READERS["fts_leg_ms.hybrid"].read(t) == pytest.approx(400.0)  # thread time
    assert READERS["fts_score_ms.hybrid"].read(t) == pytest.approx(80.0)
    assert READERS["fuse_ms.hybrid"].read(t) == pytest.approx(200.0)
    assert READERS["takes_per_call.hybrid"].read(t) == pytest.approx(3.0)
    assert READERS["postings_per_call.hybrid"].read(t) == pytest.approx(12345.0)
    # idle 900 ms; named (a span below the root open) 100-700 ms, of which
    # 200-250 is busy: 900 - 550 = 350 ms unnamed
    assert READERS["idle_unnamed_pct.hybrid"].read(t) == pytest.approx(35.0)
    # a program that counts no postings (before the counter existed) reads None
    t.counters["fts_postings"] = 0.0
    assert READERS["postings_per_call.hybrid"].read(t) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_span_readers_read_nothing_when_records_were_dropped(name, monkeypatch):
    monkeypatch.setattr(metrics, "span_records", _search_records)
    t = _search_trace(dropped=1.0)
    t.builds = 2
    assert READERS[name].read(t) is None


@pytest.mark.parametrize("name", NEW_READERS + ["fragment_reads_per_call.filtered",
                                                "h2d_mib_per_call.filtered",
                                                "postings_per_call.hybrid"])
def test_readers_read_nothing_from_a_program_without_spans(name, monkeypatch):
    """A program without the span ring or the counter view (the parent of
    this instrumentation): the tracer's counters read NaN, the readers None."""
    from portbench import program_spans

    monkeypatch.delattr(metrics, "span_records")
    monkeypatch.delattr(metrics, "counter_totals")
    assert np.isnan(program_spans.TOTALS["lancedb.h2d_bytes"])
    nan = float("nan")
    t = _search_trace(dropped=nan, counters={"fragment_reads": nan, "h2d_bytes": nan})
    t.builds = 2
    assert READERS[name].read(t) is None


def test_idle_gaps_are_named_by_the_span_open_for_most_of_them():
    from portbench import program_spans

    recs = [_rec("query.vector", 0, 1000, 1), _rec("query.plan", 100, 300, 2, 1),
            _rec("query.hydrate", 300, 600, 3, 1), _rec("gc", 400, 450, 4, 3),
            _rec("query.finish", 610, 900, 5, 1)]
    t = Trace((0, 1000 * MS), calls=1, builds=0, events=[DeviceEvent("k", 50 * MS, 100 * MS)])
    under = program_spans.idle_by_innermost(recs, program_spans.idle_gaps(t))
    assert {n: v // MS for n, v in under.items()} == {
        "query.vector": 160, "query.plan": 200, "query.hydrate": 250, "gc": 50,
        "query.finish": 290}
    assert program_spans.named_gaps(t, recs, top=2) == [["query.finish", 0.9],
                                                         ["query.vector", 0.05]]
    assert program_spans.named_gaps(t, [], top=1) == [["harness", 0.9]]
