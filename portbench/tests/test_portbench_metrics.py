"""Each traffic mix's window accounting and each metric's arithmetic, at
tiny sizes with stand-in timings, and the frozen bound against hand counts."""

import numpy as np
import pyarrow as pa
import pytest

from portbench import bounds, drive, spec
from portbench.trace import DeviceEvent, SpanRecord, Trace, busy_intervals

ROOT = spec.HERE.parent
DOC = spec.read_json(ROOT / "BENCHMARK.json")
CELLS = {w["name"]: spec.resolve(DOC, w["name"], ROOT) for w in DOC["workloads"]}
SEARCH = CELLS["sift1m_ivfpq.batch256"].loop
BUILD = CELLS["sift1m_ivfpq.build"].loop


class Clock:
    """perf_counter stand-in: each read advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, iter(steps)

    def __call__(self):
        self.t += next(self.steps, 0.0)
        return self.t


class FakeTable:
    def __init__(self):
        self.builds = 0

    def create_index(self, **kw):
        self.builds += 1


def fake_search(tbl, cfg, where, q):
    return pa.table({"id": np.arange(len(q))})


def test_search_window_counts_every_call(monkeypatch):
    # t_start 0; each call reads t0, t1: 0.1 s between its reads, 0.05 before
    monkeypatch.setattr(SEARCH.time, "perf_counter", Clock([0.0] + [0.05, 0.1] * 50))
    monkeypatch.setattr(drive, "search_call", fake_search)
    st = drive.Setup(None, None, np.zeros((1000, 4), np.float32))
    traffic = {"batch": 256, "where": None, "check_calls": 3}
    w = SEARCH.window(st, {}, traffic, seconds=1.0, seed=5, device="cpu")
    # call i returns at 0.15 (i + 1): the first at or after 1.0 s is call 7
    assert w.calls == w.attempted == 7 and w.queries == 7 * 256
    assert w.seconds == pytest.approx(1.05)
    assert len(w.latencies) == 7 and all(abs(x - 0.1) < 1e-12 for x in w.latencies)
    assert len(w.kept) == 3 and len({c for c, _, _ in w.kept}) == 3
    per = CELLS["sift1m_ivfpq.batch256"].per_layer
    t = Trace((0, int(w.seconds * 1e9)), w.calls, 0, w.queries, w.latencies)
    assert per["call_qps.batch"].read(t) == pytest.approx(7 * 256 / 1.05)
    assert per["call_p95_ms.batch"].read(t) == pytest.approx(100.0)


def test_the_pool_is_served_in_turn():
    assert drive.batch_rows(0, 256, 10_000).tolist() == list(range(256))
    wrapped = drive.batch_rows(39, 256, 10_000)
    assert wrapped[0] == 9984 and wrapped[16] == 0 and len(wrapped) == 256


def test_reservoir_is_seeded(monkeypatch):
    monkeypatch.setattr(drive, "search_call", fake_search)
    st = drive.Setup(None, None, np.zeros((100, 4), np.float32))
    kept = []
    for _ in range(2):
        monkeypatch.setattr(SEARCH.time, "perf_counter", Clock([0.0] + [0.01] * 400))
        w = SEARCH.window(st, {}, {"batch": 8, "where": None, "check_calls": 4}, 1.0, 11, "cpu")
        kept.append(sorted(c for c, _, _ in w.kept))
    assert kept[0] == kept[1] and max(kept[0]) >= 4


def test_build_window_ends_with_the_build_after_the_deadline(monkeypatch):
    monkeypatch.setattr(BUILD.time, "perf_counter", Clock([0.0] + [2.5] * 10))
    monkeypatch.setattr(BUILD, "index_files", lambda tbl: {"uuid": tbl.builds})
    st = drive.Setup(None, FakeTable(), np.zeros((4, 4)))
    w = BUILD.window(st, {"metric": "l2", "index": {
        "index_type": "IVF_PQ", "num_partitions": 4, "num_sub_vectors": 2, "num_bits": 8,
        "sample_rate": 8, "max_iterations": 2}}, {}, seconds=6.0, seed=1, device="cpu")
    assert w.builds == w.attempted == 3 and w.seconds == pytest.approx(7.5)
    assert [f["uuid"] for f in w.kept] == [1, 2, 3]
    assert CELLS["sift1m_ivfpq.build"].end_to_end["index_build_s"].read(w) == pytest.approx(2.5)


def test_peak_setup_and_tail_readers():
    w = drive.Window(peak_bytes=3 * 2**30, process_peak_bytes=5 * 2**30, setup_s=12.5,
                     latencies=[0.1, 0.2, 0.3, 0.4])
    e2e = CELLS["openai1536_ivfpq.filtered256"].end_to_end
    assert e2e["batch_p95_ms"].read(w) == pytest.approx(385.0)
    assert e2e["peak_device_gib"].read(w) == 3.0
    e2e = CELLS["sift1m_ivfpq.batch256"].end_to_end
    assert set(e2e) == {"process_peak_gib", "setup_s"}
    assert e2e["process_peak_gib"].read(w) == 5.0 and e2e["setup_s"].read(w) == 12.5
    assert e2e["process_peak_gib"].read(drive.Window()) is None
    assert CELLS["sift1m_ivfpq.build"].end_to_end["index_build_s"].read(w) is None


def test_answers_from_a_result_table():
    # two queries, k 3; query 1 has only two rows
    tbl = pa.table({
        "id": [5, 6, 7, 8, 9], "category": [5, 6, 7, 8, 9],
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(np.arange(10, dtype=np.float32)), 2),
        "_distance": [0.1, 0.2, 0.3, 0.5, 0.6], "query_index": [0, 0, 0, 1, 1]})
    a = drive.answers(tbl, 2, 3, 2)
    assert a["ids"].tolist() == [[5, 6, 7], [8, 9, -1]] and a["surplus"] == 0
    assert a["vector"][1, 1].tolist() == [8.0, 9.0]
    assert drive.answers(tbl, 2, 2, 2)["surplus"] == 1


def trace_fixture():
    # a 1 s window, 4 calls; device busy 0.1-0.3 and 0.25-0.4 (union 0.3 s)
    ns = 1_000_000_000
    rec = [SpanRecord("take_rows", 0, int(0.05 * ns), c, 0) for c in range(4)]
    rec += [SpanRecord("searcher", 0, int(0.02 * ns), c, 0) for c in range(4)]
    rec += [SpanRecord("allowed_rowids", 0, int(0.01 * ns), c, 0) for c in range(4)]
    rec += [SpanRecord("slot_penalty", 0, int(0.005 * ns), c, 0) for c in range(4)]
    rec += [SpanRecord("b1", int(0.1 * ns), int(0.3 * ns), 0, 1, extra=0.0001)] * 2
    rec += [SpanRecord("kmeans", 0, int(0.4 * ns), 0, 0), SpanRecord("pq", 0, int(0.2 * ns), 0, 0)]
    events = [DeviceEvent("void adc_scan_kernel<16>(...)", int(0.1 * ns), int(0.3 * ns)),
              DeviceEvent("Memcpy DtoH", int(0.25 * ns), int(0.4 * ns)),
              DeviceEvent("void adc_grouped_scan_kernel", int(2 * ns), int(3 * ns))]
    return Trace((0, ns), calls=4, builds=2, queries=4 * 256, latencies=[0.1, 0.2, 0.3, 0.4],
                 records=rec, events=events,
                 counters={"b1_launches": 8})


@pytest.mark.parametrize("cell,tag,b1", [("openai1536_ivfpq.filtered256", "filtered", "b1_s192"),
                                         ("sift1m_ivfpq.batch256", "batch", "b1_s16")])
def test_search_metric_arithmetic(cell, tag, b1):
    t = trace_fixture()
    per = CELLS[cell].per_layer
    assert per[f"hydrate_ms.{tag}"].read(t) == pytest.approx(50.0)
    assert per[f"searcher_ms.{tag}"].read(t) == pytest.approx(20.0)
    assert per[f"b1_launches_per_call.{tag}"].read(t) == 2.0
    # bound 2 x 0.1 ms over 0.2 s of B1 (the grouped kernel is not B1)
    assert per[f"{b1}_roofline"].read(t) == pytest.approx(100 * 0.0002 / 0.2)
    assert per[f"device_idle_pct.{tag}"].read(t) == pytest.approx(70.0)
    assert per[f"call_qps.{tag}"].read(t) == pytest.approx(1024.0)


def test_layer_metric_arithmetic():
    t = trace_fixture()
    per = CELLS["openai1536_ivfpq.filtered256"].per_layer
    assert per["prefilter_ms"].read(t) == pytest.approx(15.0)
    sift = CELLS["sift1m_ivfpq.batch256"].per_layer
    assert sift["call_p95_ms.batch"].read(t) == pytest.approx(385.0)
    build = CELLS["sift1m_ivfpq.build"].per_layer
    assert build["kmeans_s"].read(t) == pytest.approx(0.2)
    assert build["pq_s"].read(t) == pytest.approx(0.1)
    assert build["device_idle_pct.build"].read(t) == pytest.approx(70.0)


def test_readers_with_nothing_to_read_return_nothing():
    empty = Trace((0, 10**9), calls=0, builds=0)
    for cell in CELLS.values():
        for name, mod in cell.per_layer.items():
            assert mod.read(empty) is None, name


def test_busy_union_and_breakdown():
    t = trace_fixture()
    assert busy_intervals(t.events, t.window) == [(100_000_000, 400_000_000)]
    assert t.busy_s() == pytest.approx(0.3)
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void adc_scan_kernel")
    assert len(bd["idle_gaps"]) == 2
    assert bd["idle_gaps"][0][1] == pytest.approx(0.6) and bd["idle_gaps"][0][0] == "window"
    assert bd["idle_gaps"][1][0] == "take_rows"  # the shortest span open at 0.05 s


def test_adc_bound_hand_count():
    """Path a's B1 launch: 128 queries x 20 probes, S 16, K 256, pmax 1152,
    every probe a distinct partition (2,560 of them)."""
    b = bounds.adc_bound(q=128, np_=20, s=16, k=256, pmax=1152, probed_parts=2560)
    codes_rnorms = 2560 * (16 * 1152 + 4 * 1152)  # 58,982,400
    luts = 128 * 16 * 256 * 4  # 2,097,152
    small = 128 * 20 * 4 * 2 + 128 * 4  # probe ids, q.c, |q|^2
    out = 128 * 20 * 1152 * 4  # 11,796,480
    assert b["bytes"] == codes_rnorms + luts + small + out == 72_897_024
    assert b["ops"] == 128 * 20 * 1152 * 19
    assert b["bound_by"] == "bytes"
    assert b["seconds"] == pytest.approx(72_897_024 / 3.35e12)


def test_a_search_call_states_its_filter_as_a_prefilter():
    """No filter: no ``where``; a filter: a prefilter, as the configuration
    and the mix state them."""
    seen = []

    class Builder:
        def __getattr__(self, name):
            def step(*args, **kwargs):
                seen.append((name, args, kwargs))
                return pa.table({"id": [1]}) if name == "to_arrow" else self
            return step

    class Table:
        def search(self, q):
            return Builder()

    cfg = {"search": {"nprobes": 20, "refine_factor": 10, "k": 10}}
    drive.search_call(Table(), cfg, None, np.zeros((2, 4)))
    assert [s[0] for s in seen] == ["nprobes", "refine_factor", "limit", "to_arrow"]
    seen.clear()
    drive.search_call(Table(), cfg, "category = 3", np.zeros((2, 4)))
    assert ("where", ("category = 3",), {"prefilter": True}) in seen
