"""The benchmark's hybrid cell (``dbpedia1536_hybrid.hybrid256``) on the CPU
at a tiny size: 65,536 rows of 64-d vectors in 8 partitions and passages
over a 2,000-rank vocabulary with the configuration's stop-word ranks.

65,536 documents is the smallest table on which the port's full-text
search takes the native top-k scorer that the 1M-row cell takes; below it
a query that repeats a term scores that term twice (ROADMAP §C, reference
behaviour the port copies), where the plain BM25 of the configuration
scores each distinct term once.

The loop runs end to end through ``run_cell`` and comes out correct with
every exact number at 0; the plain BM25 equals the port's full-text leg
(ids, scores to 1e-5), the fused lists equal the plain RRF of the port's
legs, and each planted fault fails the number that guards against it, as
the control (the reference one precision step down) fails its limits."""

import copy

import numpy as np
import pytest
import torch

import lancedb_tpu_torch
from lancedb_tpu_torch.index import fts as port_fts
from lancedb_tpu_torch.query import LanceHybridQueryBuilder
from lancedb_tpu_torch.rerankers import rrf as port_rrf
from portbench import drive, isolation, run, spec, text
from portbench.reference import bm25 as ref_bm25
from portbench.reference import judge

ROOT = spec.HERE.parent
CELL = "dbpedia1536_hybrid.hybrid256"
SEED = 2**31 + 4242
EXACT = ("miscount", "dupes", "misordered", "hydrate_bad", "rrf_bad", "fts_bad", "failed")


def tiny_cell() -> spec.Cell:
    cell = spec.resolve(spec.read_json(ROOT / "BENCHMARK.json"), CELL, ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg.update(rows=65_536, dim=64, query_pool=400)
    cfg["data"].update(n_coarse=256, n_parents=4096)
    cfg["text"].update(vocab=2000)
    cfg["index"].update(num_partitions=8, num_sub_vectors=8, num_bits=8, max_iterations=10)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=16, check_calls=3, warm_calls=1)
    return cell


def failing(checks: dict) -> set:
    return {n for n, c in checks.items()
            if (c["value"] > c["limit"] if c["op"] == "<=" else c["value"] < c["limit"])}


@pytest.fixture(scope="module")
def cell():
    return tiny_cell()


@pytest.fixture(scope="module")
def served(cell):
    """One set-up of the tiny cell, shared by the cases that drive windows."""
    st = cell.loop.set_up(cell.config, cell.traffic, SEED, "cpu", lancedb_tpu_torch.connect)
    yield st
    drive.close(st)


def judged(cell, st, seconds=0.2) -> dict:
    loop, cfg, traffic = cell.loop, cell.config, cell.traffic
    w = loop.window(st, cfg, traffic, seconds, SEED, "cpu")
    found = loop.answers(st, w, cfg, traffic)
    numbers = judge.worst(loop.judge(found, cfg, traffic, SEED, "cpu"))
    numbers["failed"] = judge.check(w.failed, 0, "<=")
    return numbers


def test_sound_run_is_correct_with_every_exact_number_at_zero(cell):
    result, lines = run.run_cell(cell, SEED, 0.5, False, "cpu", lancedb_tpu_torch.connect)
    assert result["correct"], lines
    checks = result["checks"]
    assert {n: checks[n]["value"] for n in EXACT} == dict.fromkeys(EXACT, 0.0)
    assert 0 < checks["fts_score_gap"]["value"] <= 1e-6
    assert checks["recall"]["value"] >= 0.9 and checks["fused_recall"]["value"] >= 0.9
    assert result["attempted"] >= 1 and "setup_s" in result["metrics"]
    assert any(line.startswith("setup ") and "create_fts_index" in line for line in lines)


def test_plain_bm25_equals_the_ports_full_text_leg(cell, served):
    cfg, k = cell.config, cell.config["search"]["k"]
    td = text.TextDraw(cfg, SEED, "cpu")
    index = cell.loop.bm25_index(td)
    rows = np.arange(64)
    want_ids, want_sc = index.topk(td.queries().numpy()[rows], k)
    for j, r in enumerate(rows):
        out = served.tbl.search(served.texts[r], query_type="fts").limit(k).to_arrow()
        got_ids = np.asarray(out.column("id"), np.int64)
        got_sc = np.asarray(out.column("_score"), np.float64)
        n = int((want_ids[j] >= 0).sum())
        assert len(got_ids) == n
        if not n:  # only stop words
            continue
        np.testing.assert_allclose(got_sc, want_sc[j, :n], rtol=1e-5)
        # ids exactly wherever a score is not tied with another within 1e-6
        sc = want_sc[j, :n]
        tied = np.zeros(n, bool)
        close = np.isclose(sc[1:], sc[:-1], rtol=1e-6)
        tied[1:] |= close
        tied[:-1] |= close
        tied |= np.isclose(sc, sc[-1], rtol=1e-6)  # ties at the cut
        assert np.array_equal(got_ids[~tied], want_ids[j, :n][~tied])


def test_fused_lists_equal_the_plain_rrf_of_the_ports_legs(cell, served):
    cfg, traffic = cell.config, cell.traffic
    rows = np.arange(16)
    out = cell.loop.hybrid_call(served.tbl, cfg, dict(traffic, select=["id"]),
                                served.pool[rows], [served.texts[r] for r in rows])
    k = cfg["search"]["k"]
    v, f = cell.loop._legs(served.tbl, cfg, served.pool[rows], [served.texts[r] for r in rows])
    qi = np.asarray(out.column("query_index"))
    for j in range(len(rows)):
        got = out.filter(qi == j)
        ids, rel = ref_bm25.rrf(v["id"][j][v["id"][j] >= 0], f["id"][j][f["id"][j] >= 0], 60, k)
        assert np.array_equal(np.asarray(got.column("id"), np.int64), ids)
        np.testing.assert_allclose(np.asarray(got.column("_relevance_score")), rel, atol=1e-6)


def _rrf_k_61(monkeypatch):
    init = port_rrf.RRFReranker.__init__
    monkeypatch.setattr(port_rrf.RRFReranker, "__init__",
                        lambda self, K=61, return_score="relevance": init(self, K, return_score))


def _legs_shifted(monkeypatch):
    start = LanceHybridQueryBuilder._start_fts_legs
    monkeypatch.setattr(LanceHybridQueryBuilder, "_start_fts_legs",
                        lambda self, ex, texts: start(self, ex, texts[1:] + texts[:1]))


def _f16_scores(monkeypatch):
    topk = port_fts.ColumnFtsIndex.topk_match_native

    def rounded(self, query, k, dead=None):
        ids, sc = topk(self, query, k, dead)
        return ids, np.asarray(sc, np.float16).astype(np.float32)
    monkeypatch.setattr(port_fts.ColumnFtsIndex, "topk_match_native", rounded)


def _term_dropped(monkeypatch):
    topk = port_fts.ColumnFtsIndex.topk_match_native

    def dropped(self, query, k, dead=None):
        words = [w for w in query.split() if w not in text.STOP_WORDS]
        return topk(self, " ".join(words[1:]), k, dead)
    monkeypatch.setattr(port_fts.ColumnFtsIndex, "topk_match_native", dropped)


@pytest.mark.parametrize("fault,number", [
    (_rrf_k_61, "rrf_bad"),
    (_legs_shifted, "rrf_bad"),
    (_f16_scores, "fts_score_gap"),
    (_term_dropped, "fts_bad"),
], ids=["rrf_k_61", "legs_shifted_by_one", "f16_bm25_scores", "one_term_dropped"])
def test_a_planted_fault_fails_its_number(cell, served, fault, number, monkeypatch):
    fault(monkeypatch)
    numbers = judged(cell, served)
    assert number in failing(numbers), numbers


def test_the_same_window_unbroken_passes(cell, served):
    numbers = judged(cell, served)
    assert not failing(numbers), numbers


def test_the_control_is_not_correct(cell):
    numbers = judge.worst(cell.loop.control(cell.config, cell.traffic, SEED, "cpu"))
    assert {"dist_gap", "fts_score_gap"} <= failing(numbers), numbers


def test_the_reference_imports_neither_jax_nor_the_port():
    assert isolation.reference_imports(spec.HERE / "reference") == []
    assert torch.float16 == getattr(torch, tiny_cell().config["precision"]["control_bm25"])
