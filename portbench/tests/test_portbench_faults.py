"""The whole run on the CPU at a tiny size, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath
in each way the cell can break, or with the control (the reference in a
lower precision) in the port's place, it comes out not correct."""

import json

import numpy as np
import pytest
import torch

import lancedb_tpu_torch
from lancedb_tpu_torch.index import vector as port_vector
from portbench import control, run
from portbench.reference import judge
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 4242
SEARCH_CELLS = ["sift1m_ivfpq.batch256", "openai1536_ivfpq.filtered256"]
INVALID = np.uint64(np.iinfo(np.uint64).max)


def run_tiny(name, seconds=0.5):
    result, lines = run.run_cell(tiny_cell(name), SEED, seconds, False, "cpu",
                                 lancedb_tpu_torch.connect)
    return result


def failing(result):
    return sorted(n for n, c in result["checks"].items()
                  if (c["value"] > c["limit"] if c["op"] == "<=" else c["value"] < c["limit"]))


@pytest.mark.parametrize("name", SEARCH_CELLS + ["sift1m_ivfpq.build"])
def test_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def altered_answer(search):
    def wrapped(self, queries, params, slot_penalty=None):
        d, r = search(self, queries, params, slot_penalty)
        r = r.copy()
        r[:, [0, 1]] = r[:, [1, 0]]  # each query's first two rows swapped, distances kept
        r[0, 0] = r[1, 2]
        return d, r
    return wrapped


def half_batch(search):
    def wrapped(self, queries, params, slot_penalty=None):
        d, r = search(self, queries, params, slot_penalty)
        d, r = d.copy(), r.copy()
        half = len(r) // 2
        d[half:], r[half:] = np.inf, INVALID
        return d, r
    return wrapped


@pytest.mark.parametrize("name", SEARCH_CELLS)
@pytest.mark.parametrize("fault,numbers", [(altered_answer, {"dist_gap", "misordered"}),
                                            (half_batch, {"miscount"})])
def test_broken_search_is_not_correct(name, fault, numbers, monkeypatch):
    monkeypatch.setattr(port_vector.VectorSearcher, "search",
                        fault(port_vector.VectorSearcher.search))
    result = run_tiny(name)
    assert not result["correct"]
    assert numbers & set(failing(result)), result["checks"]


def codes_altered(monkeypatch):
    build = port_vector.pq_build_device

    def wrapped(*args, **kwargs):
        books, codes, rnorms = build(*args, **kwargs)
        codes = codes.clone()
        codes[::3] = (codes[::3].long() + 1).remainder(books.shape[1]).to(codes.dtype)
        return books, codes, rnorms
    monkeypatch.setattr(port_vector, "pq_build_device", wrapped)
    return {"code_miss"}


def half_rows(monkeypatch):
    upload = port_vector._upload_vectors

    def wrapped(*args, **kwargs):
        row_ids, frag_ids, xd = upload(*args, **kwargs)
        half = len(row_ids) // 2
        return row_ids[:half], frag_ids, xd[:half]
    monkeypatch.setattr(port_vector, "_upload_vectors", wrapped)
    return {"misplaced"}


def kmeans_unchanged(monkeypatch):
    train = port_vector.ivf_train_assign_device

    def wrapped(*args, **kwargs):
        kwargs["max_iters"] = 0  # the centroids stay at their seeds
        return train(*args, **kwargs)
    monkeypatch.setattr(port_vector, "ivf_train_assign_device", wrapped)
    return {"quant_excess"}


@pytest.mark.parametrize("fault", [codes_altered, half_rows, kmeans_unchanged])
def test_broken_build_is_not_correct(fault, monkeypatch):
    numbers = fault(monkeypatch)
    result = run_tiny("sift1m_ivfpq.build")
    assert not result["correct"]
    assert numbers & set(failing(result)), result["checks"]


@pytest.mark.parametrize("name", SEARCH_CELLS + ["sift1m_ivfpq.build"])
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    numbers = judge.worst(cell.loop.control(cell.config, cell.traffic, SEED, "cpu"))
    assert not all(c["ok"] for c in numbers.values()), numbers
    caught = {"dist_gap"} if "batch" in cell.traffic else {"assign_miss", "code_miss"}
    assert any(not numbers[n]["ok"] for n in caught)


def test_the_run_draws_the_same_data_from_a_seed():
    from portbench import data

    cfg = tiny_cell(SEARCH_CELLS[0]).config
    a, b = data.Draw(cfg, SEED, "cpu"), data.Draw(cfg, SEED, "cpu")
    assert torch.equal(a.rows(), b.rows()) and torch.equal(a.queries(), b.queries())
    assert not torch.equal(a.rows(), data.Draw(cfg, SEED + 1, "cpu").rows())


@pytest.mark.parametrize("name", SEARCH_CELLS)
def test_no_refine_is_not_correct(name):
    """The port with a stated guarantee broken (no refine where the
    configuration states its refine_factor) fails recall; as configured,
    on the same set-up, it passes."""
    cell = tiny_cell(name)
    sound, fewer = (json.loads(line) for line in control.port_variants(
        cell, SEED, 0.5, [{"refine_factor": 1}], "cpu", lancedb_tpu_torch.connect))
    assert sound["correct"] and sound["control"] is False, sound["checks"]
    assert not fewer["correct"] and fewer["control"] == {"refine_factor": 1}
    assert fewer["checks"]["recall"]["value"] < fewer["checks"]["recall"]["limit"]
