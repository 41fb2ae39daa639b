"""BENCHMARK.json against the contract's shape, and the loader: every
config, traffic mix and metric it names resolves to a file of its own,
an unknown name is refused, and a cell is added by files alone."""

import json
import shutil

import pytest

from portbench import spec

ROOT = spec.HERE.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(DOC) == TOP
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert DOC["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in DOC["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entry_keys():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert m["better"] in ("lower", "higher")
    setup = [m for m in DOC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("text", [
    *(c["why"] for c in DOC["configs"]), *(w["why"] for w in DOC["workloads"]),
    *(c["source"] for c in DOC["configs"]), *(m["layer"] for m in DOC["per_layer"]),
    *DOC["command"],
])
def test_free_text_fields(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_and_units_use_the_allowed_characters():
    spec.check_names(DOC)
    for bad in ("has space", "a,b", "a/b", "", "x" * 65, "muµ"):
        assert not spec.NAME.match(bad)
    for unit in ("queries/s", "ms", "%", "GiB", "launches"):
        assert spec.UNIT.match(unit)
    assert not spec.UNIT.match("tokens per second")


def test_names_are_unique():
    for group in (DOC["configs"], DOC["workloads"], DOC["end_to_end"] + DOC["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.resolve(DOC, cell, ROOT)
    assert c.config["name"] == next(w["config"] for w in DOC["workloads"] if w["name"] == cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for m in DOC["per_layer"]:
        if cell in m.get("workloads", ()):
            assert m["moves"] in c.end_to_end


def test_every_config_is_used_and_lists_its_file():
    used = {w["config"] for w in DOC["workloads"]}
    assert used == {c["name"] for c in DOC["configs"]}
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))
    for c in DOC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.resolve(DOC, "no_such_cell", ROOT)
    doc = json.loads(json.dumps(DOC))
    doc["workloads"][0]["traffic"] = "no_such_mix"
    with pytest.raises(spec.SpecError):
        spec.resolve(doc, doc["workloads"][0]["name"], ROOT)
    doc = json.loads(json.dumps(DOC))
    doc["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(spec.SpecError):
        spec.resolve(doc, doc["workloads"][0]["name"], ROOT)
    doc = json.loads(json.dumps(DOC))
    doc["end_to_end"].append({"name": "no_such_metric", "unit": "s", "better": "lower",
                              "bound": 0.1, "source": "host_clock"})
    with pytest.raises(spec.SpecError):
        spec.resolve(doc, doc["workloads"][0]["name"], ROOT)


def _checkout(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(spec, "HERE", root / "portbench")
    return root


LOOP_STUB = """
def set_up(cfg, traffic, seed, device, connect): return None
def window(st, cfg, traffic, seconds, seed, device, tracer=None): return None
def answers(st, w, cfg, traffic): return {}
def judge(found, cfg, traffic, seed, device): return []
"""


def test_a_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    """A new traffic mix of an existing loop, a new loop and a new per-layer
    metric, added as files and entries, resolve with no edit of an
    existing file."""
    root = _checkout(tmp_path, monkeypatch)
    (root / "portbench" / "traffic" / "batch32.json").write_text(json.dumps(
        {"loop": "closed_batches", "batch": 32, "where": None, "warm_calls": 2,
         "check_calls": 4}))
    (root / "portbench" / "loops" / "threads8.py").write_text(LOOP_STUB)
    (root / "portbench" / "traffic" / "single8.json").write_text(json.dumps(
        {"loop": "threads8", "clients": 8}))
    (root / "portbench" / "layer_metrics" / "calls_seen.py").write_text(
        "def read(t):\n    return t.calls\n")
    doc = json.loads(json.dumps(DOC))
    doc["workloads"].append({"name": "sift1m_ivfpq.batch32", "config": "sift1m_ivfpq",
                             "traffic": "batch32", "chips": 1, "why": "small batches"})
    doc["workloads"].append({"name": "sift1m_ivfpq.single8", "config": "sift1m_ivfpq",
                             "traffic": "single8", "chips": 1, "why": "8 clients"})
    doc["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                             "source": "program_counter", "layer": "searchers", "moves": "setup_s",
                             "workloads": ["sift1m_ivfpq.batch32"]})
    cell = spec.resolve(doc, "sift1m_ivfpq.batch32", root)
    assert cell.traffic["batch"] == 32 and "calls_seen" in cell.per_layer
    assert cell.loop.__name__ == "portbench_loops_closed_batches"
    assert set(cell.end_to_end) == {"setup_s"}  # the others list their cells
    cell = spec.resolve(doc, "sift1m_ivfpq.single8", root)
    assert cell.traffic["clients"] == 8 and cell.loop.window(*[None] * 6) is None


@pytest.mark.parametrize("loop,text", [("no_such_loop", None), ("half_loop", "def set_up(): pass\n"),
                                       ("", None), ("../run", None)])
def test_a_mix_must_name_a_whole_loop(tmp_path, monkeypatch, loop, text):
    root = _checkout(tmp_path, monkeypatch)
    if text is not None:
        (root / "portbench" / "loops" / f"{loop}.py").write_text(text)
    (root / "portbench" / "traffic" / "odd.json").write_text(json.dumps({"loop": loop}))
    doc = json.loads(json.dumps(DOC))
    doc["workloads"].append({"name": "sift1m_ivfpq.odd", "config": "sift1m_ivfpq",
                             "traffic": "odd", "chips": 1, "why": "odd"})
    with pytest.raises(spec.SpecError):
        spec.resolve(doc, "sift1m_ivfpq.odd", root)


def test_traffic_mixes_are_data_files_that_name_a_loop():
    for w in DOC["workloads"]:
        mix = spec.read_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
        assert (spec.HERE / "loops" / f"{mix['loop']}.py").is_file()
    assert not list((spec.HERE / "traffic").glob("*.py"))


def test_the_rebuild_loop_refuses_another_index_type():
    cell = spec.resolve(DOC, "sift1m_ivfpq.build", ROOT)
    cfg = dict(cell.config, index=dict(cell.config["index"], index_type="IVF_FLAT"))
    with pytest.raises(ValueError):
        cell.loop.set_up(cfg, cell.traffic, 1, "cpu", connect=None)
