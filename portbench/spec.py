"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix and the loop that mix names, and the readers of its metrics,
each resolved by its name."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """A name in BENCHMARK.json that resolves to no file, or breaks the
    rules for names and units."""


LOOP_API = ("set_up", "window", "answers", "judge")


def load_module(path: Path, needs: tuple[str, ...] = ("read",)) -> ModuleType:
    """A metric's reader or a loop by its file path (metric names hold
    dots, which an import statement would read as packages)."""
    if not path.is_file():
        raise SpecError(f"no file {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    for name in needs:
        if not callable(getattr(mod, name, None)):
            raise SpecError(f"{path} defines no {name}()")
    return mod


def check_names(doc: dict) -> None:
    """Every name and unit of the benchmark against the allowed characters."""
    names = [c["name"] for c in doc["configs"]] + [w["name"] for w in doc["workloads"]]
    names += [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    names += [w["config"] for w in doc["workloads"]] + [w["traffic"] for w in doc["workloads"]]
    names += [k for c in doc["configs"] for k in c["reduced"]]
    for n in names:
        if not NAME.match(n):
            raise SpecError(f"name {n!r} breaks the naming rule")
    for m in doc["end_to_end"] + doc["per_layer"]:
        if not UNIT.match(m["unit"]):
            raise SpecError(f"unit {m['unit']!r} of {m['name']} breaks the unit rule")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it resolves to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    loop: ModuleType | None = None
    end_to_end: dict[str, ModuleType] = field(default_factory=dict)
    per_layer: dict[str, ModuleType] = field(default_factory=dict)
    units: dict[str, str] = field(default_factory=dict)


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"no file {path}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(doc: dict, cell_name: str, root: Path) -> Cell:
    """The cell named ``cell_name``, its files read and its readers loaded."""
    check_names(doc)
    cells = {w["name"]: w for w in doc["workloads"]}
    if cell_name not in cells:
        raise SpecError(f"unknown workload {cell_name!r}; known: {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in doc["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {cell_name} names unknown config {w['config']!r}")
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    if not NAME.match(str(traffic.get("loop", ""))):
        raise SpecError(f"traffic {w['traffic']!r} names no loop")
    loop = load_module(HERE / "loops" / f"{traffic['loop']}.py", LOOP_API)
    cell = Cell(cell_name, int(w["chips"]), config, traffic, loop)
    e2e = [m for m in doc["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    for m in e2e:
        cell.end_to_end[m["name"]] = load_module(HERE / "e2e_metrics" / f"{m['name']}.py")
        cell.units[m["name"]] = m["unit"]
    for m in doc["per_layer"]:
        if _reports(m, cell_name, e2e_names):
            cell.per_layer[m["name"]] = load_module(HERE / "layer_metrics" / f"{m['name']}.py")
            cell.units[m["name"]] = m["unit"]
    return cell
