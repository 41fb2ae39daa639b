"""What the loops share: the window's record, the cell's table drawn and
created in memory through the port's ``connect``, one search call of the
configuration's search, and a call's result decoded for the check.

A traffic mix (``traffic/<mix>.json``) names its loop (``loops/<loop>.py``)
and holds the loop's parameters; the loop sets the cell up, drives the
window, gathers what the check judges and judges it."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa
import torch

from . import data

TABLE = "vectors"


@dataclass
class Window:
    """The measured window's record, which the end-to-end readers read."""

    seconds: float = 0.0
    calls: int = 0
    queries: int = 0
    builds: int = 0
    attempted: int = 0
    failed: int = 0
    latencies: list[float] = field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0  # the window's peak (the peak statistics reset at its start)
    process_peak_bytes: int = 0  # the set-up's and the window's
    errors: list[str] = field(default_factory=list)
    kept: list = field(default_factory=list)  # what the loop keeps for the check


@dataclass
class Setup:
    db: object
    tbl: object
    pool: np.ndarray
    phases: dict = field(default_factory=dict)  # seconds of each set-up step, for stderr

    def timed(self, phase: str, t0: float) -> float:
        """Record the seconds since ``t0`` under ``phase``; the time now."""
        now = time.monotonic()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - t0
        return now


def index_args(cfg: dict) -> dict:
    """``create_index`` keywords: the configuration's metric and its
    ``index`` group whole, rebuilding in place."""
    return dict(metric=cfg["metric"], replace=True, **cfg["index"])


def arrow_table(draw: data.Draw, cfg: dict) -> pa.Table:
    ids = np.arange(draw.n, dtype=np.int64)
    x = data.host_rows(draw)
    return pa.table({
        "id": ids,
        "category": data.categories(ids, cfg),
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), draw.dim),
    })


def open_table(cfg: dict, seed: int, device, connect) -> Setup:
    """The rows and the query pool drawn on the device from ``seed``, the
    table created in memory (``memory://``); no index yet."""
    t0 = time.monotonic()
    draw = data.Draw(cfg, seed, device)
    pool = draw.queries().cpu().numpy()
    table = arrow_table(draw, cfg)
    del draw
    t1 = time.monotonic()
    db = connect(f"memory://portbench-{seed}", device=device)
    st = Setup(db, db.create_table(TABLE, table), pool, {"rows": t1 - t0})
    st.timed("create_table", t1)
    return st


def close(st: Setup) -> None:
    st.db.drop_table(TABLE)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def search_call(tbl, cfg: dict, where: str | None, q: np.ndarray) -> pa.Table:
    """``tbl.search(q)`` with the configuration's search, prefiltered by
    ``where`` where one is given, to Arrow."""
    s = cfg["search"]
    b = tbl.search(q).nprobes(s["nprobes"]).refine_factor(s["refine_factor"]).limit(s["k"])
    if where:
        b = b.where(where, prefilter=True)
    return b.to_arrow()


def batch_rows(call: int, batch: int, pool_size: int) -> np.ndarray:
    """The pool rows of call ``call``: the next ``batch``, in turn."""
    return np.arange(call * batch, (call + 1) * batch) % pool_size


def answers(out: pa.Table, nq: int, k: int, dim: int) -> dict:
    """A batch's result table → ids (Q, k) (-1 where a query has fewer
    rows), dists, the hydrated category and vector, and ``surplus``: rows
    beyond k of a query."""
    n = out.num_rows
    qi = (np.asarray(out.column("query_index"), np.int64) if "query_index" in out.column_names
          else np.zeros(n, np.int64))
    order = np.argsort(qi, kind="stable")
    starts = np.searchsorted(qi[order], np.arange(nq))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - starts[qi[order]]
    inside = rank < k
    ids = np.full((nq, k), -1, np.int64)
    dists = np.full((nq, k), np.inf)
    cat = np.full((nq, k), -1, np.int64)
    vec = np.zeros((nq, k, dim), np.float32)
    at = (qi[inside], rank[inside])
    ids[at] = np.asarray(out.column("id"), np.int64)[inside]
    dists[at] = np.asarray(out.column("_distance"), np.float64)[inside]
    cat[at] = np.asarray(out.column("category"), np.int64)[inside]
    flat = out.column("vector").combine_chunks().flatten().to_numpy(zero_copy_only=False)
    vec[at] = flat.reshape(n, dim)[inside]
    return {"ids": ids, "dists": dists, "category": cat, "vector": vec,
            "surplus": int((~inside).sum())}


def redraw_rows(cfg: dict, seed: int, device) -> torch.Tensor:
    """Every row drawn again from the seed, for the reference (the same
    bits as the set-up's draw on the same device)."""
    return data.Draw(cfg, seed, device).rows()


def judge_searches(searches: list, x: torch.Tensor, pool: np.ndarray, cfg: dict,
                   where: str | None) -> list[dict]:
    """``searches``: (pool rows, answers) of calls → the reference's
    numbers of each, over every row ``x`` and the pool the calls read."""
    from .reference import judge

    return [judge.judge_search(x, torch.from_numpy(pool[rows]).to(x.device), ans, cfg, where)
            for rows, ans in searches]
