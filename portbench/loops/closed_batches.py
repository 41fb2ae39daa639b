"""One closed-loop client of refined batch searches.

Each call is ``tbl.search(Q).nprobes(n).refine_factor(r).limit(k)``
``[.where(p, prefilter=True)].to_arrow()`` over the pool's next ``batch``
queries, in turn, with the configuration's ``search`` group. The mix's
parameters: ``batch``, ``where`` (null: no filter), ``warm_calls`` (the
window's first calls, made in set-up) and ``check_calls`` (the calls a
seeded reservoir keeps for the check)."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import data, drive


def set_up(cfg: dict, traffic: dict, seed: int, device, connect) -> drive.Setup:
    """The table, its index, and the first calls of the window's sequence."""
    st = drive.open_table(cfg, seed, device, connect)
    t = time.monotonic()
    st.tbl.create_index(**drive.index_args(cfg))
    drive.sync(device)
    t = st.timed("create_index", t)
    for i in range(int(traffic["warm_calls"])):
        drive.search_call(st.tbl, cfg, traffic["where"],
                          st.pool[drive.batch_rows(i, traffic["batch"], len(st.pool))])
    drive.sync(device)
    st.timed("warm_calls", t)
    return st


def window(st: drive.Setup, cfg: dict, traffic: dict, seconds: float, seed: int, device,
           tracer=None) -> drive.Window:
    """Calls back to back until the first that returns after ``seconds``;
    a seeded reservoir keeps ``check_calls`` of them for the check."""
    w = drive.Window()
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    keep = int(traffic["check_calls"])
    batch = int(traffic["batch"])
    t_start = time.perf_counter()
    i = 0
    while True:
        rows = drive.batch_rows(i, batch, len(st.pool))
        if tracer is not None:
            tracer.call = i
        t0 = time.perf_counter()
        try:
            out = drive.search_call(st.tbl, cfg, traffic["where"], st.pool[rows])
        except Exception as e:  # a failed call is counted, and fails the run
            w.failed += 1
            w.errors.append(f"call {i}: {type(e).__name__}: {e}")
            out = None
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        if out is not None:
            if len(w.kept) < keep:
                w.kept.append((i, rows, out))
            else:
                j = int(rng.integers(0, i + 1))
                if j < keep:
                    w.kept[j] = (i, rows, out)
        i += 1
        if t1 - t_start >= seconds:
            break
    if tracer is not None:
        tracer.call = -1
    w.seconds = t1 - t_start
    w.calls = w.attempted = i
    w.queries = i * batch
    return w


def answers(st: drive.Setup, w: drive.Window, cfg: dict, traffic: dict) -> dict:
    """The kept calls' results decoded, with the pool they read."""
    k, dim = int(cfg["search"]["k"]), int(cfg["dim"])
    return {"pool": st.pool,
            "searches": [(rows, drive.answers(out, len(rows), k, dim)) for _, rows, out in w.kept]}


def judge(found: dict, cfg: dict, traffic: dict, seed: int, device) -> list[dict]:
    x = drive.redraw_rows(cfg, seed, device)
    return drive.judge_searches(found["searches"], x, found["pool"], cfg, traffic["where"])


def control(cfg: dict, traffic: dict, seed: int, device, fault: str | None = None) -> list[dict]:
    """The reference in the port's place, in the configuration's
    ``control_search`` precision, on the calls a run checks."""
    from portbench.reference import exact
    from portbench.reference import judge as ref_judge

    if fault is not None:
        raise ValueError(f"no planted fault {fault!r} for a search")
    x = drive.redraw_rows(cfg, seed, device)
    pool = data.Draw(cfg, seed, device).queries().cpu().numpy()
    where = traffic["where"]
    allowed = None
    if where is not None:
        allowed = torch.from_numpy(
            ref_judge.predicate_mask(np.arange(x.shape[0]), where, cfg)).to(x.device)
    searches = []
    for call in range(int(traffic["check_calls"])):
        rows = drive.batch_rows(call, int(traffic["batch"]), len(pool))
        q = torch.from_numpy(pool[rows]).to(x.device)
        d, i = exact.topk(x, q, int(cfg["search"]["k"]), cfg["metric"], allowed,
                          cfg["precision"]["control_search"])
        ids = i.cpu().numpy()
        searches.append((rows, {"ids": ids, "dists": d.double().cpu().numpy(),
                                "category": ref_judge.column_values(ids, "category", cfg),
                                "vector": x[i].cpu().numpy()}))
    return drive.judge_searches(searches, x, pool, cfg, where)
