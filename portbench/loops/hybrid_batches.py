"""One closed-loop client of hybrid search batches: BM25 full text and
vector legs fused by Reciprocal Rank Fusion.

Each call is ``tbl.search((v0, t0), query_type="hybrid")``, then
``.add_query(v, t)`` for the pool's next ``batch - 1`` pairs in turn, then
``.nprobes(n).refine_factor(r).limit(k).select(select).to_arrow()`` with
the configuration's ``search`` group and the default reranker (RRF, K 60).
The table holds the configuration's vectors and one passage a row
(``text.py``), with the vector index and the full-text index built through
the port. The mix's parameters: ``batch``, ``select``, ``warm_calls`` (the
window's first calls, made in set-up) and ``check_calls`` (the calls a
seeded reservoir keeps for the check).

The check runs each kept call's two legs again through the port, alone
(the batched vector search; each text's full-text search), and holds the
fused lists to the RRF of those legs, the vector leg to the exact
neighbours, the full-text leg to a plain BM25 over the drawn text
(``reference/bm25.py``), and the fused lists to the RRF of the exact legs
(``fused_recall``)."""

from __future__ import annotations

import time

import numpy as np
import pyarrow as pa
import torch

from portbench import data, drive, text

TEXT = "text"


def open_table(cfg: dict, seed: int, device, connect) -> drive.Setup:
    """The rows, their passages and the pool drawn from ``seed``, the
    table created in memory; no index yet. ``texts`` holds the pool's
    query texts."""
    t0 = time.monotonic()
    draw = data.Draw(cfg, seed, device)
    pool = draw.queries().cpu().numpy()
    table = drive.arrow_table(draw, cfg)
    del draw
    t1 = time.monotonic()
    td = text.TextDraw(cfg, seed, device)
    table = table.add_column(2, TEXT, text.text_column(td))
    texts = text.query_texts(td)
    t2 = time.monotonic()
    db = connect(f"memory://portbench-{seed}", device=device)
    st = drive.Setup(db, db.create_table(drive.TABLE, table), pool,
                     {"rows": t1 - t0, "text": t2 - t1})
    st.texts = texts
    del table
    st.timed("create_table", t2)
    return st


def hybrid_call(tbl, cfg: dict, traffic: dict, vectors: np.ndarray, texts: list) -> pa.Table:
    """One batched hybrid search of the pairs (``vectors[i]``, ``texts[i]``)."""
    s = cfg["search"]
    b = tbl.search((vectors[0], texts[0]), query_type="hybrid")
    for v, t in zip(vectors[1:], texts[1:]):
        b = b.add_query(v, t)
    b = b.nprobes(s["nprobes"]).refine_factor(s["refine_factor"]).limit(s["k"])
    return b.select(list(traffic["select"])).to_arrow()


def _call(st: drive.Setup, cfg: dict, traffic: dict, i: int) -> tuple[np.ndarray, pa.Table]:
    rows = drive.batch_rows(i, int(traffic["batch"]), len(st.pool))
    return rows, hybrid_call(st.tbl, cfg, traffic, st.pool[rows], [st.texts[r] for r in rows])


def set_up(cfg: dict, traffic: dict, seed: int, device, connect) -> drive.Setup:
    """The table, its vector and full-text indexes, and the first calls
    of the window's sequence."""
    st = open_table(cfg, seed, device, connect)
    t = time.monotonic()
    st.tbl.create_index(**drive.index_args(cfg))
    drive.sync(device)
    t = st.timed("create_index", t)
    st.tbl.create_fts_index(TEXT, **cfg["fts"])
    t = st.timed("create_fts_index", t)
    for i in range(int(traffic["warm_calls"])):
        _call(st, cfg, traffic, i)
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
    t_start = time.perf_counter()
    i = 0
    while True:
        if tracer is not None:
            tracer.call = i
        t0 = time.perf_counter()
        try:
            rows, out = _call(st, cfg, traffic, i)
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
    w.queries = i * int(traffic["batch"])
    return w


def _by_query(out: pa.Table, nq: int, k: int, columns: dict) -> dict:
    """A result table → each of ``columns`` (name → fill value) as (Q, k)
    in each query's order (``query_index``; one query without it), and
    ``surplus``: rows beyond k of a query."""
    n = out.num_rows
    qi = (np.asarray(out.column("query_index"), np.int64) if "query_index" in out.column_names
          else np.zeros(n, np.int64))
    order = np.argsort(qi, kind="stable")
    starts = np.searchsorted(qi[order], np.arange(nq))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - starts[qi[order]]
    inside = rank < k
    at = (qi[inside], rank[inside])
    res = {"surplus": int((~inside).sum())}
    for name, fill in columns.items():
        vals = out.column(name).to_numpy(zero_copy_only=False)
        arr = np.full((nq, k), fill, dtype=object if isinstance(fill, str) else type(fill))
        arr[at] = vals[inside]
        res[name] = arr
    return res


def _legs(tbl, cfg: dict, vectors: np.ndarray, texts: list) -> tuple[dict, dict]:
    """The pairs' two legs run again through the port, each alone: the
    batched vector search, and each text's full-text search."""
    s, k = cfg["search"], int(cfg["search"]["k"])
    vec = (tbl.search(vectors).nprobes(s["nprobes"]).refine_factor(s["refine_factor"])
           .limit(k).select(["id", "category"]).to_arrow())
    v = _by_query(vec, len(vectors), k, {"id": -1, "_distance": np.inf, "category": -1})
    fts = [tbl.search(t, query_type="fts").limit(k).select(["id"]).to_arrow() for t in texts]
    f = {"id": np.full((len(texts), k), -1, np.int64), "_score": np.zeros((len(texts), k))}
    for j, out in enumerate(fts):
        m = min(k, out.num_rows)
        f["id"][j, :m] = np.asarray(out.column("id"), np.int64)[:m]
        f["_score"][j, :m] = np.asarray(out.column("_score"), np.float64)[:m]
    return v, f


def answers(st: drive.Setup, w: drive.Window, cfg: dict, traffic: dict) -> dict:
    """The kept calls' fused lists decoded, with their legs run again."""
    k = int(cfg["search"]["k"])
    calls = []
    for _, rows, out in w.kept:
        fused = _by_query(out, len(rows), k, {"id": -1, "_relevance_score": np.nan,
                                              "category": -1, TEXT: ""})
        v, f = _legs(st.tbl, cfg, st.pool[rows], [st.texts[r] for r in rows])
        calls.append({"rows": rows, "fused": fused, "vector": v, "fts": f})
    return {"pool": st.pool, "calls": calls}


def judge(found: dict, cfg: dict, traffic: dict, seed: int, device) -> list[dict]:
    from portbench.reference import judge as ref_judge
    from portbench.reference.exact import topk

    x = drive.redraw_rows(cfg, seed, device)
    td = text.TextDraw(cfg, seed, device)
    index = bm25_index(td)
    qranks = td.queries().cpu().numpy()
    vocab = text.words(td.vocab)
    k, lim = int(cfg["search"]["k"]), cfg["limits"]
    rrf_k = int(cfg["search"]["rrf_k"])
    out = []
    for c in found["calls"]:
        rows, fz, v, f = c["rows"], c["fused"], c["vector"], c["fts"]
        q = torch.from_numpy(found["pool"][rows]).to(x.device)
        vec = ref_judge.judge_search(
            x, q, {"ids": v["id"].astype(np.int64), "dists": v["_distance"].astype(np.float64),
                   "category": v["category"].astype(np.int64), "vector": None,
                   "surplus": v["surplus"]}, cfg, None)
        fts_bad, gap = index.judge(qranks[rows], f["id"], f["_score"], k, lim["fts_score_gap"])
        _, exact_v = topk(x, q, k, cfg["metric"])
        exact_f, _ = index.topk(qranks[rows], k)
        fused = judge_fused(fz, v["id"], f["id"], exact_v.cpu().numpy(), exact_f, td, vocab,
                            cfg, rrf_k)
        n = {name: fused[name] + vec[name]["value"]
             for name in ("miscount", "dupes", "misordered", "hydrate_bad")}
        out.append({
            **{name: ref_judge.check(val, lim[name], "<=") for name, val in n.items()},
            "dist_gap": vec["dist_gap"], "recall": vec["recall"],
            "rrf_bad": ref_judge.check(fused["rrf_bad"], lim["rrf_bad"], "<="),
            "fts_bad": ref_judge.check(fts_bad, lim["fts_bad"], "<="),
            "fts_score_gap": ref_judge.check(gap, lim["fts_score_gap"], "<="),
            "fused_recall": ref_judge.check(fused["recall"], lim["fused_recall"], ">="),
        })
    return out


def bm25_index(td: text.TextDraw):
    """The plain BM25 index of every row's drawn text."""
    from portbench.reference import bm25 as ref_bm25

    docs, ranks = [], []
    for b in range(td.num_blocks):
        lengths, r = td.block(b)
        start = b * data.BLOCK_ROWS
        docs.append(torch.repeat_interleave(
            torch.arange(start, start + len(lengths), device=r.device), lengths))
        ranks.append(r)
    return ref_bm25.Bm25(torch.cat(docs), torch.cat(ranks), td.n, len(text.STOP_WORDS))


def judge_fused(fz: dict, v_ids: np.ndarray, f_ids: np.ndarray, exact_v: np.ndarray,
                exact_f: np.ndarray, td: text.TextDraw, vocab: list, cfg: dict,
                rrf_k: int) -> dict:
    """Numbers of a call's fused lists (Q, k): ``rrf_bad``, rows not the
    RRF of the legs (ids exactly, relevance to 1e-6); ``miscount``,
    ``dupes``, ``misordered`` (on relevance), ``hydrate_bad`` (category or
    text not the row's own); ``recall``, against the RRF of the exact legs."""
    from portbench.reference.bm25 import rrf
    from portbench.reference.judge import column_values

    k = int(cfg["search"]["k"])
    ids = fz["id"].astype(np.int64)
    rel = fz["_relevance_score"].astype(np.float64)
    valid = ids >= 0
    n = {"rrf_bad": 0, "miscount": fz["surplus"], "dupes": 0, "misordered": 0,
         "hydrate_bad": 0}
    hits = total = 0
    for j in range(len(ids)):
        got, g_rel = ids[j][valid[j]], rel[j][valid[j]]
        v, f = v_ids[j][v_ids[j] >= 0], f_ids[j][f_ids[j] >= 0]
        want, w_rel = rrf(v, f, rrf_k, k)
        n["miscount"] += abs(len(got) - len(want))
        n["dupes"] += len(got) - len(np.unique(got))
        n["misordered"] += int((g_rel[1:] > g_rel[:-1]).sum())
        m = min(len(got), len(want))
        n["rrf_bad"] += int((got[:m] != want[:m]).sum()
                            + (np.abs(g_rel[:m] - w_rel[:m]) > 1e-6).sum())
        ev, ef = exact_v[j], exact_f[j][exact_f[j] >= 0]
        best, _ = rrf(ev, ef, rrf_k, k)
        hits += len(np.intersect1d(got, best))
        total += len(best)
    safe = np.where(valid, ids, 0)
    cat = fz["category"].astype(np.int64)
    n["hydrate_bad"] += int((valid & (cat != column_values(safe, "category", cfg))).sum())
    flat = ids[valid]
    redrawn = td.ranks_of(flat)
    got_text = fz[TEXT][valid]
    n["hydrate_bad"] += sum(t != " ".join(vocab[r - 1] for r in rk)
                            for t, rk in zip(got_text, redrawn))
    n["recall"] = hits / total if total else 1.0
    return n


def control(cfg: dict, traffic: dict, seed: int, device, fault: str | None = None) -> list[dict]:
    """The reference in the port's place one precision step down, on the
    calls a run checks: the vector leg in ``control_search`` precision, the
    BM25 scores summed in ``control_bm25``, fused by the plain RRF."""
    from portbench.reference import bm25 as ref_bm25
    from portbench.reference.exact import topk
    from portbench.reference.judge import column_values

    if fault is not None:
        raise ValueError(f"no planted fault {fault!r} for a hybrid search")
    x = drive.redraw_rows(cfg, seed, device)
    pool = data.Draw(cfg, seed, device).queries().cpu().numpy()
    td = text.TextDraw(cfg, seed, device)
    index = bm25_index(td)
    qranks = td.queries().cpu().numpy()
    vocab = text.words(td.vocab)
    k, rrf_k = int(cfg["search"]["k"]), int(cfg["search"]["rrf_k"])
    bm25_dtype = getattr(torch, cfg["precision"]["control_bm25"])
    calls = []
    for call in range(int(traffic["check_calls"])):
        rows = drive.batch_rows(call, int(traffic["batch"]), len(pool))
        q = torch.from_numpy(pool[rows]).to(x.device)
        d, i = topk(x, q, k, cfg["metric"], None, cfg["precision"]["control_search"])
        v_ids = i.cpu().numpy()
        f_ids, f_sc = index.topk(qranks[rows], k, bm25_dtype)
        fz = {"id": np.full((len(rows), k), -1, np.int64),
              "_relevance_score": np.full((len(rows), k), np.nan), "surplus": 0}
        for j in range(len(rows)):
            ids, sc = ref_bm25.rrf(v_ids[j], f_ids[j][f_ids[j] >= 0], rrf_k, k)
            fz["id"][j, :len(ids)] = ids
            fz["_relevance_score"][j, :len(ids)] = sc.astype(np.float32)
        safe = np.where(fz["id"] >= 0, fz["id"], 0)
        fz["category"] = np.where(fz["id"] >= 0, column_values(safe, "category", cfg), -1)
        texts = np.full(fz["id"].shape, "", dtype=object)
        ok = fz["id"] >= 0
        texts[ok] = [" ".join(vocab[r - 1] for r in rk) for rk in td.ranks_of(fz["id"][ok])]
        fz[TEXT] = texts
        v = {"id": v_ids, "_distance": d.double().cpu().numpy(),
             "category": column_values(v_ids, "category", cfg), "surplus": 0}
        calls.append({"rows": rows, "fused": fz, "vector": v,
                      "fts": {"id": f_ids, "_score": f_sc}})
    return judge({"pool": pool, "calls": calls}, cfg, traffic, seed, device)
