"""The comparison that decides ``correct``: each number beside its limit.

A search is judged on every returned row of the sampled calls: each query has
its k rows, each once, in order of distance, its hydrated columns are the row's own,
it meets the predicate, its ``_distance`` is the exact distance of the
row, and the rows are the exact top-k often enough (recall@k). A build is
judged on its arrays: every row indexed once, each sampled row in its
nearest centroid's partition and coded by its nearest codewords, and the
whole index no coarser than the reference's own build."""

from __future__ import annotations

import re

import numpy as np
import torch

from .exact import exact_dist, no_tf32, topk

_PRED = re.compile(r"^\s*([A-Za-z_]\w*)\s*(=|==|!=|<>|<=|>=|<|>)\s*(-?\d+)\s*$")
_OPS = {"=": np.equal, "==": np.equal, "!=": np.not_equal, "<>": np.not_equal,
        "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
QUERY_CHUNK = 512


def column_values(ids: np.ndarray, column: str, cfg: dict) -> np.ndarray:
    """A scalar column of rows ``ids``, as the configuration defines it."""
    if column == "id":
        return ids
    if column == "category":
        return ids % int(cfg["category_mod"])
    raise ValueError(f"the reference knows no column {column!r}")


def predicate_mask(ids: np.ndarray, predicate: str, cfg: dict) -> np.ndarray:
    """Rows ``ids`` that meet ``predicate`` (``<column> <op> <integer>``)."""
    m = _PRED.match(predicate)
    if m is None:
        raise ValueError(f"the reference reads only '<column> <op> <integer>', not {predicate!r}")
    col, op, val = m.groups()
    return _OPS[op](column_values(ids, col, cfg), int(val))


def check(value: float, limit: float, op: str) -> dict:
    ok = value <= limit if op == "<=" else value >= limit
    return {"value": float(value), "limit": float(limit), "op": op, "ok": bool(ok)}


def judge_search(x: torch.Tensor, queries: torch.Tensor, ans: dict, cfg: dict,
                 where: str | None) -> dict:
    """Numbers of a search's answers: ``ans`` has ids (Q, k) int64 (-1 for
    no row), dists (Q, k), and the hydrated ``category`` (Q, k) and
    ``vector`` (Q, k, D) or None. ``x`` holds every row on the device."""
    no_tf32()
    k, metric, limits = int(cfg["search"]["k"]), cfg["metric"], cfg["limits"]
    ids = np.asarray(ans["ids"], np.int64)
    dists = np.asarray(ans["dists"], np.float64)
    valid = ids >= 0
    nq = ids.shape[0]
    miscount = int((~valid).sum()) + int(ans.get("surplus", 0))
    dupes = int(sum(len(r[r >= 0]) - len(np.unique(r[r >= 0])) for r in ids))
    d_valid = np.where(valid, dists, np.inf)
    misordered = int((d_valid[:, 1:] < d_valid[:, :-1]).sum())
    safe = np.where(valid, ids, 0)
    hydrate_bad = 0
    if ans.get("category") is not None:
        cat = np.asarray(ans["category"], np.int64)
        hydrate_bad += int((valid & (cat != column_values(safe, "category", cfg))).sum())
    filter_bad = 0
    allowed = None
    if where is not None:
        filter_bad = int((valid & ~predicate_mask(safe, where, cfg)).sum())
        allowed = torch.from_numpy(predicate_mask(np.arange(x.shape[0]), where, cfg)).to(x.device)
    gap, hits = 0.0, 0
    for s in range(0, nq, QUERY_CHUNK):
        sl = slice(s, s + QUERY_CHUNK)
        q = queries[sl]
        ids_d = torch.from_numpy(safe[sl]).to(x.device)
        rows = x[ids_d]
        if ans.get("vector") is not None:
            vec = torch.from_numpy(np.asarray(ans["vector"][sl], np.float32)).to(x.device)
            bad = (vec != rows).any(-1).cpu().numpy() & valid[sl]
            hydrate_bad += int(bad.sum())
        got = exact_dist(q, rows, metric).cpu().numpy()
        true_d, true_i = topk(x, q, k, metric, allowed)
        kth = true_d[:, -1].cpu().numpy()[:, None]
        scale = np.maximum(kth, 1e-30)
        v = valid[sl]
        if v.any():
            gap = max(gap, float((np.abs(dists[sl] - got) / scale)[v].max()))
        for r in range(got.shape[0]):
            sel = v[r]
            uniq = np.unique(ids[sl][r][sel])
            d_of = {int(i): d for i, d in zip(ids[sl][r][sel], got[r][sel])}
            hits += sum(1 for i in uniq if d_of[int(i)] <= kth[r, 0] * (1 + 1e-9))
    recall = hits / float(nq * k)
    out = {
        "miscount": check(miscount, limits["miscount"], "<="),
        "dupes": check(dupes, limits["dupes"], "<="),
        "misordered": check(misordered, limits["misordered"], "<="),
        "hydrate_bad": check(hydrate_bad, limits["hydrate_bad"], "<="),
        "dist_gap": check(gap, limits["dist_gap"], "<="),
    }
    if "recall" in limits:  # only where the configuration states a recall
        out["recall"] = check(recall, limits["recall"], ">=")
    if where is not None:
        out["filter_bad"] = check(filter_bad, limits["filter_bad"], "<=")
    return out


def canonical_index(centroids, row_ids, codes, codebooks, n: int) -> dict:
    """The port's IVF_PQ arrays in its file layout (block centroids (B, D),
    row_ids (B, pmax) with -1 on padding, codes (B, S_pad, pmax)) → the
    canonical form; ``misplaced`` counts rows missing, twice indexed or
    out of range."""
    rid = np.asarray(row_ids).reshape(-1)
    nb, pmax = np.asarray(row_ids).shape
    s = np.asarray(codebooks).shape[0]
    slot = np.flatnonzero(rid >= 0)
    ids = rid[slot]
    inside = (ids < n)
    uniq = np.unique(ids[inside])
    misplaced = (n - len(uniq)) + (len(ids) - len(uniq))
    block_of_row = np.full(n, -1, np.int64)
    block_of_row[ids[inside]] = (slot[inside] // pmax)
    codes_rows = np.zeros((n, s), np.int64)
    c = np.asarray(codes)[:, :s, :].transpose(0, 2, 1).reshape(nb * pmax, s)
    codes_rows[ids[inside]] = c[slot[inside]]
    return {"centroids": np.asarray(centroids, np.float32), "block_of_row": block_of_row,
            "codes": codes_rows, "codebooks": np.asarray(codebooks, np.float32),
            "misplaced": int(misplaced)}


def _as_tensor(a, device, dtype=None):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def build_error(x_s: torch.Tensor, sample: torch.Tensor, index: dict) -> dict:
    """Per sampled row (f64): the distance to its block's centroid and to
    the nearest centroid, each sub-vector's coding error with its code and
    with the nearest codeword, and the reconstruction error."""
    dev = x_s.device
    cents = _as_tensor(index["centroids"], dev, torch.float64)
    books = _as_tensor(index["codebooks"], dev, torch.float64)
    block = _as_tensor(index["block_of_row"], dev)[sample].long()
    codes = _as_tensor(index["codes"], dev)[sample].long()
    x = x_s.double()
    ok = block >= 0
    b = torch.where(ok, block, 0)
    d_all = torch.cdist(x, cents) ** 2
    d_ass = d_all.gather(1, b[:, None])[:, 0]
    d_min = d_all.min(1).values
    nsub, _, dsub = books.shape
    bn = (books ** 2).sum(-1)  # (S, K)
    c_ch, c_min = [], []
    for s in range(0, x.shape[0], 2048):
        r = (x[s:s + 2048] - cents[b[s:s + 2048]]).reshape(-1, nsub, dsub)
        e_all = (r ** 2).sum(-1)[:, :, None] - 2.0 * torch.einsum(
            "msd,skd->msk", r, books) + bn[None]  # (m, S, K)
        c_ch.append(e_all.gather(2, codes[s:s + 2048, :, None])[:, :, 0])
        c_min.append(e_all.min(2).values)
    c_ch, c_min = torch.cat(c_ch), torch.cat(c_min)  # (m, S): each sub-vector's error
    return {"ok": ok, "d_ass": d_ass, "d_min": d_min, "c_ch": c_ch, "c_min": c_min,
            "e_ch": c_ch.sum(1)}


def judge_build(x_s: torch.Tensor, sample: torch.Tensor, index: dict, ref_err: float,
                cfg: dict) -> dict:
    """Numbers of one build: ``x_s`` the sampled rows (f32), ``sample``
    their ids, ``index`` canonical, ``ref_err`` the reference build's mean
    reconstruction error on the same rows. ``assign_miss``: the share of
    sampled rows whose partition's centroid is not their nearest;
    ``code_miss``: the share of their sub-vector codes that are not the
    nearest codeword of the residual; ``quant_excess``: the index's mean
    reconstruction error over the reference's, less 1."""
    lim = cfg["limits"]
    e = build_error(x_s, sample, index)
    ok = e["ok"]
    tie = 1 + 1e-9  # equal distances (duplicate centroids) are the nearest
    assign_miss = (e["d_ass"] > e["d_min"] * tie)[ok].double().mean().item()
    code_miss = (e["c_ch"] > e["c_min"] * tie)[ok].double().mean().item()
    quant_excess = e["e_ch"][ok].mean().item() / ref_err - 1.0
    return {
        "misplaced": check(index["misplaced"], lim["misplaced"], "<="),
        "assign_miss": check(assign_miss, lim["assign_miss"], "<="),
        "code_miss": check(code_miss, lim["code_miss"], "<="),
        "quant_excess": check(quant_excess, lim["quant_excess"], "<="),
    }


def reference_error(x_s: torch.Tensor, sample: torch.Tensor, index: dict) -> float:
    """The mean reconstruction error of a (reference) build on the sample."""
    e = build_error(x_s, sample, index)
    return e["e_ch"][e["ok"]].mean().item()


def worst(checks: list[dict]) -> dict:
    """Several judgments of the same numbers → each number's worst reading."""
    out: dict = {}
    for c in checks:
        for name, v in c.items():
            cur = out.get(name)
            worse = cur is None or (v["value"] > cur["value"] if v["op"] == "<="
                                    else v["value"] < cur["value"])
            if worse:
                out[name] = v
    return out
