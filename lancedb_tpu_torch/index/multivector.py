"""Multivector (ColBERT-style late interaction) search: MaxSim over token
vectors.

Port of the reference's index/multivector.py. A multivector column holds
a list of D-dim token vectors per row (list<fixed_size_list<float, D>>).
Its index is a FLAT index over the unit-normalized tokens whose row ids
point at each token's PARENT row (``metric: cosine``, ``multivector:
True``), so the FLAT searcher serves it unchanged, repeated row ids and
all. A query is a bag of token vectors, searched in two stages:

  1. every query token searches the token index at once (one batch) for
     its k·overfetch nearest tokens;
  2. the union of their parents is rescored exactly,
     score(doc) = Σ_i max_j q_i · d_j over unit-normalized tokens, on the
     searcher's device, and the k best parents are returned.

Host code (the column flattening, the normalizations, the candidate
union and the final ordering) is the reference's numpy; the MaxSim
product is a torch product in ``matmul_dtype`` with f32 accumulation,
as the reference's is an XLA einsum.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pyarrow as pa
import torch

from ..arrow import is_multivector_type
from ..errors import InvalidInputError
from ..ops.util import lowp, resolve_device

_INVALID_ROWID = np.uint64(np.iinfo(np.uint64).max)


def multivector_dim(t: pa.DataType) -> int:
    return t.value_type.list_size


def _column_tokens(col) -> tuple[np.ndarray, np.ndarray]:
    """(N rows of token lists) → (all tokens (T, D) f32, tokens per row
    (N,)); a null row has none."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    dim = multivector_dim(col.type)
    counts = np.asarray(
        pa.compute.list_value_length(col).fill_null(0).to_numpy(zero_copy_only=False),
        dtype=np.int64,
    )
    values = col.flatten().flatten().to_numpy(zero_copy_only=False).astype(np.float32)
    return values.reshape(-1, dim), counts


def flatten_multivector_column(col, row_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N rows of token lists) → (all_tokens (T, D), parent_rowid (T,))."""
    tokens, counts = _column_tokens(col)
    return tokens, np.repeat(row_ids, counts)


def _unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)


def maxsim(q_tokens: torch.Tensor, doc_tokens: torch.Tensor, doc_mask: torch.Tensor
           ) -> torch.Tensor:
    """Exact late-interaction scores (the reference's ``_maxsim_device``).

    q_tokens (nq_tok, D) unit-normalized; doc_tokens (ndoc, max_tok, D)
    unit-normalized with zero padding; doc_mask (ndoc, max_tok) bool.
    Returns (ndoc,) f32 scores Σ_i max_j q_i · d_j; the inputs are rounded
    to ``matmul_dtype`` and the products accumulate in f32."""
    sims = torch.einsum("qd,ntd->nqt", lowp(q_tokens), lowp(doc_tokens))
    sims = torch.where(doc_mask[:, None, :], sims, float("-inf"))
    per_q = torch.amax(sims, dim=2)  # (ndoc, nq_tok)
    per_q = torch.where(torch.isfinite(per_q), per_q, 0.0)
    return torch.sum(per_q, dim=1)


def _rescore(q: np.ndarray, tokens: np.ndarray, counts: np.ndarray, device) -> np.ndarray:
    """MaxSim of unit-normalized query tokens against docs given as their
    unit-normalized tokens (T, D) concatenated, ``counts`` (ndoc,) each. The
    tokens go to the device flat and are padded there."""
    dev = resolve_device(device)
    ndoc = len(counts)
    max_tok = max(int(counts.max()) if ndoc else 1, 1)
    doc_of = np.repeat(np.arange(ndoc), counts)
    slot = np.arange(len(doc_of)) - np.repeat(np.cumsum(counts) - counts, counts)
    flat_idx = torch.from_numpy(doc_of * max_tok + slot).to(dev)
    padded = torch.zeros((ndoc * max_tok, q.shape[1]), dtype=torch.float32, device=dev)
    padded[flat_idx] = torch.from_numpy(np.ascontiguousarray(tokens, dtype=np.float32)).to(dev)
    mask = torch.zeros(ndoc * max_tok, dtype=torch.bool, device=dev)
    mask[flat_idx] = True
    scores = maxsim(torch.from_numpy(q).to(dev), padded.reshape(ndoc, max_tok, -1),
                    mask.reshape(ndoc, max_tok))
    return scores.cpu().numpy()


def maxsim_rescore(query_tokens: np.ndarray, doc_multivectors: list[np.ndarray], device=None
                   ) -> np.ndarray:
    """Exact MaxSim of candidate docs (the reference's maxsim_rescore):
    each side unit-normalized on the host, the product on ``device``."""
    q = _unit_rows(np.asarray(query_tokens, dtype=np.float32))
    docs = [np.asarray(d, dtype=np.float32).reshape(-1, q.shape[1]) for d in doc_multivectors]
    counts = np.asarray([len(d) for d in docs], dtype=np.int64)
    return _rescore(q, _unit_rows(np.concatenate(docs + [q[:0]])), counts, device)


def multivector_search(
    table,
    column: str,
    query_tokens: np.ndarray,
    k: int,
    searcher=None,
    overfetch: int = 10,
    nprobes: int = 20,
    allowed: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-stage multivector retrieval → (scores descending (k,), row_ids
    (k,)). Stage 1 searches the token index (``searcher``), or without one
    brute-forces the column's tokens on the table's device; stage 2
    rescores the union of candidate parents exactly."""
    from .vector import SearchParams, brute_force_search

    ds = table._dataset
    device = table._device
    q = np.atleast_2d(np.asarray(query_tokens, dtype=np.float32))
    if searcher is not None:
        params = SearchParams(k=min(k * overfetch, searcher.num_slots), nprobes=nprobes)
        pen = searcher.slot_penalty(allowed, None)
        _, rowids = searcher.search(q, params, slot_penalty=pen)
    else:
        mats, parents = [], []
        for _, tbl in ds.scan_fragments(columns=[column], with_row_id=True):
            toks, par = flatten_multivector_column(
                tbl.column(column), tbl.column("_rowid").to_numpy().astype(np.uint64)
            )
            mats.append(toks)
            parents.append(par)
        tokens = _unit_rows(np.concatenate(mats))
        parent_ids = np.concatenate(parents)
        if allowed is not None:
            keep = np.isin(parent_ids, allowed)
            tokens, parent_ids = tokens[keep], parent_ids[keep]
        _, rowids = brute_force_search(
            tokens, parent_ids, _unit_rows(q), min(k * overfetch, len(tokens)), "cosine",
            device=device,
        )
    cands = np.unique(rowids[rowids != _INVALID_ROWID])
    if len(cands) == 0:
        return np.empty(0, np.float32), np.empty(0, np.uint64)
    # the take keeps the candidates' order
    tokens, counts = _column_tokens(ds.take_rows(cands, columns=[column]).column(column))
    scores = _rescore(_unit_rows(q), _unit_rows(tokens), counts, device)
    order = np.argsort(-scores)[:k]
    return scores[order].astype(np.float32), cands[order]


def build_multivector_index(dataset, column: str, config=None, name: str | None = None):
    """Token-level FLAT index over a multivector column (the reference's
    build_multivector_index): the tokens flattened and unit-normalized,
    ``row_ids.npy`` holding each token's parent row, metric cosine."""
    from ..storage.manifest import IndexMeta, new_uuid
    from .vector import _save_npy

    field = dataset.schema.field(column)
    if not is_multivector_type(field.type):
        raise InvalidInputError(f"{column!r} is not a multivector column")
    mats, parents, frag_ids = [], [], []
    for meta, tbl in dataset.scan_fragments(columns=[column], with_row_id=True):
        frag_ids.append(meta.id)
        toks, par = flatten_multivector_column(
            tbl.column(column), tbl.column("_rowid").to_numpy().astype(np.uint64)
        )
        mats.append(toks)
        parents.append(par)
    tokens = _unit_rows(np.concatenate(mats))
    parent_ids = np.concatenate(parents)
    uuid = new_uuid()
    prefix = dataset.index_dir(uuid)
    _save_npy(dataset.store, f"{prefix}/vectors.npy", tokens)
    _save_npy(dataset.store, f"{prefix}/row_ids.npy", parent_ids)
    meta_doc = {
        "index_type": "FLAT",
        "column": column,
        "metric": "cosine",
        "dim": tokens.shape[1],
        "num_rows": len(tokens),
        "multivector": True,
        "build_seconds": 0.0,
    }
    dataset.store.write_bytes(f"{prefix}/meta.json", json.dumps(meta_doc).encode())
    return IndexMeta(
        name=name or f"{column}_idx",
        uuid=uuid,
        columns=[column],
        index_type="FLAT",
        params=meta_doc,
        fragment_ids=frag_ids,
        num_indexed_rows=len(tokens),
        created_at=time.time(),
    )
