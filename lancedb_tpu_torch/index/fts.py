"""BM25 full-text index: build, persist, search.

Reference parity: lance's inverted index + lancedb's FTS query exec
(SURVEY.md §2.9 "FTS: BM25 inverted index…", python query.py FTS AST).
Design: postings stored as CSR numpy arrays (term → doc ids + tfs,
optional positions) — columnar and vectorizable; scoring is a
vectorized numpy accumulation over the postings of the query's terms
(queries touch few terms, so the host CPU is the right engine; the
card earns its keep on the vector side of hybrid queries).

BM25: idf(t) = ln(1 + (N − df + ½)/(df + ½)),
      score = Σ_t idf · tf·(k1+1)/(tf + k1·(1 − b + b·dl/avgdl)),
      k1 = 1.2, b = 0.75 (lance defaults).

A query's scoring is the span ``fts.score`` (``path``: the scorer that
ran); each query counts ``lancedb.fts.queries`` and adds the summed df of
its distinct terms to ``lancedb.fts.postings`` (metrics.py).
"""

from __future__ import annotations

import io
import json
import time

import numpy as np
import pyarrow as pa

from ..errors import InvalidInputError
from ..metrics import recorder, span
from ..native import (
    bm25_and_topk_native,
    bm25_impact2_topk_native,
    bm25_impact_topk_native,
    bm25_maxscore_topk_native,
    phrase_topk_native,
)
from ..query_fts import (
    BooleanQuery,
    BoostQuery,
    FtsQueryNode,
    MatchQuery,
    MultiMatchQuery,
    Occur,
    Operator,
    PhraseQuery,
    parse_string_query,
)
from ..storage.manifest import IndexMeta, new_uuid
from .tokenizer import Tokenizer

K1 = 1.2
B = 0.75


def _save_npy(store, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    store.write_bytes(path, buf.getvalue())


def _load_npy(store, path):
    local = store.local_path(path)
    if local is not None:
        return np.load(local, mmap_mode="r")
    return np.load(io.BytesIO(store.read_bytes(path)))


_VINT_MAGIC = b"LVI1"


def _save_ints(store, path, arr):
    """Persist an integer array delta+LEB128 compressed (the native
    varint posting codec — reference posting blocks, SURVEY §2.9).
    Sorted runs (CSR doc ids, offsets) encode to ~1-2 bytes/value vs 8
    for raw .npy; falls back to .npy when the native lib is absent."""
    from ..native import varint_encode_native

    flat = np.asarray(arr, dtype=np.int64).ravel()
    data = varint_encode_native(flat)
    if data is None:
        _save_npy(store, path, np.asarray(arr))
        return
    store.write_bytes(
        path + ".vint",
        _VINT_MAGIC + np.uint64(len(flat)).tobytes() + data,
    )


def _py_varint_decode(data: bytes, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    prev = 0
    pos = 0
    for i in range(count):
        v = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        prev = (prev + v) & 0xFFFFFFFFFFFFFFFF
        out[i] = np.int64(np.uint64(prev))
    return out


def _load_ints(store, path):
    from ..native import varint_decode_native

    vpath = path + ".vint"
    if store.exists(vpath):
        raw = store.read_bytes(vpath)
        assert raw[:4] == _VINT_MAGIC, f"bad vint header in {vpath}"
        count = int(np.frombuffer(raw[4:12], dtype=np.uint64)[0])
        payload = raw[12:]
        out = varint_decode_native(payload, count)
        if out is None:
            out = _py_varint_decode(payload, count)
        return out
    return _load_npy(store, path)


class ColumnFtsIndex:
    """In-memory searchable inverted index for one text column."""

    def __init__(
        self,
        vocab: dict[str, int],
        df: np.ndarray,
        postings_offsets: np.ndarray,
        postings_docs: np.ndarray,
        postings_tf: np.ndarray,
        doc_lens: np.ndarray,
        doc_rowids: np.ndarray,
        tokenizer: Tokenizer,
        pos_offsets: np.ndarray | None = None,
        positions: np.ndarray | None = None,
    ):
        self.vocab = vocab
        self.df = df
        # the native scorers take int64 CSR arrays; normalize ONCE here
        # so per-query ascontiguousarray calls are views, not copies of
        # the whole postings (a fresh build produces int32/float32)
        self.postings_offsets = np.ascontiguousarray(postings_offsets, dtype=np.int64)
        self.postings_docs = np.ascontiguousarray(postings_docs, dtype=np.int64)
        self.postings_tf = np.ascontiguousarray(postings_tf, dtype=np.int64)
        self.doc_lens = doc_lens
        self.doc_rowids = doc_rowids
        self.tokenizer = tokenizer
        self.pos_offsets = pos_offsets
        self.positions = positions
        self.num_docs = len(doc_lens)
        self.avgdl = float(doc_lens.mean()) if len(doc_lens) else 1.0
        # sorted view for rowid → doc index mapping
        self._sorted_order = np.argsort(doc_rowids)
        self._sorted_rowids = doc_rowids[self._sorted_order]
        self._term_ub: np.ndarray | None = None  # lazy MaxScore bounds

    def term_upper_bounds(self) -> np.ndarray:
        """Per-term BM25 score upper bound (exact max over the term's
        postings) — the MaxScore pruning table. Computed once per load
        in one vectorized pass over all postings."""
        if self._term_ub is None:
            norm = K1 * (1.0 - B + B * self.doc_lens / max(self.avgdl, 1e-9))
            tfs = self.postings_tf.astype(np.float32)
            contrib = tfs * (K1 + 1.0) / (tfs + norm[self.postings_docs])
            n_terms = len(self.df)
            starts = np.asarray(self.postings_offsets[:-1])
            segmax = np.zeros(n_terms, dtype=np.float32)
            nonempty = np.asarray(self.df) > 0
            if contrib.size:
                red = np.maximum.reduceat(contrib, np.minimum(starts, contrib.size - 1))
                segmax = np.where(nonempty, red, 0.0).astype(np.float32)
            idf = np.log(
                1.0 + (self.num_docs - self.df + 0.5) / (self.df + 0.5)
            ).astype(np.float32)
            self._term_ub = idf * segmax
        return self._term_ub

    BLOCK = 128  # postings per block-max block (matches LDB_FTS_BLK)

    def block_maxes(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-term block-max table (Ding & Suel BMW): for each
        BLOCK-posting block of every term, the max raw BM25
        contribution tf*(k1+1)/(tf+norm) WITHOUT idf, plus a per-term
        CSR offset array. Computed once per load in one vectorized
        pass; lets the native MaxScore scorer skip whole blocks."""
        cached = getattr(self, "_block_max", None)
        if cached is not None:
            return cached
        off = np.asarray(self.postings_offsets, dtype=np.int64)
        lens = off[1:] - off[:-1]
        nblk = (lens + self.BLOCK - 1) // self.BLOCK
        blk_off = np.concatenate([[0], np.cumsum(nblk)]).astype(np.int64)
        total = int(blk_off[-1])
        if total == 0:
            self._block_max = (np.zeros(0, np.float32), blk_off)
            return self._block_max
        within = np.arange(total, dtype=np.int64) - np.repeat(blk_off[:-1], nblk)
        starts = np.repeat(off[:-1], nblk) + within * self.BLOCK
        norm = (K1 * (1.0 - B + B * self.doc_lens / max(self.avgdl, 1e-9))).astype(
            np.float32
        )
        tfs = self.postings_tf.astype(np.float32)
        contrib = tfs * (K1 + 1.0) / (tfs + norm[self.postings_docs])
        self._block_max = (
            np.maximum.reduceat(contrib, starts).astype(np.float32),
            blk_off,
        )
        return self._block_max

    def impact_order(self) -> np.ndarray:
        """Per-posting within-term positions sorted by DESCENDING raw
        BM25 contribution, CSR-aligned with postings_offsets — the
        sorted-access order of the impact-ordered Threshold-Algorithm
        scorer (Anh & Moffat impact-sorted indexes; exact variant).
        Computed once per load in one vectorized lexsort."""
        cached = getattr(self, "_impact_order", None)
        if cached is not None:
            return cached
        off = np.asarray(self.postings_offsets, dtype=np.int64)
        lens = off[1:] - off[:-1]
        norm = (K1 * (1.0 - B + B * self.doc_lens / max(self.avgdl, 1e-9))).astype(
            np.float32
        )
        tfs = self.postings_tf.astype(np.float32)
        contrib = tfs * (K1 + 1.0) / (tfs + norm[self.postings_docs])
        term_of = np.repeat(
            np.arange(len(lens), dtype=np.int64), lens
        )
        order = np.lexsort((-contrib, term_of))
        self._impact_order = (
            order - np.repeat(off[:-1], lens)
        ).astype(np.int32)
        return self._impact_order

    def impact_strata(self):
        """Per-term contribution strata for the 2-term stratified scorer
        (ldb_bm25_impact2_topk): postings regrouped by QUANTIZED
        contribution (1% log buckets — exact ties collapse to one
        stratum on uniform-length corpora), doc-ascending within each
        stratum so stratum pairs intersect by galloping merge over
        CONTIGUOUS arrays (no position indirection on the hot loop).
        Returns (strat_docs int32, strat_contrib float32 — postings in
        stratum order; strat_starts int64 absolute, strat_term_off
        int64 per-term CSR, strat_ub float32 exact max contribution per
        stratum). Computed once per load, vectorized."""
        cached = getattr(self, "_impact_strata_cache", None)
        if cached is not None:
            return cached
        off = np.asarray(self.postings_offsets, dtype=np.int64)
        lens = off[1:] - off[:-1]
        norm = self._doc_norm()
        tfs = self.postings_tf.astype(np.float32)
        contrib = tfs * (K1 + 1.0) / (tfs + norm[self.postings_docs])
        n_terms = len(lens)
        if contrib.size == 0:
            self._impact_strata_cache = (
                np.zeros(0, np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.int64),
                np.zeros(n_terms + 1, np.int64), np.zeros(0, np.float32),
            )
            return self._impact_strata_cache
        term_of = np.repeat(np.arange(n_terms, dtype=np.int64), lens)
        bucket = np.floor(
            np.log(np.maximum(contrib, 1e-9)) * (1.0 / np.log(1.01))
        ).astype(np.int32)
        pos_within = np.arange(contrib.size, dtype=np.int64) - np.repeat(
            off[:-1], lens
        )
        order = np.lexsort((pos_within, -bucket, term_of))
        strat_docs = self.postings_docs[order].astype(np.int32)
        strat_contrib = contrib[order].astype(np.float32)
        tb, bb = term_of[order], bucket[order]
        change = np.empty(order.size, dtype=bool)
        change[0] = True
        change[1:] = (tb[1:] != tb[:-1]) | (bb[1:] != bb[:-1])
        strat_starts = np.nonzero(change)[0].astype(np.int64)
        strat_term_off = np.searchsorted(
            tb[strat_starts], np.arange(n_terms + 1)
        ).astype(np.int64)
        strat_ub = np.maximum.reduceat(strat_contrib, strat_starts).astype(
            np.float32
        )
        self._impact_strata_cache = (
            strat_docs, strat_contrib, strat_starts, strat_term_off, strat_ub
        )
        return self._impact_strata_cache

    # posting mass above which the impact-ordered TA scorer beats DAAT
    # (measured: tied-score corpora plateau the TA threshold instantly,
    # while MaxScore/BMW must still merge every posting)
    IMPACT_MIN_POSTINGS = 1 << 17
    # posting mass above which a TWO-term OR routes to the stratified
    # pair scorer — it beats the DAAT merge as soon as the merge itself
    # dominates per-query cost (measured crossover well below 16k)
    IMPACT2_MIN_POSTINGS = 1 << 14

    def topk_match_native(
        self, query: str, k: int, dead: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Exact BM25 top-k: the impact-ordered Threshold-Algorithm
        scorer (ldb_bm25_impact_topk) when the query touches a large
        posting mass — the common-term worst case where DAAT degrades
        to a full merge — and the DAAT MaxScore/block-max scorer
        (ldb_bm25_maxscore_topk) otherwise. Both skip dead docs
        (deletes / dead fragments) inside the loop. None when the
        native lib is absent."""
        tokens = self.tokenizer.tokenize(query)
        tids = sorted({t for t in (self.vocab.get(tok) for tok in tokens) if t is not None})
        if not tids:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        idf = np.array([self.idf(t) for t in tids], dtype=np.float32)
        norm = self._doc_norm()
        off = np.asarray(self.postings_offsets, dtype=np.int64)
        ta = np.asarray(tids)
        total = int((off[ta + 1] - off[ta]).sum())
        if len(tids) == 2 and total >= self.IMPACT2_MIN_POSTINGS:
            # two-term OR: stratified pair enumeration — top-k lives in
            # the cross products of high-contribution strata, each a
            # tiny galloping intersection (the common-term worst case
            # where both TA and the DAAT merge degrade)
            out = bm25_impact2_topk_native(
                self.postings_docs, self.postings_tf, self.postings_offsets,
                *self.impact_strata(),
                np.asarray(tids, dtype=np.int32), idf, norm, k, K1, dead,
                max_work=1 << 24,
            )
            if out is not None:
                return out
        if total >= self.IMPACT_MIN_POSTINGS:
            # pop budget: TA either converges in a few thousand pops
            # (tied/quantized impact distributions — measured <1024 on
            # the plateau cases it exists for) or it will lose to the
            # DAAT merge (3+ common terms / low-co-occurrence pairs
            # decay the summed upper bound too slowly; measured 26 qps
            # TA vs 78 DAAT on a 3-common-term OR at 1M docs). Per-pop
            # cost is ~1 µs × (n_terms-1) partner lookups, so the bail
            # costs ≤ ~2 ms before the DAAT fallback runs.
            out = bm25_impact_topk_native(
                self.postings_docs, self.postings_tf, self.postings_offsets,
                self.impact_order(), np.asarray(tids, dtype=np.int32), idf,
                norm, k, K1, dead, max_pops=4096,
            )
            if out is not None:
                return out
        block_max, block_off = self.block_maxes()
        return bm25_maxscore_topk_native(
            self.postings_docs, self.postings_tf, self.postings_offsets,
            np.asarray(tids, dtype=np.int32), idf, norm, k, K1, dead,
            qub=self.term_upper_bounds()[tids],
            block_max=block_max, block_offsets=block_off,
        )

    def topk_and_native(
        self, query: str, k: int, dead: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Exact conjunctive (AND) BM25 top-k via the native DAAT
        galloping-intersection scorer (ldb_bm25_and_topk): no dense
        match-count arrays. Returns empty when any required token has
        no postings (tantivy AND semantics). None = lib absent."""

        tokens = self.tokenizer.tokenize(query)
        if not tokens:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        tids = [self.vocab.get(tok) for tok in tokens]
        if any(t is None for t in tids):
            # a required term with no postings: unsatisfiable clause
            return np.empty(0, np.int64), np.empty(0, np.float32)
        idf = np.array([self.idf(t) for t in tids], dtype=np.float32)
        return bm25_and_topk_native(
            self.postings_docs, self.postings_tf, self.postings_offsets,
            np.asarray(tids, dtype=np.int32), idf, self._doc_norm(), k, K1, dead,
        )

    def topk_phrase_native(
        self, query: str, k: int, slop: int = 0, dead: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Exact phrase BM25 top-k via the native DAAT intersection +
        positional verifier (ldb_phrase_topk). None = lib absent or the
        index lacks positions."""
        if self.pos_offsets is None or self.positions is None:
            return None
        tokens = self.tokenizer.tokenize(query)
        if not tokens:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        tids = [self.vocab.get(tok) for tok in tokens]
        if any(t is None for t in tids):
            return np.empty(0, np.int64), np.empty(0, np.float32)
        idf = np.array([self.idf(t) for t in tids], dtype=np.float32)
        return phrase_topk_native(
            self.postings_docs, self.postings_tf, self.postings_offsets,
            self.pos_offsets, self.positions,
            np.asarray(tids, dtype=np.int32), idf, self._doc_norm(),
            slop, k, K1, dead,
        )

    def _doc_norm(self) -> np.ndarray:
        """BM25 length norm per doc, cached (K1*(1-B+B*len/avgdl))."""
        norm = getattr(self, "_doc_norm_cache", None)
        if norm is None:
            norm = (K1 * (1.0 - B + B * self.doc_lens / max(self.avgdl, 1e-9))).astype(
                np.float32
            )
            self._doc_norm_cache = norm
        return norm

    def score_match_topk(self, query: str, k: int) -> np.ndarray:
        """OR-match scoring with MaxScore term pruning (Turtle & Flood):
        terms are scored fully in descending upper-bound order until the
        remaining terms cannot lift an unseen doc into the top-k; the
        remaining (high-df, low-impact) terms then score only candidate
        docs. Exact for the top-k set and their scores; other docs may
        hold partial scores, all provably below the kth candidate.
        Reference behavior: lance/tantivy's block-wise top-k pruning
        (SURVEY §2.9 FTS)."""
        tokens = self.tokenizer.tokenize(query)
        scores = np.zeros(self.num_docs, dtype=np.float32)
        if not tokens:
            return scores
        tids = sorted({t for t in (self.vocab.get(tok) for tok in tokens) if t is not None})
        if not tids:
            return scores
        ub = self.term_upper_bounds()
        order = sorted(tids, key=lambda t: -float(ub[t]))
        suffix = np.cumsum([float(ub[t]) for t in order][::-1])[::-1]
        norm = K1 * (1.0 - B + B * self.doc_lens / max(self.avgdl, 1e-9))

        touched: list[np.ndarray] = []
        theta = 0.0
        i = 0
        for i, t in enumerate(order):
            if i > 0 and len(touched) and suffix[i] < theta:
                break  # remaining terms cannot put a NEW doc into top-k
            docs, tfs = self.postings(t)
            contrib = self.idf(t) * tfs * (K1 + 1.0) / (tfs + norm[docs])
            np.add.at(scores, docs, contrib.astype(np.float32))
            touched.append(np.asarray(docs))
            tdocs = np.unique(np.concatenate(touched)) if len(touched) > 1 else touched[0]
            ts = scores[tdocs]
            if len(ts) >= k:
                theta = float(np.partition(ts, len(ts) - k)[len(ts) - k])
        else:
            return scores  # every term fully scored — nothing pruned
        # non-essential phase: remaining terms touch only candidates
        rem_terms = order[i:]
        rem_ub = suffix[i]
        tdocs = np.unique(np.concatenate(touched))
        cand = tdocs[scores[tdocs] + rem_ub >= theta]
        in_cand = np.zeros(self.num_docs, dtype=bool)
        in_cand[cand] = True
        for t in rem_terms:
            docs, tfs = self.postings(t)
            m = in_cand[docs]
            if not m.any():
                continue
            d2, tf2 = docs[m], tfs[m]
            contrib = self.idf(t) * tf2 * (K1 + 1.0) / (tf2 + norm[d2])
            np.add.at(scores, d2, contrib.astype(np.float32))
        return scores

    # ---- term machinery ------------------------------------------------
    def term_ids(self, tokens: list[str], fuzziness: int = 0, max_expansions: int = 50) -> list[list[int]]:
        """Per query-token list of matching term ids (fuzzy expansion)."""
        out = []
        for tok in tokens:
            tid = self.vocab.get(tok)
            if tid is not None or fuzziness == 0:
                out.append([tid] if tid is not None else [])
                continue
            out.append(self._fuzzy_expand(tok, fuzziness, max_expansions))
        return out

    def _fuzzy_expand(self, token: str, fuzziness: int, max_expansions: int) -> list[int]:
        cands = []
        lo, hi = len(token) - fuzziness, len(token) + fuzziness
        for term, tid in self.vocab.items():
            if not (lo <= len(term) <= hi):
                continue
            if _levenshtein_leq(token, term, fuzziness):
                cands.append((self.df[tid], tid))
                if len(cands) >= max_expansions * 4:
                    break
        cands.sort(reverse=True)  # most frequent expansions first
        return [tid for _, tid in cands[:max_expansions]]

    def postings(self, tid: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.postings_offsets[tid], self.postings_offsets[tid + 1]
        return self.postings_docs[s:e], self.postings_tf[s:e]

    def term_positions(self, tid: int, posting_idx: np.ndarray) -> list[np.ndarray]:
        assert self.pos_offsets is not None and self.positions is not None
        s = self.postings_offsets[tid]
        out = []
        for pi in posting_idx:
            a, b = self.pos_offsets[s + pi], self.pos_offsets[s + pi + 1]
            out.append(self.positions[a:b])
        return out

    # ---- scoring -------------------------------------------------------
    def idf(self, tid: int) -> float:
        df = float(self.df[tid])
        return float(np.log(1.0 + (self.num_docs - df + 0.5) / (df + 0.5)))

    def score_match(self, query: str, operator: Operator = Operator.OR, fuzziness: int = 0, max_expansions: int = 50) -> np.ndarray:
        tokens = self.tokenizer.tokenize(query)
        scores = np.zeros(self.num_docs, dtype=np.float32)
        if not tokens:
            return scores
        groups = self.term_ids(tokens, fuzziness, max_expansions)
        if operator == Operator.AND and any(not tids for tids in groups):
            # A required term with no postings is an unsatisfiable clause:
            # 'quick AND zzzz' matches nothing (tantivy/lance semantics).
            # Stopwords never reach here — the tokenizer drops them.
            return scores
        match_count = np.zeros(self.num_docs, dtype=np.int32) if operator == Operator.AND else None
        norm = K1 * (1.0 - B + B * self.doc_lens / max(self.avgdl, 1e-9))
        n_groups_with_terms = 0
        for tids in groups:
            if not tids:
                continue
            n_groups_with_terms += 1
            group_hit = None
            for tid in tids:
                docs, tfs = self.postings(tid)
                contrib = self.idf(tid) * tfs * (K1 + 1.0) / (tfs + norm[docs])
                np.add.at(scores, docs, contrib.astype(np.float32))
                if match_count is not None:
                    if group_hit is None:
                        group_hit = np.zeros(self.num_docs, dtype=bool)
                    group_hit[docs] = True
            if match_count is not None and group_hit is not None:
                match_count += group_hit
        if match_count is not None:
            scores[match_count < n_groups_with_terms] = 0.0
        return scores

    def score_phrase(self, query: str, slop: int = 0) -> np.ndarray:
        if self.positions is None:
            raise InvalidInputError(
                "phrase queries need an FTS index built with with_position=True"
            )
        tokens = self.tokenizer.tokenize(query)
        scores = np.zeros(self.num_docs, dtype=np.float32)
        if not tokens:
            return scores
        tids = [self.vocab.get(t) for t in tokens]
        if any(t is None for t in tids):
            return scores
        if len(tids) == 1:
            hit = self.score_match(query)
            return hit
        # candidate docs: intersection of postings
        doc_sets = []
        posting_pos = []  # per term: dict doc -> posting offset index
        for tid in tids:
            docs, _ = self.postings(tid)
            doc_sets.append(docs)
            posting_pos.append({int(d): i for i, d in enumerate(docs)})
        cands = doc_sets[0]
        for ds in doc_sets[1:]:
            cands = np.intersect1d(cands, ds, assume_unique=True)
        bm25 = self.score_match(" ".join(tokens))
        for doc in cands:
            plists = []
            for t_i, tid in enumerate(tids):
                pi = posting_pos[t_i][int(doc)]
                plists.append(np.asarray(self.term_positions(tid, np.array([pi]))[0], dtype=np.int64))
            if _phrase_match(plists, slop):
                scores[doc] = bm25[doc]
        return scores

    # ---- persistence ---------------------------------------------------
    def save(self, store, prefix: str) -> None:
        store.write_bytes(
            f"{prefix}/vocab.json",
            json.dumps(sorted(self.vocab, key=self.vocab.get)).encode(),
        )
        _save_ints(store, f"{prefix}/df.npy", self.df)
        _save_ints(store, f"{prefix}/postings_offsets.npy", self.postings_offsets)
        _save_ints(store, f"{prefix}/postings_docs.npy", self.postings_docs)
        _save_ints(store, f"{prefix}/postings_tf.npy", self.postings_tf)
        _save_ints(store, f"{prefix}/doc_lens.npy", self.doc_lens)
        _save_ints(store, f"{prefix}/doc_rowids.npy", self.doc_rowids.view(np.int64))
        if self.pos_offsets is not None:
            _save_ints(store, f"{prefix}/pos_offsets.npy", self.pos_offsets)
            _save_ints(store, f"{prefix}/positions.npy", self.positions)

    @staticmethod
    def load(store, prefix: str, tokenizer: Tokenizer, with_position: bool) -> "ColumnFtsIndex":
        vocab_list = json.loads(store.read_bytes(f"{prefix}/vocab.json"))
        pos_offsets = positions = None
        if with_position:
            pos_offsets = np.asarray(_load_ints(store, f"{prefix}/pos_offsets.npy"))
            positions = np.asarray(_load_ints(store, f"{prefix}/positions.npy"))
        return ColumnFtsIndex(
            vocab={t: i for i, t in enumerate(vocab_list)},
            df=np.asarray(_load_ints(store, f"{prefix}/df.npy")),
            postings_offsets=np.asarray(_load_ints(store, f"{prefix}/postings_offsets.npy")),
            postings_docs=np.asarray(_load_ints(store, f"{prefix}/postings_docs.npy")),
            postings_tf=np.asarray(_load_ints(store, f"{prefix}/postings_tf.npy")),
            doc_lens=np.asarray(_load_ints(store, f"{prefix}/doc_lens.npy")),
            doc_rowids=np.asarray(_load_ints(store, f"{prefix}/doc_rowids.npy")).view(np.uint64),
            tokenizer=tokenizer,
            pos_offsets=pos_offsets,
            positions=positions,
        )


def _phrase_match(plists: list[np.ndarray], slop: int) -> bool:
    """Do the terms appear consecutively (within slop)?"""
    if slop == 0:
        base = plists[0]
        ok = base
        for i, pl in enumerate(plists[1:], start=1):
            ok = ok[np.isin(ok + i, pl)]
            if len(ok) == 0:
                return False
        return True
    # slop: greedy window check
    base = plists[0]
    for start in base:
        pos = start
        good = True
        for i, pl in enumerate(plists[1:], start=1):
            nxt = pl[(pl > pos) & (pl <= start + i + slop)]
            if len(nxt) == 0:
                good = False
                break
            pos = nxt[0]
        if good:
            return True
    return False


def _levenshtein_leq(a: str, b: str, k: int) -> bool:
    if abs(len(a) - len(b)) > k:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        best = cur[0]
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            best = min(best, cur[j])
        if best > k:
            return False
        prev = cur
    return prev[-1] <= k


# -------------------------------------------------------------------- build


def _build_column_index(
    texts: list[str | None],
    doc_rowids: np.ndarray,
    tokenizer: Tokenizer,
    with_position: bool,
) -> ColumnFtsIndex:
    """Build the CSR postings for one column — native C++ builder when
    the tokenizer configuration permits (simple/English), python loop
    otherwise. Both produce identical structures (tested)."""
    use_native = (
        tokenizer.base == "simple"
        and tokenizer.language.lower() == "english"
        # list<string> docs need per-element position gaps (python path)
        and not any(isinstance(t, (list, tuple)) for t in texts)
    )
    if use_native:
        from ..native import fts_build_native

        if tokenizer.ascii_folding:
            from .tokenizer import _ascii_fold

            texts = [(_ascii_fold(t) if t else t) for t in texts]
        res = fts_build_native(
            texts,
            lower_case=tokenizer.lower_case,
            stem=tokenizer.stem,
            remove_stop_words=tokenizer.remove_stop_words,
            max_token_length=tokenizer.max_token_length,
            with_positions=with_position,
        )
        if res is not None:
            vocab_list, df, post_offsets, post_docs, post_tf, pos_offsets, positions, doc_lens = res
            return ColumnFtsIndex(
                vocab={t: i for i, t in enumerate(vocab_list)},
                df=df,
                postings_offsets=post_offsets,
                postings_docs=post_docs,
                postings_tf=post_tf,
                doc_lens=doc_lens,
                doc_rowids=doc_rowids,
                tokenizer=tokenizer,
                pos_offsets=pos_offsets if with_position else None,
                positions=positions if with_position else None,
            )
    # ---- pure-python fallback (and non-simple tokenizers) ----
    vocab: dict[str, int] = {}
    post: list[dict[int, list[int]]] = []  # tid -> {doc: positions}
    doc_lens_l: list[int] = []
    for doc_idx, text in enumerate(texts):
        if isinstance(text, (list, tuple)):
            # list<string> doc: tokenize each element separately with a
            # +1 position gap so phrase queries never match across
            # element boundaries (reference fts-on-list semantics)
            toks: list[str] = []
            tok_positions: list[int] = []
            pos_base = 0
            for el in text:
                el_toks = tokenizer.tokenize(el)
                toks.extend(el_toks)
                tok_positions.extend(pos_base + j for j in range(len(el_toks)))
                pos_base += len(el_toks) + 1
        else:
            toks = tokenizer.tokenize(text)
            tok_positions = list(range(len(toks)))
        doc_lens_l.append(len(toks))
        for pos, tok in zip(tok_positions, toks):
            tid = vocab.get(tok)
            if tid is None:
                tid = len(vocab)
                vocab[tok] = tid
                post.append({})
            post[tid].setdefault(doc_idx, []).append(pos)
    T = len(vocab)
    df = np.zeros(T, dtype=np.int32)
    for tid in range(T):
        df[tid] = len(post[tid])
    offsets = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(df.astype(np.int64), out=offsets[1:])
    P = int(offsets[-1])
    p_docs = np.zeros(P, dtype=np.int32)
    p_tf = np.zeros(P, dtype=np.float32)
    pos_counts = np.zeros(P, dtype=np.int64)
    w = 0
    for tid in range(T):
        for doc, positions in sorted(post[tid].items()):
            p_docs[w] = doc
            p_tf[w] = len(positions)
            pos_counts[w] = len(positions)
            w += 1
    pos_offsets = positions_arr = None
    if with_position:
        pos_offsets = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(pos_counts, out=pos_offsets[1:])
        positions_arr = np.zeros(int(pos_offsets[-1]), dtype=np.int32)
        w = 0
        for tid in range(T):
            for doc, positions in sorted(post[tid].items()):
                a = pos_offsets[w]
                positions_arr[a : a + len(positions)] = positions
                w += 1
    return ColumnFtsIndex(
        vocab=vocab,
        df=df,
        postings_offsets=offsets,
        postings_docs=p_docs,
        postings_tf=p_tf,
        doc_lens=np.asarray(doc_lens_l, dtype=np.int32),
        doc_rowids=doc_rowids,
        tokenizer=tokenizer,
        pos_offsets=pos_offsets,
        positions=positions_arr,
    )


def build_fts_index(dataset, columns: list[str], config, name: str | None = None) -> IndexMeta:
    """Tokenize + build CSR postings for each text column; persist."""
    t0 = time.time()
    tokenizer = Tokenizer(
        base=config.base_tokenizer,
        lower_case=config.lower_case,
        stem=config.stem,
        remove_stop_words=config.remove_stop_words,
        ascii_folding=config.ascii_folding,
        max_token_length=config.max_token_length,
        language=config.language,
        ngram_min_length=config.ngram_min_length,
        ngram_max_length=config.ngram_max_length,
        prefix_only=config.prefix_only,
        dict_path=getattr(config, "dict_path", None),
    )
    for c in columns:
        f = dataset.schema.field(c) if c in dataset.schema.names else None
        if f is None:
            raise InvalidInputError(f"no column {c!r}")
        ok = pa.types.is_string(f.type) or pa.types.is_large_string(f.type)
        if not ok and (pa.types.is_list(f.type) or pa.types.is_large_list(f.type)):
            vt = f.type.value_type
            ok = pa.types.is_string(vt) or pa.types.is_large_string(vt)
        if not ok:
            raise InvalidInputError(
                f"FTS column {c!r} must be a string or list<string> column, got {f.type}"
            )
    uuid = new_uuid()
    store = dataset.store
    prefix = dataset.index_dir(uuid)
    frag_ids = []
    n_docs_total = 0
    for col_i, column in enumerate(columns):
        texts: list[str | None] = []
        doc_rowids: list[int] = []
        frag_ids = []
        for meta, tbl in dataset.scan_fragments(columns=[column], with_row_id=True):
            frag_ids.append(meta.id)
            texts.extend(tbl.column(column).to_pylist())
            doc_rowids.extend(int(r) for r in tbl.column("_rowid").to_numpy())
        n_docs_total = len(texts)
        col_index = _build_column_index(
            texts, np.asarray(doc_rowids, dtype=np.uint64), tokenizer, config.with_position
        )
        col_index.save(store, f"{prefix}/col{col_i}")
    params = {
        "columns": columns,
        "tokenizer": tokenizer.to_json(),
        # the scheme the postings were ACTUALLY segmented with (a jieba/
        # lindera base can silently degrade to bigrams) — verified at load
        "effective_scheme": tokenizer.effective_scheme(),
        "with_position": config.with_position,
        "num_docs": n_docs_total,
        "build_seconds": time.time() - t0,
    }
    store.write_bytes(f"{prefix}/meta.json", json.dumps(params).encode())
    return IndexMeta(
        name=name or f"{columns[0]}_fts_idx",
        uuid=uuid,
        columns=columns,
        index_type="FTS",
        params=params,
        fragment_ids=frag_ids,
        num_indexed_rows=n_docs_total,
        created_at=time.time(),
    )


class FtsIndex:
    """Loaded multi-column FTS index."""

    def __init__(self, store, prefix: str, meta: IndexMeta):
        self.meta = meta
        params = json.loads(store.read_bytes(f"{prefix}/meta.json"))
        self.columns = params["columns"]
        self.tokenizer = Tokenizer.from_json(params["tokenizer"])
        built_scheme = params.get("effective_scheme")
        if built_scheme is not None:
            now_scheme = self.tokenizer.effective_scheme()
            if built_scheme == "unicode" and now_scheme == "uax29":
                # index persisted before the UAX #29 segmenter: query it
                # with the \w+ segmentation its postings were built with
                self.tokenizer.legacy_unicode = True
                now_scheme = self.tokenizer.effective_scheme()
            if built_scheme == "cjk-bigram" and now_scheme.startswith("mm-dict:"):
                # lindera index persisted before the bundled Japanese
                # seed lexicon: its postings are character bigrams
                self.tokenizer.legacy_bigram = True
                now_scheme = self.tokenizer.effective_scheme()
            if now_scheme != built_scheme:
                raise InvalidInputError(
                    f"FTS index was built with tokenization scheme "
                    f"{built_scheme!r} but this environment resolves the same "
                    f"tokenizer config to {now_scheme!r} (dictionary engine "
                    f"missing or dict_path unreadable). Querying would "
                    f"mis-match the persisted postings — restore the engine/"
                    f"dictionary or rebuild the index."
                )
        self.with_position = params["with_position"]
        self.by_column = {
            col: ColumnFtsIndex.load(store, f"{prefix}/col{i}", self.tokenizer, self.with_position)
            for i, col in enumerate(self.columns)
        }

    def default_column(self) -> str:
        return self.columns[0]

    def evaluate(self, node: FtsQueryNode) -> tuple[np.ndarray, "ColumnFtsIndex"]:
        """Recursive evaluation → (scores over docs, column index used)."""
        if isinstance(node, MatchQuery):
            col = node.column or self.default_column()
            ix = self._col(col)
            s = ix.score_match(node.query, node.operator, node.fuzziness, node.max_expansions)
            return s * node.boost, ix
        if isinstance(node, PhraseQuery):
            col = node.column or self.default_column()
            ix = self._col(col)
            return ix.score_phrase(node.query, node.slop), ix
        if isinstance(node, MultiMatchQuery):
            ix0 = self._col(node.columns[0])
            total = None
            for col, boost in zip(node.columns, node.boosts):
                s, _ = self.evaluate(MatchQuery(node.query, col, boost=boost, operator=node.operator))
                total = s if total is None else np.maximum(total, s)
            return total, ix0
        if isinstance(node, BoostQuery):
            pos, ix = self.evaluate(node.positive)
            neg, _ = self.evaluate(node.negative)
            return pos - node.negative_boost * neg, ix
        if isinstance(node, BooleanQuery):
            ix = None
            total = None
            must_mask = None
            not_mask = None
            for occur, sub in node.queries:
                s, ixs = self.evaluate(sub)
                ix = ix or ixs
                if occur == Occur.MUST_NOT:
                    m = s > 0
                    not_mask = m if not_mask is None else (not_mask | m)
                    continue
                total = s if total is None else total + s
                if occur == Occur.MUST:
                    m = s > 0
                    must_mask = m if must_mask is None else (must_mask & m)
            if total is None:
                total = np.zeros(ix.num_docs if ix else 0, dtype=np.float32)
            if must_mask is not None:
                total = np.where(must_mask, total, 0.0)
            if not_mask is not None:
                total = np.where(not_mask, 0.0, total)
            return total, ix
        raise InvalidInputError(f"unsupported FTS query node {type(node)}")

    def _col(self, col: str) -> ColumnFtsIndex:
        if col not in self.by_column:
            raise InvalidInputError(
                f"column {col!r} is not part of this FTS index ({self.columns})"
            )
        return self.by_column[col]


def load_fts_index(dataset, meta: IndexMeta) -> FtsIndex:
    return FtsIndex(dataset.store, dataset.index_dir(meta.uuid), meta)


# ------------------------------------------------------------------- query


def _ast_columns(query) -> set[str]:
    """Columns a structured FTS query references (empty for strings /
    column-less nodes — any index serves those)."""
    from ..query_fts import (
        BooleanQuery as _BQ,
        BoostQuery as _Boost,
        MatchQuery as _MQ,
        MultiMatchQuery as _MMQ,
        PhraseQuery as _PQ,
    )

    if isinstance(query, (_MQ, _PQ)):
        return {query.column} if query.column else set()
    if isinstance(query, _MMQ):
        return set(query.columns)
    if isinstance(query, _Boost):
        return _ast_columns(query.positive) | _ast_columns(query.negative)
    if isinstance(query, _BQ):
        out: set[str] = set()
        for _, sub in query.queries:
            out |= _ast_columns(sub)
        return out
    return set()


def execute_fts_query(
    table,
    query,
    columns=None,
    k: int = 10,
    offset: int = 0,
    filter: str | None = None,
    prefilter: bool = True,
    select=None,
    with_row_id: bool = False,
) -> pa.Table:
    """FTS execution pipeline (reference SURVEY.md §3.2 hybrid FTS leg)."""
    ds = table._dataset
    # index selection honors the columns the QUERY actually touches —
    # an AST query names its own columns (MatchQuery.column,
    # MultiMatchQuery.columns), so pick an index covering all of them
    need = set(columns) if columns else _ast_columns(query)
    candidates = [ix for ix in ds.manifest.indices if ix.index_type == "FTS"]
    fts_meta = next(
        (ix for ix in candidates if not need or need <= set(ix.columns)), None
    )
    if fts_meta is None:
        if candidates:
            have = sorted({c for ix in candidates for c in ix.columns})
            raise InvalidInputError(
                f"no FTS index covers columns {sorted(need)} (indexed: {have}); "
                f"build one combined index: create_fts_index({sorted(need)})"
            )
        raise InvalidInputError(
            "this table has no FTS index; call create_fts_index() first"
        )
    fts = table._get_fts_index(fts_meta)
    node = parse_string_query(query, columns or fts.columns) if isinstance(query, str) else query
    # Native DAAT top-k paths (exact; skip dense score arrays):
    #  * OR MatchQuery on big corpora — MaxScore pruning
    #  * AND MatchQuery — galloping intersection (any size: the python
    #    fallback builds dense per-group bool arrays)
    #  * PhraseQuery — intersection + C++ positional verification (the
    #    python fallback walks candidate docs in a dict loop)
    use_pruned = (
        isinstance(node, MatchQuery)
        and node.operator == Operator.OR
        and node.fuzziness == 0
        and filter is None
        and node.boost == 1.0
    )
    use_and = (
        isinstance(node, MatchQuery)
        and node.operator == Operator.AND
        and node.fuzziness == 0
        and filter is None
        and node.boost == 1.0
    )
    use_phrase = isinstance(node, PhraseQuery) and filter is None
    native_hits = None
    with span("fts.score") as sc:
        if use_pruned:
            col = node.column or fts.default_column()
            col_ix = fts._col(col)
            if col_ix.num_docs >= 65536:
                dead_mask = _dead_doc_mask(ds, fts_meta, col_ix)
                native_hits = col_ix.topk_match_native(node.query, k + offset, dead_mask)
                path = "native_or"
                if native_hits is None:
                    scores = col_ix.score_match_topk(node.query, k + offset)
                    path = "maxscore"
            else:
                use_pruned = False
        elif use_and:
            col = node.column or fts.default_column()
            col_ix = fts._col(col)
            dead_mask = _dead_doc_mask(ds, fts_meta, col_ix)
            native_hits = col_ix.topk_and_native(node.query, k + offset, dead_mask)
            use_pruned = native_hits is not None
            path = "native_and"
        elif use_phrase:
            col = node.column or fts.default_column()
            col_ix = fts._col(col)
            if col_ix.pos_offsets is None:
                raise InvalidInputError(
                    "phrase queries need an FTS index built with with_position=True"
                )
            dead_mask = _dead_doc_mask(ds, fts_meta, col_ix)
            native_hits = col_ix.topk_phrase_native(
                node.query, k + offset, slop=node.slop, dead=dead_mask
            )
            use_pruned = native_hits is not None
            path = "native_phrase"
        if not use_pruned:
            scores, col_ix = fts.evaluate(node)
            path = "evaluate"
        sc.set(path=path)
    rec = recorder()
    rec.increment_counter("lancedb.fts.queries")
    rec.increment_counter("lancedb.fts.postings", float(_query_postings(fts, node)))

    if native_hits is not None:
        # the native DAAT scorer already skipped dead docs and returned
        # exact descending top-(k+offset)
        top, hit_scores = native_hits
        top = top[hit_scores > 0][offset:]
        hit_scores = hit_scores[hit_scores > 0][offset:]
        rowids = col_ix.doc_rowids[top]
    else:
        # mask deleted + prefiltered docs
        allowed = None
        if filter is not None and prefilter:
            # the vector leg's prefilter: a scalar index serves both legs
            from ..query import compute_allowed_rowids

            allowed = compute_allowed_rowids(table, filter)
        dead_mask = _dead_doc_mask(ds, fts_meta, col_ix)
        if dead_mask is not None:
            scores = np.where(dead_mask, 0.0, scores)
        if allowed is not None:
            ok = np.isin(col_ix.doc_rowids, allowed)
            scores = np.where(ok, scores, 0.0)

        # O(N) partial selection instead of a full argsort
        kk = min(k + offset, len(scores))
        if kk < len(scores):
            part = np.argpartition(-scores, kk - 1)[:kk] if kk else np.empty(0, np.int64)
            top = part[np.argsort(-scores[part], kind="stable")]
        else:
            top = np.argsort(-scores, kind="stable")[:kk]
        top = top[scores[top] > 0]
        top = top[offset:]
        rowids = col_ix.doc_rowids[top]
        hit_scores = scores[top]

    cols = list(select) if isinstance(select, (list, tuple)) else None
    data = ds.take_rows(rowids, columns=cols)
    if isinstance(select, dict):
        from ..filters.eval import evaluate_expression

        base = ds.take_rows(rowids, columns=None)
        data = pa.table({a: evaluate_expression(base, e) for a, e in select.items()})
    data = data.append_column("_score", pa.array(hit_scores.astype(np.float32)))
    if with_row_id:
        data = data.append_column("_rowid", pa.array(rowids, type=pa.uint64()))
    if filter is not None and not prefilter and data.num_rows:
        from ..filters.eval import evaluate_predicate_mask

        mask = evaluate_predicate_mask(data, filter)
        data = data.filter(pa.array(mask))
    return data


def _query_postings(fts, node) -> int:
    """The summed df of a match or phrase query's distinct terms, the
    postings its scorer may visit (0 for the other query nodes)."""
    if not isinstance(node, (MatchQuery, PhraseQuery)):
        return 0
    ix = fts._col(node.column or fts.default_column())
    tids = {ix.vocab.get(t) for t in ix.tokenizer.tokenize(node.query)} - {None}
    return int(np.asarray(ix.df)[sorted(tids)].sum()) if tids else 0


def _dead_doc_mask(ds, fts_meta, col_ix) -> np.ndarray | None:
    """Docs the index still carries but reads must skip: rows of
    vanished fragments plus rows deleted in live fragments.

    The mask is a pure function of the dataset version (manifest
    fragments + deletion vectors), so it caches on the column index —
    recomputing it per query was >60% of FTS query latency at 1M docs
    (np.isin over every doc's rowid)."""
    cache = getattr(col_ix, "_dead_mask_cache", None)
    key = ds.version
    if cache is not None and cache[0] == key:
        return cache[1]
    mask = _dead_doc_mask_uncached(ds, fts_meta, col_ix)
    col_ix._dead_mask_cache = (key, mask)
    return mask


def _dead_doc_mask_uncached(ds, fts_meta, col_ix) -> np.ndarray | None:
    live_frags = {f.id for f in ds.manifest.fragments}
    frag_of = (col_ix.doc_rowids >> np.uint64(32)).astype(np.int64)
    out = None
    if live_frags:
        gone = ~np.isin(frag_of, np.fromiter(live_frags, dtype=np.int64))
        if gone.any():
            out = gone
    deleted = _deleted_doc_mask(ds, fts_meta, col_ix)
    if deleted is not None:
        out = deleted if out is None else (out | deleted)
    return out


def _deleted_doc_mask(ds, fts_meta, col_ix) -> np.ndarray | None:
    out = None
    for meta in ds.manifest.fragments:
        keep = ds._keep_mask(meta)
        if keep is None:
            continue
        gone = np.nonzero(~keep)[0].astype(np.uint64)
        dead_rids = (np.uint64(meta.id) << np.uint64(32)) | gone
        m = np.isin(col_ix.doc_rowids, dead_rids)
        out = m if out is None else (out | m)
    return out
