"""Plain BM25 over the drawn word ranks, a plain Reciprocal Rank Fusion,
and the numbers of a hybrid search's answers against them.

BM25 as the configuration states it: k1 1.2, b 0.75, idf(t) = ln(1 + (N -
df + 0.5) / (df + 0.5)), a document's length its words less the stop
words, avgdl the mean over every document; a query scores each of its
distinct non-stop words once. The index is built from the ranks alone:
stop-word ranks dropped, each (term, doc) pair counted by ``torch.unique``
over ``term * N + doc``, so the keys come out sorted by term, which makes
them the postings. Scores are sums in float64 (``sum_dtype`` float16 for
the control: each term's part and the sum rounded to float16).

RRF (K 60): the sum of 1 / (K + rank) over the two ranked lists, in order
of falling score, ties in order of first appearance with the vector list
first."""

from __future__ import annotations

import numpy as np
import torch

K1, B = 1.2, 0.75
SCORE_CELLS = 1 << 24  # float64 scores held at once: queries x documents


class Bm25:
    """The inverted index of the drawn text, on the device of ``doc_ids``.

    ``doc_ids`` and ``ranks`` (T,) int64: each word of the corpus, its
    document and its rank; ``n_docs`` documents; ranks up to ``stop_ranks``
    are stop words."""

    def __init__(self, doc_ids: torch.Tensor, ranks: torch.Tensor, n_docs: int,
                 stop_ranks: int):
        self.n = int(n_docs)
        self.stop_ranks = int(stop_ranks)
        keep = ranks > self.stop_ranks
        keys, tf = torch.unique(ranks[keep] * self.n + doc_ids[keep], return_counts=True)
        self.term = keys // self.n
        self.doc = keys % self.n
        vocab = int(ranks.max()) + 1 if len(ranks) else 1
        df = torch.bincount(self.term, minlength=vocab)
        self.df = df
        self.offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=df.device),
                                  torch.cumsum(df, 0)])
        dl = torch.bincount(self.doc, weights=tf.double(), minlength=self.n)
        avgdl = dl.mean()
        idf = torch.log1p((self.n - df.double() + 0.5) / (df.double() + 0.5))
        tf = tf.double()
        self.part = idf[self.term] * tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * dl[self.doc] / avgdl))

    def _terms(self, query_ranks) -> list[torch.Tensor]:
        dev = self.df.device
        out = []
        for q in query_ranks:
            t = torch.unique(torch.as_tensor(np.asarray(q, np.int64), device=dev))
            t = t[(t > self.stop_ranks) & (t < len(self.df))]
            out.append(t[self.df[t] > 0])
        return out

    def postings(self, query_ranks) -> list[int]:
        """The summed df of each query's distinct terms."""
        return [int(self.df[t].sum()) for t in self._terms(query_ranks)]

    def scores(self, query_ranks, sum_dtype=torch.float64):
        """Each chunk of queries with their scores over every document:
        yields (first query, (chunk, N) scores in ``sum_dtype``)."""
        terms = self._terms(query_ranks)
        dev = self.df.device
        chunk = max(1, SCORE_CELLS // self.n)
        part = self.part if sum_dtype == torch.float64 else self.part.to(sum_dtype)
        for s in range(0, len(terms), chunk):
            ts = terms[s:s + chunk]
            out = torch.zeros((len(ts), self.n), dtype=sum_dtype, device=dev)
            q_of = torch.cat([torch.full((len(t),), i, dtype=torch.long, device=dev)
                              for i, t in enumerate(ts)])
            t_all = torch.cat(ts) if ts else torch.zeros(0, dtype=torch.long, device=dev)
            lens = self.df[t_all]
            if int(lens.sum()):
                first = torch.repeat_interleave(self.offsets[t_all], lens)
                within = torch.arange(int(lens.sum()), device=dev) - torch.repeat_interleave(
                    torch.cumsum(lens, 0) - lens, lens)
                idx = first + within
                flat = torch.repeat_interleave(q_of, lens) * self.n + self.doc[idx]
                out.view(-1).index_add_(0, flat, part[idx])
            yield s, out

    def topk(self, query_ranks, k: int, sum_dtype=torch.float64):
        """Each query's k highest-scoring documents with a score above 0
        → (ids (Q, k) int64, -1 past the last hit; scores (Q, k) float64)."""
        nq = len(query_ranks)
        ids = np.full((nq, k), -1, np.int64)
        sc = np.zeros((nq, k), np.float64)
        for s, m in self.scores(query_ranks, sum_dtype):
            v, i = torch.topk(m.double(), min(k, self.n), dim=1)
            v, i = v.cpu().numpy(), i.cpu().numpy()
            hit = v > 0
            ids[s:s + len(m)][:, :v.shape[1]] = np.where(hit, i, -1)
            sc[s:s + len(m)][:, :v.shape[1]] = np.where(hit, v, 0.0)
        return ids, sc

    def judge(self, query_ranks, hit_ids: np.ndarray, hit_scores: np.ndarray, k: int,
              tol: float) -> tuple[int, float]:
        """An FTS leg's hits (Q, k), -1 past the last, against the scores:
        → (``fts_bad``, ``fts_score_gap``). ``fts_bad`` counts hits missing
        or surplus against min(k, documents that match), repeated hits,
        hits that match nothing, hits out of score order, and documents
        missing that score above the lowest hit; ``fts_score_gap`` is the
        largest relative error of a hit's score. Two scores closer than
        ``tol`` (relative) count as tied, so ties may fall either way."""
        bad, gap = 0, 0.0
        hit_ids = np.asarray(hit_ids, np.int64)
        for s, m in self.scores(query_ranks):
            ids = hit_ids[s:s + len(m)]
            valid = ids >= 0
            bad += sum(int(v.sum()) - len(np.unique(r[v])) for r, v in zip(ids, valid))
            n_match = (m > 0).sum(1).cpu().numpy()
            bad += int(np.abs(valid.sum(1) - np.minimum(k, n_match)).sum())
            ref = m.gather(1, torch.from_numpy(np.where(valid, ids, 0)).to(m.device))
            ref = ref.cpu().numpy()
            live = valid & (ref > 0)
            bad += int((valid & ~live).sum())
            if live.any():
                got_sc = np.asarray(hit_scores[s:s + len(m)], np.float64)
                gap = max(gap, float((np.abs(got_sc - ref) / np.where(live, ref, 1.0))[live].max()))
            pair = valid[:, 1:] & valid[:, :-1]
            bad += int((pair & (ref[:, 1:] > ref[:, :-1] * (1 + tol))).sum())
            # documents above the lowest hit that are missing
            cut = np.where(valid, ref, np.inf).min(1) * (1 + tol)
            cut_d = torch.from_numpy(cut).to(m.device, m.dtype)
            above = (m > cut_d[:, None]).sum(1).cpu().numpy()
            got_above = np.array([len(np.unique(r[v & (f > c)]))
                                  for r, v, f, c in zip(ids, valid, ref, cut)])
            bad += int((above - got_above)[np.isfinite(cut)].sum())
        return bad, gap


def rrf(v_ids, f_ids, K: int = 60, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """RRF of two ranked id lists → (ids, scores float64), at most ``k``."""
    ids = np.concatenate([np.asarray(v_ids, np.int64), np.asarray(f_ids, np.int64)])
    ranks = np.concatenate([np.arange(1, len(v_ids) + 1), np.arange(1, len(f_ids) + 1)])
    uniq, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    score = np.zeros(len(uniq))
    np.add.at(score, inv, 1.0 / (K + ranks))
    by_first = np.argsort(first, kind="stable")
    uniq, score = uniq[by_first], score[by_first]
    order = np.argsort(-score, kind="stable")[:k]
    return uniq[order], score[order]
