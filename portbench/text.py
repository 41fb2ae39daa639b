"""The text of a configuration's ``text`` group, drawn from ``--seed``: one
passage a row and a short query text for each pair of the pool.

A word is a rank drawn by Zipf's law with exponent ``exponent``, truncated
at ``vocab`` ranks, through the law's inverse CDF from uniform draws (the
CDF is computed in float64 on the host, so every machine has the same
table; ``Generator.zipf`` is not used, since its stream differs between
numpy versions). Ranks 1 up to ``len(STOP_WORDS)`` are the English stop
words that the port's default tokenizer removes, in alphabetical order;
every other rank r is the word ``w<r>``. A passage has a length drawn
uniformly from ``doc_words``; a query has ``query_words`` words.

Rows are drawn a block of ``data.BLOCK_ROWS`` at a time from a seed of
their block, so the reference draws any block's ranks again alone. The
text column is built straight from the ranks: a table of each word's
bytes, the offsets by cumulative length, one gather; no Python string is
made for a passage."""

from __future__ import annotations

import functools

import numpy as np
import pyarrow as pa
import torch

from portbench import data

# Lucene's English stop words (the port's tokenizer drops exactly these),
# in alphabetical order: ranks 1-33
STOP_WORDS = tuple(sorted(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()))


def words(vocab: int) -> list[str]:
    """The word of each rank 1..``vocab``, at index rank - 1."""
    return list(STOP_WORDS) + [f"w{r}" for r in range(len(STOP_WORDS) + 1, vocab + 1)]


def zipf_cdf(vocab: int, exponent: float) -> np.ndarray:
    """P(rank <= r) for r = 1..vocab, float64, the last entry exactly 1."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(exponent)
    cdf = np.cumsum(p) / p.sum()
    cdf[-1] = 1.0
    return cdf


class TextDraw:
    """The seeded text of one configuration on ``device``: ``block(b)``
    gives the ranks of a block of rows, ``queries()`` those of the pool."""

    def __init__(self, cfg: dict, seed: int, device):
        t = cfg["text"]
        self.device = torch.device(device)
        self.n = int(cfg["rows"])
        self.vocab = int(t["vocab"])
        self.lo, self.hi = (int(v) for v in t["doc_words"])
        self.query_words = int(t["query_words"])
        self.pool = int(cfg["query_pool"])
        self.cdf = torch.from_numpy(zipf_cdf(self.vocab, t["exponent"])).to(self.device)
        # seeds of their own, apart from the vectors' (data.Draw)
        base = (int(seed) * 2_654_435_761 + 0x7E47) & 0x3FFF_FFFF_FFFF_FFFF
        self.block_seeds = [base + 1 + b for b in range(self.n // data.BLOCK_ROWS + 2)]

    @property
    def num_blocks(self) -> int:
        return -(-self.n // data.BLOCK_ROWS)

    @functools.cached_property
    def word_bytes(self) -> "WordBytes":
        return WordBytes(self.vocab, self.device)

    def _ranks(self, count: int, g: torch.Generator) -> torch.Tensor:
        u = torch.rand(count, generator=g, device=self.device, dtype=torch.float64)
        r = torch.searchsorted(self.cdf, u, right=True)
        return torch.clamp(r, max=self.vocab - 1) + 1  # 1-based ranks

    def block(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(the word count of each row (R,) int64, the ranks (sum,) int64) of rows
        ``b * BLOCK_ROWS`` up to the next block, on the device."""
        rows = min(self.n, (b + 1) * data.BLOCK_ROWS) - b * data.BLOCK_ROWS
        g = data.generator(self.block_seeds[b], self.device)
        lengths = torch.randint(self.lo, self.hi + 1, (rows,), generator=g, device=self.device)
        return lengths, self._ranks(int(lengths.sum()), g)

    def queries(self) -> torch.Tensor:
        """The pool's query words, (pool, query_words) int64 ranks."""
        g = data.generator(self.block_seeds[-1], self.device)
        return self._ranks(self.pool * self.query_words, g).view(self.pool, self.query_words)

    def ranks_of(self, ids: np.ndarray) -> list[np.ndarray]:
        """The ranks of rows ``ids``, each row's own array, drawn again."""
        ids = np.asarray(ids, np.int64)
        out: list[np.ndarray] = [np.empty(0, np.int64)] * len(ids)
        blocks = ids // data.BLOCK_ROWS
        for b in np.unique(blocks):
            lengths, ranks = (v.cpu().numpy() for v in self.block(int(b)))
            starts = np.concatenate([[0], np.cumsum(lengths)])
            for j in np.flatnonzero(blocks == b):
                r = ids[j] - b * data.BLOCK_ROWS
                out[j] = ranks[starts[r]:starts[r + 1]]
        return out


class WordBytes:
    """Each rank's word as bytes, for building strings from ranks."""

    def __init__(self, vocab: int, device):
        ws = [w.encode() for w in words(vocab)]
        width = max(len(w) for w in ws) + 1
        # column 0 is the space before a word; the word follows
        table = np.full((vocab + 1, width), ord(" "), np.uint8)
        lens = np.zeros(vocab + 1, np.int64)
        for r, w in enumerate(ws, start=1):
            table[r, 1:1 + len(w)] = np.frombuffer(w, np.uint8)
            lens[r] = len(w)
        self.table = torch.from_numpy(table).to(device)
        self.lens = torch.from_numpy(lens).to(device)

    def column(self, lengths: torch.Tensor, ranks: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """(offsets (R + 1,) int64, bytes) of the rows whose words are
        ``ranks`` split by ``lengths``, words joined by one space."""
        dev = ranks.device
        first = torch.zeros(len(ranks), dtype=torch.bool, device=dev)
        row_start = torch.cumsum(lengths, 0) - lengths
        first[row_start[lengths > 0]] = True
        lead = (~first).long()  # a space before every word but a row's first
        tok_len = self.lens[ranks] + lead
        tok_end = torch.cumsum(tok_len, 0)
        total = int(tok_end[-1]) if len(tok_end) else 0
        tok = torch.repeat_interleave(torch.arange(len(ranks), device=dev), tok_len)
        pos = torch.arange(total, device=dev) - (tok_end - tok_len)[tok] + (1 - lead)[tok]
        out = self.table[ranks[tok], pos]
        row_bytes = torch.zeros(len(lengths), dtype=torch.long, device=dev)
        row_bytes.index_add_(0, torch.repeat_interleave(
            torch.arange(len(lengths), device=dev), lengths), tok_len)
        offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(row_bytes, 0)])
        return offsets.cpu().numpy(), out.cpu().numpy()


def strings(lengths: torch.Tensor, ranks: torch.Tensor, wb: WordBytes) -> pa.Array:
    """Rows of words as a ``large_string`` Arrow array."""
    offsets, raw = wb.column(lengths, ranks)
    return pa.LargeStringArray.from_buffers(len(offsets) - 1, pa.py_buffer(offsets),
                                            pa.py_buffer(raw))


def text_column(td: TextDraw) -> pa.ChunkedArray:
    """Every row's passage, a chunk a block."""
    return pa.chunked_array([strings(*td.block(b), td.word_bytes) for b in range(td.num_blocks)],
                            type=pa.large_string())


def query_texts(td: TextDraw) -> list[str]:
    """The pool's query texts."""
    q = td.queries()
    lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.long, device=q.device)
    return strings(lengths, q.reshape(-1), td.word_bytes).to_pylist()
