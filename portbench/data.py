"""The rows and the query pool of a configuration, drawn on the device
from ``--seed`` in a few large calls.

A torch copy of the reference bench's ``make_clustered`` (``bench.py:376``,
``lancedb_tpu_torch/probes/common.py:38``): a per-dimension spectrum,
``n_coarse`` coarse centres, ``n_parents`` parents each a coarse centre
plus ``parent_noise`` x normal noise, every row a parent plus
``row_noise`` x normal noise, scaled by the spectrum; queries are drawn
near parents the same way. One change: parents are dealt to coarse
centres, and rows to parents, in equal shares (a seeded permutation of
``arange % count``), where the bench draws them at random. So every seed
has the same cluster sizes in another order, and the seed changes the
data but not the amount of work. Cosine configurations hold unit rows.

The same seed gives the same bits on the same device: the reference draws
the rows again after the window instead of keeping a copy."""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 17


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def _spectrum(dim: int, device) -> torch.Tensor:
    s = (torch.arange(dim, dtype=torch.float64, device=device) + 1.0) ** -0.5
    return (s / torch.linalg.vector_norm(s) * dim ** 0.5).float()


def _dealt(count: int, owners: int, g: torch.Generator, device) -> torch.Tensor:
    """``count`` owner ids in equal shares (counts differ by at most one),
    in a seeded order."""
    perm = torch.randperm(count, generator=g, device=device)
    return perm % owners


class Draw:
    """The seeded structure of one configuration's data on ``device``;
    ``rows(start, stop)`` and ``queries()`` draw from it in a fixed order,
    so ``rows`` of the same block always gives the same bits."""

    def __init__(self, cfg: dict, seed: int, device):
        d = cfg["data"]
        self.cfg, self.device = cfg, torch.device(device)
        self.n, self.dim = int(cfg["rows"]), int(cfg["dim"])
        self.unit = cfg["metric"] == "cosine"
        g = generator(seed, self.device)
        self.spectrum = _spectrum(self.dim, self.device)
        coarse = torch.randn((d["n_coarse"], self.dim), generator=g, device=self.device)
        owner = _dealt(d["n_parents"], d["n_coarse"], g, self.device)
        self.parents = coarse[owner] + d["parent_noise"] * torch.randn(
            (d["n_parents"], self.dim), generator=g, device=self.device)
        self.parent_of_row = _dealt(self.n, d["n_parents"], g, self.device)
        self.query_parents = torch.randint(0, d["n_parents"], (int(cfg["query_pool"]),),
                                           generator=g, device=self.device)
        # one seed a block of rows and one for the queries, so that any
        # block can be drawn again alone
        base = (int(seed) * 1_000_003) & 0x3FFF_FFFF_FFFF_FFFF
        self.block_seeds = [base + 1 + b for b in range(self.n // BLOCK_ROWS + 2)]
        self.row_noise = float(d["row_noise"])

    def _near(self, parent_ids: torch.Tensor, seed: int) -> torch.Tensor:
        g = generator(seed, self.device)
        noise = torch.randn((len(parent_ids), self.dim), generator=g, device=self.device)
        x = (self.parents[parent_ids] + self.row_noise * noise) * self.spectrum
        if self.unit:
            x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-30)
        return x

    def block(self, b: int) -> torch.Tensor:
        """Rows ``b * BLOCK_ROWS`` up to the next block (f32, on the device)."""
        start = b * BLOCK_ROWS
        stop = min(self.n, start + BLOCK_ROWS)
        return self._near(self.parent_of_row[start:stop], self.block_seeds[b])

    def rows(self) -> torch.Tensor:
        """Every row, (N, D) f32 on the device."""
        return torch.cat([self.block(b) for b in range(self.num_blocks)])

    @property
    def num_blocks(self) -> int:
        return -(-self.n // BLOCK_ROWS)

    def queries(self) -> torch.Tensor:
        return self._near(self.query_parents, self.block_seeds[-1])


def host_rows(draw: Draw) -> np.ndarray:
    """Every row in host memory, a block at a time from the device."""
    out = np.empty((draw.n, draw.dim), np.float32)
    for b in range(draw.num_blocks):
        start = b * BLOCK_ROWS
        blk = draw.block(b)
        out[start:start + blk.shape[0]] = blk.cpu().numpy()
    return out


def categories(ids: np.ndarray, cfg: dict) -> np.ndarray:
    """The ``category`` column: ``id % category_mod``."""
    return ids % int(cfg["category_mod"])
