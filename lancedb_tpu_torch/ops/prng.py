"""The reference's random draws, in torch.

The reference seeds k-means++ with ``jax.random``: the default threefry2x32
key, split and drawn with the partitionable bit layout. This module
computes the same bits, so a build here draws the rows the reference
draws from the same seed, on any device, and the two packages' trainings
can be held against each other step by step.

A key is an int64 tensor (..., 2) holding the two uint32 words; every
uint32 value is held in int64 and wrapped with ``& MASK``.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2), all broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` → (2,): a 32-bit seed (negative ones
    too) fills the low word, a wider one both."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _hash(keys: torch.Tensor, start: int, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the 64-bit counters start … start+count-1 (high
    word, low word) under keys (..., 2) → two (..., count) tensors."""
    idx = torch.arange(start, start + count, dtype=torch.int64, device=keys.device)
    k1, k2 = keys[..., 0:1], keys[..., 1:2]
    return threefry2x32(k1, k2, idx >> 32, idx & MASK)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) → (..., num, 2)."""
    b1, b2 = _hash(keys, 0, num)
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Elements start … start+count-1 (row-major) of the 32-bit
    ``random_bits`` array drawn from keys (..., 2) → (..., count)."""
    b1, b2 = _hash(keys, start, count)
    return b1 ^ b2


def uniform(keys: torch.Tensor, start: int, count: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """Elements start … start+count-1 of ``jax.random.uniform`` in f32:
    23 random mantissa bits under the exponent of 1.0, less 1, scaled."""
    bits = (random_bits(keys, start, count) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(keys: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Elements start … start+count-1 of ``jax.random.gumbel`` in f32
    (its default low-range mode)."""
    return -torch.log(-torch.log(uniform(keys, start, count, minval=_TINY_F32)))


def randint(keys: torch.Tensor, maxval: int) -> torch.Tensor:
    """One ``jax.random.randint(key, (), 0, maxval)`` (int32) per key:
    keys (..., 2) → (...) int64. Two 32-bit draws reduced modulo the span
    with the reference's wrapping multiplier."""
    sub = split(keys)
    hi = random_bits(sub[..., 0, :], 0, 1)[..., 0]
    lo = random_bits(sub[..., 1, :], 0, 1)[..., 0]
    span = max(int(maxval), 1)
    mult = ((((1 << 16) % span) ** 2) & MASK) % span
    return (((((hi % span) * mult) & MASK) + lo % span) & MASK) % span
