"""Training data: permutations, the elastic StreamingDataset and the feed
that places its batches on a mesh's devices (port of the reference's
data/; host code copied, ``TorchBatchFeeder`` in place of
``JaxBatchFeeder``)."""

from .permutation import (Permutation, PermutationBuilder, PermutationReader,
                          PermutationSplit, Permutations, Transforms,
                          permutation_builder)
from .streaming import StreamingDataset
from .torch_feed import TorchBatchFeeder

__all__ = [
    "TorchBatchFeeder",
    "Permutation",
    "PermutationReader",
    "PermutationSplit",
    "Permutations",
    "PermutationBuilder",
    "Transforms",
    "permutation_builder",
    "StreamingDataset",
]
