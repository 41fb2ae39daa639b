"""Rerankers: fuse the vector and full-text legs of a hybrid search, or
re-order one leg's results.

RRF, linear combination and MRR fuse on the host. The REST rerankers
(Cohere, Jina, OpenAI, VoyageAI, watsonx) call their provider's endpoint
at ``base_url``. ColBERT scores by MaxSim on its device; the
cross-encoder and answerdotai rerankers need their package and weights
and raise as the reference's do without them.
"""

from .base import Reranker, normalize_scores
from .colbert import ColbertReranker
from .cross_encoder import AnswerdotaiRerankers, CrossEncoderReranker
from .linear_combination import LinearCombinationReranker
from .mrr import MRRReranker
from .rest import (
    CohereReranker,
    JinaReranker,
    OpenaiReranker,
    VoyageaiReranker,
    WatsonxReranker,
)
from .rrf import RRFReranker

__all__ = [
    "Reranker",
    "RRFReranker",
    "LinearCombinationReranker",
    "MRRReranker",
    "CrossEncoderReranker",
    "CohereReranker",
    "OpenaiReranker",
    "JinaReranker",
    "VoyageaiReranker",
    "WatsonxReranker",
    "ColbertReranker",
    "AnswerdotaiRerankers",
    "normalize_scores",
]
