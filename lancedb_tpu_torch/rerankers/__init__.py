"""Rerankers: fuse the vector and full-text legs of a hybrid search.

RRF, linear combination and MRR are ported. The rerankers that need
model weights (cross-encoder, ColBERT, answerdotai) or a network service
(Cohere, Jina, OpenAI, VoyageAI, watsonx) keep their names here and
raise NotImplementedError naming their ROADMAP item (A12f).
"""

from .base import Reranker, normalize_scores
from .linear_combination import LinearCombinationReranker
from .mrr import MRRReranker
from .rrf import RRFReranker


def _not_ported(name: str, needs: str) -> type:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} needs {needs} and is not ported to lancedb_tpu_torch yet (ROADMAP A12f)"
        )

    return type(name, (Reranker,), {"__init__": __init__, "__doc__": f"Not ported: needs {needs}."})


CrossEncoderReranker = _not_ported("CrossEncoderReranker", "model weights")
AnswerdotaiRerankers = _not_ported("AnswerdotaiRerankers", "model weights")
ColbertReranker = _not_ported("ColbertReranker", "model weights")
CohereReranker = _not_ported("CohereReranker", "a network service")
JinaReranker = _not_ported("JinaReranker", "a network service")
OpenaiReranker = _not_ported("OpenaiReranker", "a network service")
VoyageaiReranker = _not_ported("VoyageaiReranker", "a network service")
WatsonxReranker = _not_ported("WatsonxReranker", "a network service")

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
