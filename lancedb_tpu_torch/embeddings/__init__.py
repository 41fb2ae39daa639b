from .base import EmbeddingFunction, TextEmbeddingFunction
from .registry import (
    EmbeddingDefinition,
    EmbeddingFunctionConfig,
    EmbeddingFunctionRegistry,
    get_registry,
)


def __getattr__(name):
    if name == "MultiVectorEmbeddingFunction":
        from .multimodal import MultiVectorEmbeddingFunction

        return MultiVectorEmbeddingFunction
    raise AttributeError(name)


__all__ = [
    "EmbeddingFunction",
    "TextEmbeddingFunction",
    "MultiVectorEmbeddingFunction",
    "EmbeddingDefinition",
    "EmbeddingFunctionConfig",
    "EmbeddingFunctionRegistry",
    "get_registry",
]
