"""Multimodal + multi-vector embedding providers.

Covers the reference providers beyond plain hosted-text APIs
(reference python embeddings/: colpali.py, open_clip.py, siglip.py,
imagebind.py, instructor.py, gte.py): local-model functions that embed
images and/or produce multi-vector (late-interaction) outputs feeding
the multivector search path (index/multivector.py).

Design notes
------------
* Image sources accept PIL images, raw bytes, file paths, or URIs —
  the reference's ``sanitize_input`` contract (embeddings/utils.py).
* Multi-vector functions return a LIST of (n_vectors, dim) arrays —
  one variable-length bag per item — matching the Arrow
  list<fixed_size_list<float>> multivector column type.
* Model loading is lazy and package/weight-gated: constructing a
  provider offline is fine; the first embed call raises a clear error
  if weights cannot be loaded (zero-egress deployments point
  HF_HOME at a local cache).
"""

from __future__ import annotations

import io
from typing import Any, ClassVar

import numpy as np

from ..errors import InvalidInputError
from .base import EmbeddingFunction, TextEmbeddingFunction
from .registry import EmbeddingFunctionRegistry

registry = EmbeddingFunctionRegistry.get_instance()


def sanitize_images(images: list[Any]) -> list:
    """PIL-ify a heterogeneous image batch (reference embeddings/utils.py
    sanitize_input/transform_input): PIL.Image | bytes | path | file URI."""
    from PIL import Image

    out = []
    for im in images:
        if isinstance(im, Image.Image):
            out.append(im)
        elif isinstance(im, bytes):
            out.append(Image.open(io.BytesIO(im)))
        elif isinstance(im, str):
            if im.startswith("file://"):
                im = im[len("file://") :]
            if im.startswith(("http://", "https://")):
                import urllib.request

                with urllib.request.urlopen(im, timeout=30) as resp:
                    out.append(Image.open(io.BytesIO(resp.read())))
            else:
                out.append(Image.open(im))
        else:
            raise InvalidInputError(f"cannot interpret image input of type {type(im)}")
    return [im.convert("RGB") for im in out]


class MultiVectorEmbeddingFunction(EmbeddingFunction):
    """Late-interaction contract: each item embeds to (n_vectors, dim).

    ``compute_source_embeddings`` returns ``list[np.ndarray]`` (ragged);
    the table write path stores them in a multivector column and
    queries score with MaxSim (index/multivector.py, reference
    colpali.py:210-240 semantics).
    """

    def compute_source_embeddings(self, items: list[Any]) -> list[np.ndarray]:
        raise NotImplementedError

    def compute_query_embeddings(self, query: Any) -> list[np.ndarray]:
        return self.compute_source_embeddings([query])


def hierarchical_token_pool(vectors: np.ndarray, pool_factor: int) -> np.ndarray:
    """Halve the token count ``log2(pool_factor)``-ish times by greedily
    mean-merging the most cosine-similar adjacent pairs — the reference's
    hierarchical pooling effect (colpali.py pooling_strategy=
    'hierarchical') without the colpali_engine dependency. Deterministic,
    pure numpy; keeps at least one vector."""
    if pool_factor <= 1 or len(vectors) <= 1:
        return vectors
    target = max(1, len(vectors) // pool_factor)
    v = vectors.astype(np.float32)
    while len(v) > target:
        n = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-30)
        sims = (n[:-1] * n[1:]).sum(1)  # adjacent cosine
        j = int(np.argmax(sims))
        merged = (v[j] + v[j + 1]) / 2.0
        v = np.concatenate([v[:j], merged[None, :], v[j + 2 :]])
    return v


@registry.register("colpali")
class ColPaliEmbedding(MultiVectorEmbeddingFunction):
    """ColPali/ColQwen late-interaction embeddings (reference
    embeddings/colpali.py:18-346): images embed to patch-vector bags,
    text queries to token-vector bags; optional hierarchical token
    pooling shrinks storage by ``pool_factor``.

    Loads through ``colpali_engine`` when installed, else through
    transformers' ColPali classes (transformers>=4.46 ships
    ColPaliForRetrieval). Subclasses/tests may override ``_encode``
    to swap the model."""

    DEFAULT_MODEL: ClassVar[str] = "vidore/colpali-v1.3"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model_name = kwargs.get("model_name", self.DEFAULT_MODEL)
        self.pooling_strategy = kwargs.get("pooling_strategy", "hierarchical")
        self.pool_factor = int(kwargs.get("pool_factor", 2))
        self.batch_size = int(kwargs.get("batch_size", 2))
        self._ndims = kwargs.get("ndims")
        self._model = None
        self._processor = None

    def ndims(self) -> int:
        if self._ndims is None:
            self._ndims = int(self.compute_query_embeddings("probe")[0].shape[1])
        return self._ndims

    def _load(self):
        if self._model is not None:
            return
        import torch  # noqa: F401

        try:
            from transformers import ColPaliForRetrieval, ColPaliProcessor

            self._model = ColPaliForRetrieval.from_pretrained(self.model_name)
            self._processor = ColPaliProcessor.from_pretrained(self.model_name)
        except Exception as exc:  # pragma: no cover - weight-gated
            raise RuntimeError(
                f"colpali: cannot load {self.model_name!r} "
                f"(install colpali_engine or cache the weights locally): {exc}"
            ) from exc

    def _encode(self, items: list[Any], is_query: bool) -> list[np.ndarray]:
        """One model pass → per-item (n_vectors, dim). Override point."""
        import torch

        self._load()
        out: list[np.ndarray] = []
        for start in range(0, len(items), self.batch_size):
            chunk = items[start : start + self.batch_size]
            if is_query:
                batch = self._processor(text=list(chunk), return_tensors="pt", padding=True)
            else:
                batch = self._processor(images=sanitize_images(chunk), return_tensors="pt")
            with torch.no_grad():
                embs = self._model(**batch).embeddings  # (b, seq, dim)
            mask = batch.get("attention_mask")
            for i in range(len(chunk)):
                e = embs[i]
                if mask is not None:
                    e = e[mask[i].bool()]
                out.append(e.float().cpu().numpy())
        return out

    def _pool(self, bags: list[np.ndarray]) -> list[np.ndarray]:
        if self.pooling_strategy == "hierarchical":
            return [hierarchical_token_pool(b, self.pool_factor) for b in bags]
        if self.pooling_strategy in (None, "none"):
            return bags
        raise InvalidInputError(f"unknown pooling_strategy {self.pooling_strategy!r}")

    def compute_source_embeddings(self, items: list[Any]) -> list[np.ndarray]:
        return self._pool(self._encode(items, is_query=False))

    def compute_query_embeddings(self, query: Any) -> list[np.ndarray]:
        return self._encode([query], is_query=True)  # queries are never pooled


class _ClipLikeEmbedding(EmbeddingFunction):
    """Shared dual-encoder plumbing for CLIP-family models: text queries
    against image (or text) sources in one joint space."""

    DEFAULT_MODEL: ClassVar[str] = ""
    _model_cls: ClassVar[str] = ""
    _processor_cls: ClassVar[str] = ""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model_name = kwargs.get("name") or kwargs.get("model_name") or self.DEFAULT_MODEL
        self.batch_size = int(kwargs.get("batch_size", 64))
        self.normalize = bool(kwargs.get("normalize", True))
        self._ndims = kwargs.get("ndims")
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return
        import transformers

        try:
            self._model = getattr(transformers, self._model_cls).from_pretrained(self.model_name)
            self._processor = getattr(transformers, self._processor_cls).from_pretrained(
                self.model_name
            )
        except Exception as exc:  # pragma: no cover - weight-gated
            raise RuntimeError(
                f"{self.name}: cannot load {self.model_name!r} "
                f"(cache the weights locally for zero-egress use): {exc}"
            ) from exc

    def ndims(self) -> int:
        if self._ndims is None:
            self._ndims = int(self.compute_query_embeddings("probe").shape[1])
        return self._ndims

    def _maybe_norm(self, x: np.ndarray) -> np.ndarray:
        if self.normalize:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        return x

    def _embed_text(self, texts: list[str]) -> np.ndarray:
        import torch

        self._load()
        out = []
        for s in range(0, len(texts), self.batch_size):
            batch = self._processor(
                text=texts[s : s + self.batch_size],
                return_tensors="pt",
                padding=True,
                truncation=True,
            )
            with torch.no_grad():
                out.append(self._model.get_text_features(**batch).float().cpu().numpy())
        return self._maybe_norm(np.concatenate(out))

    def _embed_images(self, images: list[Any]) -> np.ndarray:
        import torch

        self._load()
        pil = sanitize_images(images)
        out = []
        for s in range(0, len(pil), self.batch_size):
            batch = self._processor(images=pil[s : s + self.batch_size], return_tensors="pt")
            with torch.no_grad():
                out.append(self._model.get_image_features(**batch).float().cpu().numpy())
        return self._maybe_norm(np.concatenate(out))

    def compute_source_embeddings(self, items: list[Any]) -> np.ndarray:
        if items and isinstance(items[0], str) and not _looks_like_image_path(items[0]):
            return self._embed_text(list(items))
        return self._embed_images(list(items))

    def compute_query_embeddings(self, query: Any) -> np.ndarray:
        if isinstance(query, str) and not _looks_like_image_path(query):
            return self._embed_text([query])
        return self._embed_images([query])


_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".gif", ".bmp", ".webp", ".tiff")


def _looks_like_image_path(s: str) -> bool:
    return s.lower().endswith(_IMAGE_SUFFIXES) or s.startswith("file://")


@registry.register("open-clip")
class OpenClipEmbedding(_ClipLikeEmbedding):
    """CLIP dual encoder (reference embeddings/open_clip.py:26-172).

    The reference binds the open_clip package; here the same models load
    through transformers' CLIPModel, keeping text↔image parity."""

    DEFAULT_MODEL = "openai/clip-vit-base-patch32"
    _model_cls = "CLIPModel"
    _processor_cls = "CLIPProcessor"


@registry.register("siglip")
class SigLipEmbedding(_ClipLikeEmbedding):
    """SigLIP dual encoder (reference embeddings/siglip.py:26-156)."""

    DEFAULT_MODEL = "google/siglip-base-patch16-224"
    _model_cls = "SiglipModel"
    _processor_cls = "SiglipProcessor"


@registry.register("gte-text")
class GteEmbedding(TextEmbeddingFunction):
    """GTE text embeddings via mean pooling (reference embeddings/gte.py:
    16-133; the reference's MLX fork is Apple-silicon-only and is not
    mirrored)."""

    DEFAULT_MODEL: ClassVar[str] = "thenlper/gte-base"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model_name = kwargs.get("name") or kwargs.get("model_name") or self.DEFAULT_MODEL
        self._ndims = kwargs.get("ndims")
        self._model = None
        self._tok = None

    def _load(self):
        if self._model is None:
            from transformers import AutoModel, AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(self.model_name)
            self._model = AutoModel.from_pretrained(self.model_name)

    def ndims(self) -> int:
        if self._ndims is None:
            self._ndims = int(self.generate_embeddings(["probe"]).shape[1])
        return self._ndims

    def generate_embeddings(self, texts: list[str]) -> np.ndarray:
        import torch

        self._load()
        with torch.no_grad():
            enc = self._tok(list(texts), padding=True, truncation=True, return_tensors="pt")
            out = self._model(**enc).last_hidden_state
            mask = enc["attention_mask"].unsqueeze(-1)
            emb = (out * mask).sum(1) / mask.sum(1).clamp(min=1)
            emb = torch.nn.functional.normalize(emb, dim=-1)
        return emb.numpy()


@registry.register("instructor")
class InstructorEmbedding(TextEmbeddingFunction):
    """Instruction-conditioned embeddings (reference embeddings/
    instructor.py:15-141): each text is encoded as
    ``instruction + text``; queries use ``query_instruction``."""

    DEFAULT_MODEL: ClassVar[str] = "hkunlp/instructor-base"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model_name = kwargs.get("name") or kwargs.get("model_name") or self.DEFAULT_MODEL
        self.source_instruction = kwargs.get("source_instruction", "represent the document for retrieval: ")
        self.query_instruction = kwargs.get(
            "query_instruction", "represent the document for retrieving support documents: "
        )
        self._ndims = kwargs.get("ndims")
        self._model = None

    def _load(self):
        if self._model is None:
            try:
                from InstructorEmbedding import INSTRUCTOR  # type: ignore

                self._model = ("instructor", INSTRUCTOR(self.model_name))
            except ImportError:
                from sentence_transformers import SentenceTransformer

                self._model = ("st", SentenceTransformer(self.model_name))

    def ndims(self) -> int:
        if self._ndims is None:
            self._ndims = int(self.generate_embeddings(["probe"]).shape[1])
        return self._ndims

    def _encode(self, pairs: list[list[str]]) -> np.ndarray:
        self._load()
        kind, model = self._model
        if kind == "instructor":
            return np.asarray(model.encode(pairs), dtype=np.float32)
        return np.asarray(
            model.encode([ins + txt for ins, txt in pairs], normalize_embeddings=True),
            dtype=np.float32,
        )

    def generate_embeddings(self, texts: list[str]) -> np.ndarray:
        return self._encode([[self.source_instruction, t] for t in texts])

    def compute_query_embeddings(self, query: str) -> np.ndarray:
        return self._encode([[self.query_instruction, query]])


@registry.register("imagebind")
class ImageBindEmbedding(EmbeddingFunction):
    """ImageBind multimodal embeddings (reference embeddings/imagebind.py:
    19-173). The upstream model ships only through the ``imagebind``
    research package (not on PyPI); construction is package-gated with
    the same modality contract (text/image/audio/video by suffix)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        try:
            import imagebind  # type: ignore  # noqa: F401
        except ImportError as exc:
            raise RuntimeError(
                "imagebind: the `imagebind` research package is not installed; "
                "see github.com/facebookresearch/ImageBind"
            ) from exc
        raise NotImplementedError("imagebind backend wiring requires the research package")

    def ndims(self) -> int:  # pragma: no cover - gated
        return 1024

    def compute_source_embeddings(self, items):  # pragma: no cover - gated
        raise NotImplementedError
