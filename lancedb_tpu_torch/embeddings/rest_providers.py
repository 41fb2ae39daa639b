"""REST-backed embedding providers.

Real request implementations for the hosted-API providers the
reference ships (reference python embeddings/: openai, cohere, gemini,
voyageai, jinaai, ollama, watsonx — each a TextEmbeddingFunction over
an HTTPS JSON endpoint with retry). Stdlib urllib only — no vendor
SDKs. Every provider takes ``base_url`` so tests (and air-gapped
deployments) can point at a mock server, exactly the reference's
ci/mock_openai.py pattern; API keys resolve from standard env vars at
call time, so constructing a provider offline is fine.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import ClassVar

import numpy as np

from ..errors import InvalidInputError
from .base import TextEmbeddingFunction
from .registry import EmbeddingFunctionRegistry

registry = EmbeddingFunctionRegistry.get_instance()


class IamTokenCache:
    """IBM IAM apikey→bearer exchange with expiry-aware caching (the
    token lives ~60 min; refresh at 50). Shared by the watsonx
    embedding provider and reranker."""

    def __init__(self, iam_url: str, ttl_s: float = 50 * 60):
        self.iam_url = iam_url.rstrip("/")
        self.ttl_s = ttl_s
        self._token: str | None = None
        self._fetched_at = 0.0

    def bearer(self, api_key: str) -> str:
        import time

        if self._token is None or time.monotonic() - self._fetched_at > self.ttl_s:
            data = (
                "grant_type=urn%3Aibm%3Aparams%3Aoauth%3Agrant-type%3Aapikey"
                f"&apikey={api_key}"
            ).encode()
            req = urllib.request.Request(
                f"{self.iam_url}/identity/token",
                data=data,
                method="POST",
                headers={"content-type": "application/x-www-form-urlencoded"},
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                self._token = json.loads(resp.read())["access_token"]
            self._fetched_at = time.monotonic()
        return self._token


class RestEmbeddingFunction(TextEmbeddingFunction):
    """Shared JSON-over-HTTPS plumbing. Subclasses define the wire shape."""

    default_base_url: ClassVar[str] = ""
    api_key_env: ClassVar[str] = ""
    default_model: ClassVar[str] = ""
    default_ndims: ClassVar[int] = 0
    # hosted APIs cap batch sizes; chunk requests
    max_batch: ClassVar[int] = 128

    @classmethod
    def sensitive_keys(cls) -> list[str]:
        # providers without an env key (e.g. local Ollama) take none
        return ["api_key"] if cls.api_key_env else []

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model = kwargs.get("model") or kwargs.get("name") or self.default_model
        self.base_url = (kwargs.get("base_url") or self.default_base_url).rstrip("/")
        self._api_key = kwargs.get("api_key")
        self._ndims = kwargs.get("ndims") or self.default_ndims

    def _key(self) -> str:
        key = self._api_key or os.environ.get(self.api_key_env, "")
        if not key and self.api_key_env:
            raise InvalidInputError(
                f"{type(self).__name__} needs an API key: pass api_key= or set "
                f"${self.api_key_env}"
            )
        return key

    def ndims(self) -> int:
        if not self._ndims:
            self._ndims = int(self.generate_embeddings(["probe"]).shape[1])
        return self._ndims

    def _post(self, path: str, body: dict, headers: dict | None = None) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=json.dumps(body).encode(),
            method="POST",
            headers={"content-type": "application/json", **(headers or {})},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def generate_embeddings(self, texts: list[str]) -> np.ndarray:
        out = []
        for start in range(0, len(texts), self.max_batch):
            out.append(self._embed_batch(texts[start : start + self.max_batch]))
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _embed_batch(self, texts: list[str]) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


@registry.register("openai")
class OpenAIEmbedding(RestEmbeddingFunction):
    """POST {base}/v1/embeddings (reference embeddings/openai.py)."""

    default_base_url = "https://api.openai.com"
    api_key_env = "OPENAI_API_KEY"
    default_model = "text-embedding-3-small"
    default_ndims = 1536

    def _embed_batch(self, texts):
        r = self._post(
            "/v1/embeddings",
            {"model": self.model, "input": texts},
            {"authorization": f"Bearer {self._key()}"},
        )
        data = sorted(r["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)


@registry.register("cohere")
class CohereEmbedding(RestEmbeddingFunction):
    """POST {base}/v2/embed (reference embeddings/cohere.py)."""

    default_base_url = "https://api.cohere.com"
    api_key_env = "COHERE_API_KEY"
    default_model = "embed-v4.0"
    max_batch = 96

    def _embed_batch(self, texts):
        r = self._post(
            "/v2/embed",
            {
                "model": self.model,
                "texts": texts,
                "input_type": "search_document",
                "embedding_types": ["float"],
            },
            {"authorization": f"Bearer {self._key()}"},
        )
        embs = r["embeddings"]["float"] if isinstance(r["embeddings"], dict) else r["embeddings"]
        return np.asarray(embs, dtype=np.float32)


@registry.register("gemini-text")
class GeminiEmbedding(RestEmbeddingFunction):
    """POST {base}/v1beta/models/{model}:batchEmbedContents."""

    default_base_url = "https://generativelanguage.googleapis.com"
    api_key_env = "GOOGLE_API_KEY"
    default_model = "text-embedding-004"
    default_ndims = 768
    max_batch = 100

    def _embed_batch(self, texts):
        model = f"models/{self.model}"
        r = self._post(
            f"/v1beta/{model}:batchEmbedContents?key={self._key()}",
            {
                "requests": [
                    {"model": model, "content": {"parts": [{"text": t}]}} for t in texts
                ]
            },
        )
        return np.asarray([e["values"] for e in r["embeddings"]], dtype=np.float32)


@registry.register("voyageai")
class VoyageAIEmbedding(RestEmbeddingFunction):
    """POST {base}/v1/embeddings (reference embeddings/voyageai.py)."""

    default_base_url = "https://api.voyageai.com"
    api_key_env = "VOYAGE_API_KEY"
    default_model = "voyage-3"
    max_batch = 128

    def _embed_batch(self, texts):
        r = self._post(
            "/v1/embeddings",
            {"model": self.model, "input": texts},
            {"authorization": f"Bearer {self._key()}"},
        )
        data = sorted(r["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)


@registry.register("jinaai")
class JinaEmbedding(RestEmbeddingFunction):
    """POST {base}/v1/embeddings (reference embeddings/jinaai.py)."""

    default_base_url = "https://api.jina.ai"
    api_key_env = "JINA_API_KEY"
    default_model = "jina-embeddings-v3"

    def _embed_batch(self, texts):
        r = self._post(
            "/v1/embeddings",
            {"model": self.model, "input": texts},
            {"authorization": f"Bearer {self._key()}"},
        )
        data = sorted(r["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)


@registry.register("ollama")
class OllamaEmbedding(RestEmbeddingFunction):
    """POST {base}/api/embed — local Ollama daemon, no API key."""

    default_base_url = "http://localhost:11434"
    api_key_env = ""
    default_model = "nomic-embed-text"

    def _embed_batch(self, texts):
        r = self._post("/api/embed", {"model": self.model, "input": texts})
        return np.asarray(r["embeddings"], dtype=np.float32)


@registry.register("bedrock-text")
class BedrockTextEmbedding(RestEmbeddingFunction):
    """AWS Bedrock text embeddings (reference embeddings/bedrock.py:19-226).

    The reference binds boto3; here the InvokeModel REST endpoint is
    signed with stdlib SigV4 (no SDK). Supports the Titan and Cohere
    model families the reference lists."""

    api_key_env = "AWS_ACCESS_KEY_ID"
    default_model = "amazon.titan-embed-text-v1"
    default_ndims = 1536
    max_batch = 96

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.region = kwargs.get("region") or os.environ.get("AWS_DEFAULT_REGION", "us-east-1")
        if not self.base_url:
            self.base_url = f"https://bedrock-runtime.{self.region}.amazonaws.com"
        self.source_input_type = kwargs.get("source_input_type", "search_document")

    # --- SigV4 (rfc-style canonical request; stdlib only) -----------------
    def _sigv4_headers(self, method: str, path: str, body: bytes) -> dict:
        import datetime
        import hashlib
        import hmac
        from urllib.parse import urlparse

        access = os.environ.get("AWS_ACCESS_KEY_ID", self._api_key or "")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        token = os.environ.get("AWS_SESSION_TOKEN")
        host = urlparse(self.base_url).netloc
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = {"host": host, "x-amz-date": amz_date, "x-amz-content-sha256": payload_hash}
        if token:
            headers["x-amz-security-token"] = token
        signed = ";".join(sorted(headers))
        canonical = "\n".join(
            [method, path, "", *(f"{k}:{headers[k]}" for k in sorted(headers)), "", signed, payload_hash]
        )
        scope = f"{datestamp}/{self.region}/bedrock/aws4_request"
        to_sign = "\n".join(
            ["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(canonical.encode()).hexdigest()]
        )

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(_hmac(_hmac(_hmac(b"AWS4" + secret.encode(), datestamp), self.region), "bedrock"), "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={access}/{scope}, SignedHeaders={signed}, Signature={sig}"
        )
        return headers

    def _invoke(self, body: dict) -> dict:
        from urllib.parse import quote

        path = f"/model/{quote(self.model, safe='')}/invoke"
        payload = json.dumps(body).encode()
        headers = self._sigv4_headers("POST", path, payload)
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=payload,
            method="POST",
            headers={"content-type": "application/json", "accept": "application/json", **headers},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def _embed_batch(self, texts):
        if self.model.startswith("cohere."):
            r = self._invoke({"texts": list(texts), "input_type": self.source_input_type})
            return np.asarray(r["embeddings"], dtype=np.float32)
        # titan models embed one text per invocation (reference bedrock.py:99-120)
        return np.asarray([self._invoke({"inputText": t})["embedding"] for t in texts], dtype=np.float32)


@registry.register("watsonx")
class WatsonxEmbedding(RestEmbeddingFunction):
    """IBM watsonx.ai embeddings (reference embeddings/watsonx.py:44-176).

    The reference binds ibm-watsonx-ai; here the two REST legs are
    inlined: IAM apikey→token exchange, then /ml/v1/text/embeddings
    with model_id + project_id/space_id (exactly one required)."""

    api_key_env = "WATSONX_API_KEY"
    default_base_url = "https://us-south.ml.cloud.ibm.com"
    default_model = "ibm/slate-125m-english-rtrvr"
    max_batch = 100

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.project_id = kwargs.get("project_id") or os.environ.get("WATSONX_PROJECT_ID")
        self.space_id = kwargs.get("space_id")
        if self.project_id and self.space_id:
            raise InvalidInputError("provide either project_id or space_id, not both")
        if not self.project_id and not self.space_id:
            raise InvalidInputError("watsonx needs project_id= or space_id=")
        self.iam_url = kwargs.get("iam_url", "https://iam.cloud.ibm.com")
        self.version = kwargs.get("version", "2024-05-02")
        self._iam = IamTokenCache(self.iam_url)

    def _bearer(self) -> str:
        return self._iam.bearer(self._key())

    def _embed_batch(self, texts):
        body = {"inputs": list(texts), "model_id": self.model}
        if self.project_id:
            body["project_id"] = self.project_id
        else:
            body["space_id"] = self.space_id
        r = self._post(
            f"/ml/v1/text/embeddings?version={self.version}",
            body,
            {"authorization": f"Bearer {self._bearer()}"},
        )
        return np.asarray([row["embedding"] for row in r["results"]], dtype=np.float32)
