"""OAuth 2.0 token acquisition for the remote client.

Mirrors the reference's OAuth support (reference
rust/lancedb/src/remote/oauth.rs): two token sources —

* **client_credentials** — OIDC discovery against the issuer
  (`{issuer}/.well-known/openid-configuration`) to find the token
  endpoint, then a `grant_type=client_credentials` POST with the
  client id/secret and scopes (oauth.rs ClientCredentialsSource,
  :202-382). HTTPS is enforced except for loopback issuers
  (oauth.rs validate_issuer_transport, :251-277).
* **azure_managed_identity** — the Azure IMDS metadata endpoint with a
  resource derived from the single scope (`.default` suffix stripped —
  oauth.rs AzureImdsSource, :384-468).

Tokens cache with proactive refresh `refresh_buffer_secs` before
expiry (default 300 s; token TTL defaults to 3600 s when the server
omits `expires_in` — oauth.rs:18-19). `OAuthHeaderProvider` plugs into
``ClientConfig.header_provider`` and emits the ``authorization:
Bearer`` header (oauth.rs HeaderProvider impl, :560-568).

A `transport` callable ``(method, url, headers, body) -> (status,
bytes)`` swaps the HTTP layer for tests, like RestClient's MockSender
hook.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable

from ..errors import HttpError, InvalidInputError

DEFAULT_REFRESH_BUFFER_SECS = 300
DEFAULT_TOKEN_TTL_SECS = 3600
AZURE_IMDS_ENDPOINT = "http://169.254.169.254/metadata/identity/oauth2/token"
AZURE_IMDS_API_VERSION = "2018-02-01"

Transport = Callable[[str, str, dict, bytes | None], tuple[int, bytes]]


@dataclass
class OAuthConfig:
    """Reference oauth.rs:45-69 OAuthConfig."""

    issuer_url: str = ""
    client_id: str = ""
    client_secret: str | None = None
    scopes: list[str] = field(default_factory=list)
    # 'client_credentials' | 'azure_managed_identity'
    flow: str = "client_credentials"
    refresh_buffer_secs: int | None = None
    # azure_managed_identity: optional user-assigned identity client id
    azure_client_id: str | None = None

    def __repr__(self) -> str:  # never leak the secret
        return (
            f"OAuthConfig(issuer_url={self.issuer_url!r}, "
            f"client_id={self.client_id!r}, client_secret=***, "
            f"scopes={self.scopes!r}, flow={self.flow!r})"
        )


class _TokenState:
    """Cached token + expiry (oauth.rs TokenState, :169-196)."""

    def __init__(self) -> None:
        self.access_token: str | None = None
        self.expires_at: float = 0.0

    ttl: float = DEFAULT_TOKEN_TTL_SECS

    def is_expired(self, buffer_s: float) -> bool:
        # short-lived tokens (ttl <= buffer) would otherwise be "expired"
        # the instant they are cached — floor the effective buffer at
        # half the token lifetime so every token serves some requests
        eff = min(buffer_s, self.ttl / 2.0)
        return self.access_token is None or time.monotonic() >= self.expires_at - eff

    def update(self, resp: dict) -> None:
        self.access_token = resp["access_token"]
        ttl = resp.get("expires_in")
        try:
            ttl = float(ttl) if ttl is not None else DEFAULT_TOKEN_TTL_SECS
        except (TypeError, ValueError):
            # some IdPs return expires_in as a string (oauth.rs:117-166)
            ttl = DEFAULT_TOKEN_TTL_SECS
        self.ttl = ttl
        self.expires_at = time.monotonic() + ttl


def _default_transport(method: str, url: str, headers: dict, body: bytes | None):
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in headers.items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _is_loopback(host: str | None) -> bool:
    return host in ("localhost", "127.0.0.1", "::1", "[::1]")


class ClientCredentialsSource:
    """OIDC discovery + client_credentials grant (oauth.rs:202-382)."""

    def __init__(
        self,
        issuer_url: str,
        client_id: str,
        client_secret: str | None,
        scopes: list[str],
        transport: Transport | None = None,
    ):
        if not client_secret:
            raise InvalidInputError(
                "client_credentials flow requires a client_secret"
            )
        parsed = urllib.parse.urlparse(issuer_url)
        if parsed.scheme != "https" and not (
            parsed.scheme == "http" and _is_loopback(parsed.hostname)
        ):
            raise InvalidInputError(
                "OAuth issuer_url must use https (http allowed for loopback only)"
            )
        self.issuer_url = issuer_url.rstrip("/")
        self.client_id = client_id
        self.client_secret = client_secret
        self.scopes = scopes
        self.transport = transport or _default_transport
        self._token_endpoint: str | None = None

    def _discover(self) -> str:
        if self._token_endpoint is None:
            url = f"{self.issuer_url}/.well-known/openid-configuration"
            status, payload = self.transport("GET", url, {"accept": "application/json"}, None)
            if status >= 400:
                raise HttpError(
                    f"OIDC discovery failed ({status}): {payload[:200].decode(errors='replace')}",
                    status_code=status,
                )
            doc = json.loads(payload)
            endpoint = doc.get("token_endpoint")
            if not endpoint:
                raise HttpError("OIDC discovery document has no token_endpoint")
            self._token_endpoint = endpoint
        return self._token_endpoint

    def fetch_token(self) -> dict:
        endpoint = self._discover()
        form = {
            "grant_type": "client_credentials",
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "scope": " ".join(self.scopes),
        }
        body = urllib.parse.urlencode(form).encode()
        status, payload = self.transport(
            "POST", endpoint,
            {"content-type": "application/x-www-form-urlencoded"},
            body,
        )
        if status >= 400:
            msg = payload[:300].decode(errors="replace")
            raise HttpError(f"OAuth token request failed ({status}): {msg}", status_code=status)
        return json.loads(payload)


class AzureImdsSource:
    """Azure managed identity via the IMDS endpoint (oauth.rs:384-468)."""

    def __init__(
        self,
        scopes: list[str],
        client_id: str | None = None,
        transport: Transport | None = None,
    ):
        if len(scopes) != 1:
            raise InvalidInputError(
                "azure_managed_identity requires exactly one scope/resource"
            )
        self.resource = scopes[0].removesuffix("/.default")
        self.client_id = client_id
        self.transport = transport or _default_transport

    def fetch_token(self) -> dict:
        params = {
            "api-version": AZURE_IMDS_API_VERSION,
            "resource": self.resource,
        }
        if self.client_id:
            params["client_id"] = self.client_id
        url = AZURE_IMDS_ENDPOINT + "?" + urllib.parse.urlencode(params)
        status, payload = self.transport("GET", url, {"Metadata": "true"}, None)
        if status >= 400:
            msg = payload[:300].decode(errors="replace")
            raise HttpError(f"Azure IMDS token request failed ({status}): {msg}", status_code=status)
        return json.loads(payload)


class OAuthHeaderProvider:
    """Header provider emitting `authorization: Bearer <token>` with
    cached, proactively-refreshed tokens (oauth.rs OAuthHeaderProvider).
    Plug into ``ClientConfig(header_provider=OAuthHeaderProvider(cfg))``
    — RestClient calls it per request."""

    def __init__(self, config: OAuthConfig, transport: Transport | None = None):
        if not config.scopes:
            raise InvalidInputError("At least one OAuth scope is required")
        if config.flow == "client_credentials":
            self._source: Any = ClientCredentialsSource(
                config.issuer_url, config.client_id, config.client_secret,
                config.scopes, transport,
            )
        elif config.flow == "azure_managed_identity":
            self._source = AzureImdsSource(
                config.scopes, config.azure_client_id, transport
            )
        else:
            raise InvalidInputError(f"unknown OAuth flow {config.flow!r}")
        self._state = _TokenState()
        self._lock = threading.Lock()
        self._buffer = float(
            config.refresh_buffer_secs
            if config.refresh_buffer_secs is not None
            else DEFAULT_REFRESH_BUFFER_SECS
        )

    def get_valid_token(self) -> str:
        # fast path without the lock; double-checked under it
        if not self._state.is_expired(self._buffer):
            return self._state.access_token  # type: ignore[return-value]
        with self._lock:
            if self._state.is_expired(self._buffer):
                self._state.update(self._source.fetch_token())
            return self._state.access_token  # type: ignore[return-value]

    def __call__(self) -> dict[str, str]:
        return {"authorization": f"Bearer {self.get_valid_token()}"}
