from .client import (
    ClientConfig,
    TlsConfig,
    RemoteDBConnection,
    RemoteTable,
    RetryConfig,
    TimeoutConfig,
    connect_remote,
)
from .oauth import OAuthConfig, OAuthHeaderProvider
from .server import QueryServer

__all__ = [
    "connect_remote",
    "RemoteDBConnection",
    "RemoteTable",
    "QueryServer",
    "ClientConfig",
    "TlsConfig",
    "RetryConfig",
    "TimeoutConfig",
    "OAuthConfig",
    "OAuthHeaderProvider",
]
