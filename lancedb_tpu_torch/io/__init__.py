from .object_store import (
    IoStats,
    IoTrackingStore,
    LocalStore,
    MemoryStore,
    MirroringStore,
    ObjectStore,
    resolve_uri,
)

__all__ = [
    "IoStats",
    "IoTrackingStore",
    "LocalStore",
    "MemoryStore",
    "MirroringStore",
    "ObjectStore",
    "resolve_uri",
]
