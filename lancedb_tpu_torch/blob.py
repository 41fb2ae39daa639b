"""Blob columns: out-of-line binary storage with seekable handles.

Reference: blob.rs (blob-v2 encoded columns, `blob()` field marker,
queries return descriptors, `BlobFile` seekable handle `:4-38`;
Table::{fetch_blobs, fetch_blob_ranges, fetch_blob_files} —
table.rs:744-774).

Design here: a blob column is declared with :func:`blob` (a
large_binary field tagged in metadata). On write, payloads go to
append-only ``_blobs/<uuid>.bin`` files and the fragment stores a
descriptor struct {file, position, size}. Scans return descriptors
(cheap); `fetch_blob_files` returns lazy seekable handles that
range-read from the object store — large media never rides through
the query path.
"""

from __future__ import annotations

import io

import numpy as np
import pyarrow as pa

from .errors import InvalidInputError
from .storage.manifest import BLOBS_DIR, new_uuid

BLOB_META_KEY = b"lancedb:blob"

DESCRIPTOR_TYPE = pa.struct(
    [
        pa.field("file", pa.string()),
        pa.field("position", pa.int64()),
        pa.field("size", pa.int64()),
    ]
)


def blob() -> pa.Field:
    """Schema helper: declare a blob column (reference schema.py `blob`)::

        schema = pa.schema([pa.field("id", pa.int64()), blob_field("media")])
    """
    return pa.large_binary()


def blob_field(name: str, nullable: bool = True) -> pa.Field:
    return pa.field(name, pa.large_binary(), nullable=nullable, metadata={BLOB_META_KEY: b"true"})


def is_blob_field(field: pa.Field) -> bool:
    meta = field.metadata or {}
    return meta.get(BLOB_META_KEY) == b"true"


def descriptor_field(name: str, nullable: bool = True) -> pa.Field:
    return pa.field(name, DESCRIPTOR_TYPE, nullable=nullable, metadata={BLOB_META_KEY: b"true"})


def physical_schema(schema: pa.Schema) -> pa.Schema:
    """Logical schema (binary blob cols) → physical (descriptor structs)."""
    fields = []
    for f in schema:
        if is_blob_field(f) and not pa.types.is_struct(f.type):
            fields.append(descriptor_field(f.name, f.nullable))
        else:
            fields.append(f)
    return pa.schema(fields, metadata=schema.metadata)


def blob_columns(schema: pa.Schema) -> list[str]:
    return [f.name for f in schema if is_blob_field(f)]


def encode_blobs(store, root: str, data: pa.Table, schema: pa.Schema) -> pa.Table:
    """Replace binary blob columns with descriptors, writing payloads to
    one new append-only blob file per ingest batch."""
    cols = [
        f.name
        for f in schema
        if is_blob_field(f) and f.name in data.schema.names
        and not pa.types.is_struct(data.schema.field(f.name).type)
    ]
    if not cols:
        return data
    file_name = f"{BLOBS_DIR}/{new_uuid()}.bin"
    payload = io.BytesIO()
    out = data
    for name in cols:
        col = data.column(name)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        files, positions, sizes = [], [], []
        mask = []
        for v in col:
            b = v.as_py()
            if b is None:
                files.append(None)
                positions.append(None)
                sizes.append(None)
                mask.append(True)
            else:
                pos = payload.tell()
                payload.write(b)
                files.append(file_name)
                positions.append(pos)
                sizes.append(len(b))
                mask.append(False)
        desc = pa.StructArray.from_arrays(
            [pa.array(files, pa.string()), pa.array(positions, pa.int64()), pa.array(sizes, pa.int64())],
            fields=list(DESCRIPTOR_TYPE),
        )
        idx = out.schema.get_field_index(name)
        out = out.set_column(idx, descriptor_field(name), desc)
    if payload.tell():
        store.write_bytes(f"{root}/{file_name}", payload.getvalue())
    return out


class BlobFile:
    """Seekable lazy handle over one stored blob (reference blob.rs
    `BlobFile`) — file-like: read/seek/tell/close, range reads hit the
    object store directly."""

    def __init__(self, store, root: str, file: str, position: int, size: int):
        self._store = store
        self._path = f"{root}/{file}"
        self._base = position
        self._size = size
        self._pos = 0
        self._closed = False

    def size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = self._size + offset
        else:
            raise InvalidInputError(f"bad whence {whence}")
        self._pos = max(0, min(self._pos, self._size))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("read on closed BlobFile")
        if n < 0:
            n = self._size - self._pos
        n = min(n, self._size - self._pos)
        if n <= 0:
            return b""
        data = self._store.read_range(self._path, self._base + self._pos, n)
        self._pos += len(data)
        return data

    def read_range(self, start: int, length: int) -> bytes:
        length = min(length, max(0, self._size - start))
        return self._store.read_range(self._path, self._base + start, length)

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fetch_blob_files(dataset, column: str, row_ids: np.ndarray) -> list[BlobFile | None]:
    """Row addresses → lazy BlobFile handles (reference fetch_blob_files)."""
    schema_field = dataset.schema.field(column) if column in dataset.schema.names else None
    if schema_field is None or not is_blob_field(schema_field):
        raise InvalidInputError(f"{column!r} is not a blob column")
    tbl = dataset.take_rows(np.asarray(row_ids, dtype=np.uint64), columns=[column])
    out: list[BlobFile | None] = []
    for desc in tbl.column(column).to_pylist():
        if desc is None or desc.get("file") is None:
            out.append(None)
        else:
            out.append(
                BlobFile(dataset.store, dataset.root, desc["file"], desc["position"], desc["size"])
            )
    return out


def fetch_blobs(dataset, column: str, row_ids: np.ndarray) -> list[bytes | None]:
    """Fully materialize blobs (reference fetch_blobs)."""
    return [bf.read() if bf is not None else None for bf in fetch_blob_files(dataset, column, row_ids)]


def fetch_blob_ranges(
    dataset, column: str, row_ids: np.ndarray, ranges: list[tuple[int, int]]
) -> list[bytes | None]:
    """Range reads per blob: ranges[i] = (start, length) (reference
    fetch_blob_ranges)."""
    if len(ranges) != len(row_ids):
        raise InvalidInputError(
            f"{len(row_ids)} row ids but {len(ranges)} ranges"
        )
    for start, length in ranges:
        if start < 0 or length < 0:
            raise InvalidInputError(
                f"invalid blob range ({start}, {length}): offsets and "
                "lengths must be non-negative"
            )
    files = fetch_blob_files(dataset, column, row_ids)
    out = []
    for bf, (start, length) in zip(files, ranges):
        out.append(bf.read_range(start, length) if bf is not None else None)
    return out
