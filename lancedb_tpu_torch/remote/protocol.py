"""Wire protocol shared by the remote client and server.

Endpoint shapes follow the reference Cloud REST API (reference
remote/table.rs:177-2589 `POST /v1/table/{id}/...`, docs/openapi.yml):
JSON request bodies, Arrow IPC (stream) responses for data, request-id
header propagation (reference remote/client.rs:16).
"""

from __future__ import annotations

import io
import json

import pyarrow as pa
import pyarrow.ipc as ipc

REQUEST_ID_HEADER = "x-request-id"
CONTENT_JSON = "application/json"
CONTENT_ARROW = "application/vnd.apache.arrow.stream"


def table_to_ipc(tbl: pa.Table) -> bytes:
    sink = io.BytesIO()
    with ipc.new_stream(sink, tbl.schema) as w:
        for batch in tbl.to_batches():
            w.write_batch(batch)
    return sink.getvalue()


def ipc_to_table(data: bytes) -> pa.Table:
    return ipc.open_stream(pa.BufferReader(data)).read_all()


def schema_to_json(schema: pa.Schema) -> dict:
    """JSON-friendly schema description (reference describe response).
    Schema metadata rides along (decoded utf-8) so remote SDKs can
    reconnect embedding functions from the `embedding_functions` key."""
    def field_to_json(f: pa.Field) -> dict:
        return {"name": f.name, "type": str(f.type), "nullable": f.nullable}

    metadata = {}
    for k, v in (schema.metadata or {}).items():
        try:
            metadata[k.decode()] = v.decode()
        except UnicodeDecodeError:
            continue  # binary metadata is not part of the JSON surface
    return {"fields": [field_to_json(f) for f in schema], "metadata": metadata}


def dumps(obj) -> bytes:
    return json.dumps(obj).encode()


def loads(data: bytes):
    return json.loads(data) if data else {}
