"""Test utilities (the reference's test_utils.py; upstream rust
test_utils/{connection,embeddings,datagen}.rs).

`new_test_connection(device=None)` mirrors the env-switchable behavior
(test_utils/connection.rs:36-41): when
``CREATE_LANCEDB_TEST_CONNECTION_SCRIPT`` is set, spawn that script as
a query-node subprocess and connect remotely (parsing the port from
its stdout; the node owns the device, e.g. ``python -m
lancedb_tpu_torch.remote.server DIR --port 0 --device cpu``); otherwise
return a local temp-dir connection on ``device`` (None: the card).

The mock embedding salts with Python's ``hash()``, so its vectors differ
between processes; compare two packages' outputs within one process.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np
import pyarrow as pa

from .errors import InvalidInputError

ENV_SCRIPT = "CREATE_LANCEDB_TEST_CONNECTION_SCRIPT"


class TestConnection:
    """Handle owning the connection plus any spawned server process."""

    def __init__(self, connection, process=None, tmpdir=None):
        self.connection = connection
        self._process = process
        self._tmpdir = tmpdir

    def close(self) -> None:
        if self._process is not None:
            self._process.terminate()
            try:
                self._process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._process.kill()
                self._process.wait(timeout=5)
            self._process.stdout.close()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)

    def __enter__(self):
        return self.connection

    def __exit__(self, *exc):
        self.close()


def new_test_connection(device=None) -> TestConnection:
    import lancedb_tpu_torch

    script = os.environ.get(ENV_SCRIPT)
    if not script:
        tmpdir = tempfile.mkdtemp(prefix="lancedb_tpu_torch_test_")
        return TestConnection(lancedb_tpu_torch.connect(tmpdir, device), tmpdir=tmpdir)
    if device is not None:
        raise InvalidInputError(
            f"${ENV_SCRIPT} starts a query node, which owns the device; pass no device"
        )
    proc = subprocess.Popen(
        [script], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True
    )
    # the script prints the listening port on stdout (reference contract)
    deadline = time.time() + 30
    port = None
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.05)
            continue
        m = re.search(r"(?:port[=: ]*|:)(\d{2,5})\b", line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        raise RuntimeError(f"query-node script {script!r} did not report a port")
    conn = lancedb_tpu_torch.connect("db://test", host_override=f"http://127.0.0.1:{port}")
    return TestConnection(conn, process=proc)


# ---- data generation (reference test_utils/datagen.rs wrappers) ----


def random_vector_table(
    num_rows: int = 1000, dim: int = 128, seed: int = 0, extra_columns: bool = True
) -> pa.Table:
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((num_rows, dim)).astype(np.float32)
    cols = {
        "id": pa.array(np.arange(num_rows, dtype=np.int64)),
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(vecs.ravel()), dim),
    }
    if extra_columns:
        cols["price"] = pa.array(rng.uniform(0, 100, num_rows))
        cols["category"] = pa.array([f"cat-{i % 10}" for i in range(num_rows)])
        cols["text"] = pa.array([f"item number {i} in category {i % 10}" for i in range(num_rows)])
    return pa.table(cols)


class MockTextEmbeddingFunction:
    """Deterministic embedding stub (reference test_utils/embeddings.rs)."""

    def __init__(self, dim: int = 16):
        self._dim = dim
        self.source_column = None

    def ndims(self) -> int:
        return self._dim

    def compute_source_embeddings(self, texts):
        out = np.zeros((len(texts), self._dim), dtype=np.float32)
        for i, t in enumerate(texts):
            h = abs(hash(t or "")) % (2**31)
            rng = np.random.default_rng(h)
            out[i] = rng.standard_normal(self._dim)
        return out

    def compute_query_embeddings(self, query):
        return self.compute_source_embeddings([query])
