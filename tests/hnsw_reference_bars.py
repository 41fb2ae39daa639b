"""The reference package's HNSW_SQ and HNSW_PQ recall at chip_smoke.py's
settings, on the CPU: the source of chip_smoke.py's bars for path e's
IVF_HNSW_SQ and IVF_HNSW_PQ checks (this recall less 0.03).

chip_smoke.py builds them on the first rows of its 1M x 128 table
(make_clustered, seed 0) with the queries run_hnsw_config draws (256
rows by default_rng(17), plus 0.05 noise), IVF_HNSW_SQ at 500,000 rows
through the device beam at ef 64 and IVF_HNSW_PQ at 50,000 rows through
the host walk at ef 64 on 64 queries. Here both are built at 50,000 rows
(a CPU build at 500,000 would take the sandbox's memory and hours), with
the default m 20 and ef_construction 300, and recall@10 is taken against
exact f32 truth.

    JAX_PLATFORMS=cpu python tests/hnsw_reference_bars.py
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pyarrow as pa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import lancedb_tpu  # noqa: E402
from lancedb_tpu.index import HnswPq, HnswSq  # noqa: E402
from lancedb_tpu_torch.probes.common import make_clustered  # noqa: E402

ROWS, K, EF = 50_000, 10, 64


def main() -> None:
    x, _ = make_clustered(np.random.default_rng(0), 1_000_000, 128, n_queries=256)
    x = np.ascontiguousarray(x[:ROWS])
    rng = np.random.default_rng(17)
    qs = (x[rng.integers(0, ROWS, 256)]
          + 0.05 * rng.standard_normal((256, 128)).astype(np.float32)).astype(np.float32)
    d = (x * x).sum(1)[None, :] - 2.0 * qs @ x.T
    gt = np.argsort(d, axis=1, kind="stable")[:, :K]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tbl = lancedb_tpu.connect(tmp).create_table("t", pa.table({
            "id": np.arange(ROWS, dtype=np.int64),
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 128)}))
        for name, config, nq in (("hnsw_sq_device_ef64", HnswSq(), 256),
                                 ("hnsw_pq_host_ef64", HnswPq(), 64)):
            t0 = time.perf_counter()
            tbl.create_index(config=config)
            res = tbl.search(qs[:nq]).ef(EF).limit(K).to_arrow()
            qi, ids = np.asarray(res["query_index"]), np.asarray(res["id"])
            rec = np.mean([len(set(ids[qi == i]) & set(gt[i])) / K for i in range(nq)])
            out[name] = {"rows": ROWS, "queries": nq, "recall@10": float(rec),
                         "seconds": time.perf_counter() - t0}
            print(json.dumps({name: out[name]}), flush=True)


if __name__ == "__main__":
    main()
