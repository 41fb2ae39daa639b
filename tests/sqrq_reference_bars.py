"""The reference package's IVF_SQ and IVF_RQ recall at chip_smoke.py's
path g settings, on the CPU: the source of chip_smoke.py's bars for path
g's IVF_SQ and IVF_RQ checks (this recall less 0.03; refined at least
0.95).

Path g builds both types on path a's table (make_clustered, seed 0,
1,000,000 x 128, category = id % 10) with 1024 partitions and searches
path a's 256 queries at nprobes 20: raw, with refine_factor(10) (the
fused refine) and with where("category < 5"). This script does the same
with lancedb_tpu on the CPU, on the table's first ``--rows`` rows
(default all of them), and prints recall@10 against exact f32 truth
(filtered truth for the filtered search), one JSON line per type.

    JAX_PLATFORMS=cpu python tests/sqrq_reference_bars.py [--rows N]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pyarrow as pa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import lancedb_tpu  # noqa: E402
from lancedb_tpu.index import IvfRq, IvfSq  # noqa: E402
from lancedb_tpu_torch.probes.common import make_clustered  # noqa: E402

K, PARTS, NPROBES = 10, 1024, 20


def exact_gt(x: np.ndarray, q: np.ndarray, allowed: np.ndarray | None = None) -> np.ndarray:
    """Exact f32 l2 top-K ids, in row chunks (ids of ``allowed`` rows only)."""
    best_d = np.full((len(q), 0), np.inf, np.float32)
    best_i = np.zeros((len(q), 0), np.int64)
    for s in range(0, len(x), 1 << 17):
        xc = x[s : s + (1 << 17)]
        d = (xc * xc).sum(1)[None, :] - 2.0 * q @ xc.T
        if allowed is not None:
            d[:, ~allowed[s : s + len(xc)]] = np.inf
        d = np.concatenate([best_d, d], axis=1)
        i = np.concatenate([best_i, np.tile(np.arange(s, s + len(xc)), (len(q), 1))], axis=1)
        top = np.argsort(d, axis=1, kind="stable")[:, :K]
        best_d, best_i = np.take_along_axis(d, top, 1), np.take_along_axis(i, top, 1)
    return best_i


def recall(res: pa.Table, gt: np.ndarray) -> float:
    qi, ids = np.asarray(res["query_index"]), np.asarray(res["id"])
    return float(np.mean([len(set(ids[qi == i]) & set(gt[i])) / K for i in range(len(gt))]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    rows = ap.parse_args().rows
    x, q = make_clustered(np.random.default_rng(0), 1_000_000, 128, n_queries=256)
    x = np.ascontiguousarray(x[:rows])
    ids = np.arange(rows, dtype=np.int64)
    gt, gt_f = exact_gt(x, q), exact_gt(x, q, ids % 10 < 5)
    with tempfile.TemporaryDirectory() as tmp:
        tbl = lancedb_tpu.connect(tmp).create_table("t", pa.table({
            "id": ids, "category": ids % 10,
            "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 128)}))
        del x
        for name, config in (("ivf_sq", IvfSq(num_partitions=PARTS)),
                             ("ivf_rq", IvfRq(num_partitions=PARTS))):
            t0 = time.perf_counter()
            tbl.create_index(config=config)
            rec = {"rows": rows, "build_s": time.perf_counter() - t0}
            for case, rf, where, truth in (("raw", None, None, gt), ("refined", 10, None, gt),
                                           ("filtered", None, "category < 5", gt_f)):
                s = tbl.search(q).nprobes(NPROBES).limit(K).select(["id"])
                if rf:
                    s = s.refine_factor(rf)
                if where:
                    s = s.where(where)
                rec[case] = recall(s.to_arrow(), truth)
            print(json.dumps({name: rec}), flush=True)


if __name__ == "__main__":
    main()
