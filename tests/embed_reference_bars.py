"""The reference package's recall on chip_smoke.py's path j, on the CPU:
the source of chip_smoke.py's bars for path j's text searches (this
recall less 0.03; refined at least 0.95).

Path j embeds 1,000,000 ``make_corpus`` documents (seed 0) with the
``hash`` embedding function (256 dims) through a LanceModel table
(category = id % 10), builds IVF_PQ with 1024 partitions and 32 8-bit
sub-vectors, and searches 256 ``make_corpus`` strings (seed 1) at nprobes
20: raw, with refine_factor(10) and with where("category = 3"). This
script does the same with lancedb_tpu on the CPU, on the first
``--rows`` documents (default all of them), searching the 256 embedded
strings as one batch, and prints recall@10 against exact f32 truth
(filtered truth for the filtered search) as one JSON line: counting a
hit right when its exact distance is within chip_smoke.TS_TIE of the 10th
(``recall@10``, what path j's bars hold), and by the truth's ids, ties
taken lower row first (``recall@10_ids``).

    JAX_PLATFORMS=cpu python tests/embed_reference_bars.py [--rows N]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import lancedb_tpu  # noqa: E402
from chip_smoke import (  # noqa: E402
    TS_BATCH, TS_NPROBES, TS_PARTITIONS, TS_SUBVECTORS, make_corpus, tie_recall,
)
from lancedb_tpu.embeddings import get_registry  # noqa: E402
from lancedb_tpu.index import IvfPq  # noqa: E402
from lancedb_tpu.pydantic import LanceModel, Vector  # noqa: E402
from sqrq_reference_bars import exact_gt, recall  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    rows = ap.parse_args().rows
    fn = get_registry().get("hash").create()

    class Doc(LanceModel):
        id: int
        text: str = fn.SourceField()
        vector: Vector(fn.ndims()) = fn.VectorField()
        category: int

    docs = make_corpus(np.random.default_rng(0), 1_000_000)[:rows]
    queries = make_corpus(np.random.default_rng(1), 256)
    q = np.concatenate([fn.compute_query_embeddings(s) for s in queries])
    with tempfile.TemporaryDirectory() as tmp:
        tbl = lancedb_tpu.connect(tmp).create_table("docs", schema=Doc)
        t0 = time.perf_counter()
        for s in range(0, rows, TS_BATCH):
            ids = np.arange(s, min(s + TS_BATCH, rows))
            tbl.add([{"id": int(i), "text": docs[i], "category": int(i) % 10} for i in ids])
        rec = {"rows": rows, "embed_and_add_s": time.perf_counter() - t0}
        col = tbl.to_arrow().sort_by("id")["vector"].combine_chunks()
        x = col.values.to_numpy().reshape(rows, -1)
        allowed = np.arange(rows) % 10 == 3
        gt, gt_f = exact_gt(x, q), exact_gt(x, q, allowed)
        xn2 = (x * x).sum(1)
        kth = np.array([np.partition(xn2 - 2.0 * (x @ qi), 9)[9] for qi in q])
        kth_f = np.array([np.partition((xn2 - 2.0 * (x @ qi))[allowed], 9)[9] for qi in q])
        t0 = time.perf_counter()
        tbl.create_index(config=IvfPq(num_partitions=TS_PARTITIONS,
                                      num_sub_vectors=TS_SUBVECTORS, num_bits=8))
        rec["build_s"] = time.perf_counter() - t0
        for case, rf, where, truth, kk in (("raw", None, None, gt, kth),
                                           ("refined", 10, None, gt, kth),
                                           ("filtered", None, "category = 3", gt_f, kth_f)):
            s = tbl.search(q).nprobes(TS_NPROBES).limit(10).select(["id"])
            if rf:
                s = s.refine_factor(rf)
            if where:
                s = s.where(where)
            out = s.to_arrow()
            qi, ids = np.asarray(out["query_index"]), np.asarray(out["id"])
            hits = np.full((len(q), 10), -1, np.int64)
            for i in range(len(q)):
                hits[i, : int(np.sum(qi == i))] = ids[qi == i]
            rec[case] = {"recall@10": tie_recall(hits, q, x, kk),
                         "recall@10_ids": recall(out, truth)}
        print(json.dumps({"hash_ivf_pq": rec}), flush=True)


if __name__ == "__main__":
    main()
