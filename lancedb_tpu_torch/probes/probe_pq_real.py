"""The grouped ADC route on a real IVF_PQ build, against the per-pair
route, on the card: the port of the reference's scripts/probe_pq_real.py.

    python -m lancedb_tpu_torch.probes.probe_pq_real

Standalone it builds the script's index: 1,000,000 x 128 rows of the
bench's clustered data (seed 7), 1024 partitions, 4-bit codes x 32
subvectors. It prints the layout, then times one 128-query batch through
- the per-pair route: the searcher's own IVF_PQ scan (``_ivf_pq_search``:
  probe selection, LUT, B1, top-k);
- the grouped route (``full_grouped``): probe selection, LUT, B3 at qpc 8
  and 16, top-k;
- ``VectorSearcher.search`` with and without the fused refine (x10),
and reports how far the two routes' top-10 agree. ``full_grouped`` is
also what ``chip_smoke.py`` runs on its own IVF_PQ indexes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..index.vector import SearchParams, _ivf_pq_search, _pq_dlut, _probe_topk, _select_probes
from ..ops.adc import ivf_pq_adc_grouped_scan
from .common import loop_ms, make_clustered, print_records, require_cuda

N_ROWS, DIM, NPART, Q = 1_000_000, 128, 1024, 128
SEED = 7  # the script's data seed
ITERS = 24  # calls per timed run of a route


def grouped_inputs(searcher, q: torch.Tensor, nprobes: int = 20):
    """The ADC kernels' inputs for one chunk of queries on an l2 IVF_PQ
    searcher without OPQ, no filter: (probe_ids int32, dlut, codes,
    rnorms, q·c dots, |q|²)."""
    dev = searcher._device
    if searcher.index_type != "IVF_PQ" or searcher.metric != "l2" or "rotation" in dev:
        raise ValueError("the grouped route serves l2 IVF_PQ indexes without OPQ")
    probe_ids, probe_dots = _select_probes(q, dev["centroids"], searcher._block_nprobes(nprobes),
                                           "l2")
    dlut = _pq_dlut(q, dev["codebooks"], dev["codes"].shape[1])
    qn2 = torch.sum(torch.square(q), dim=-1)
    return (probe_ids.to(torch.int32), dlut, dev["codes"], dev["rnorms"],
            probe_dots.contiguous(), qn2.contiguous())


def full_grouped(searcher, q: torch.Tensor, qpc: int = 8, nprobes: int = 20, k: int = 10):
    """The script's "full grouped" route on one chunk of queries: probe
    selection → LUT → B3 → top-k → (vals (Q, k), global slots (Q, k))."""
    args = grouped_inputs(searcher, q, nprobes)
    dists = ivf_pq_adc_grouped_scan(*args, qpc=qpc)
    return _probe_topk(dists, args[0].long(), k)


def per_pair(searcher, q: torch.Tensor, nprobes: int = 20, k: int = 10):
    """The per-pair route: the searcher's own scan, B1."""
    return _ivf_pq_search(q, searcher._device, None, searcher._block_nprobes(nprobes), k, "l2")


def overlap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean share of each row of ``a`` that is also in the row of ``b``."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / len(x) for x, y in zip(a, b)]))


def build(device):
    """The script's build on ``device``: (dataset, searcher, queries
    (2048, 128) f32)."""
    import pyarrow as pa

    from ..index import IvfPq
    from ..index.vector import build_vector_index, load_searcher
    from ..io.object_store import MemoryStore
    from ..storage.dataset import Dataset

    x, q = make_clustered(np.random.default_rng(SEED), N_ROWS, DIM, n_queries=2048)
    fsl = pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1), pa.float32()), DIM)
    tbl = pa.table({"id": pa.array(np.arange(N_ROWS, dtype=np.int64)), "vector": fsl})
    ds = Dataset.create(MemoryStore(), "t.lance", tbl.schema, tbl)
    meta = build_vector_index(ds, "vector", IvfPq(num_partitions=NPART, num_sub_vectors=32,
                                                  num_bits=4), device=device)
    return ds, load_searcher(ds, meta, device), q


def run() -> list[dict]:
    dev = require_cuda()
    t0 = time.perf_counter()
    ds, sp, q = build(dev)
    torch.cuda.synchronize()
    codes = sp._device["codes"]
    records = [{
        "build_s": time.perf_counter() - t0, "blocks": sp.nparts,
        "logical": sp.params.get("num_logical_partitions", sp.nparts), "pmax": sp.pmax,
        "npb": sp._block_nprobes(20), "codes": [list(codes.shape), str(codes.dtype)],
    }]
    qj = torch.from_numpy(q[:Q]).to(dev)
    routes = [("full per-pair B1", lambda: per_pair(sp, qj))] + [
        (f"full grouped B3 qpc={qpc}", lambda qpc=qpc: full_grouped(sp, qj, qpc))
        for qpc in (8, 16)
    ]
    b1_slots = per_pair(sp, qj)[1]
    for name, fn in routes:
        ms = loop_ms([fn] * ITERS)
        records.append({"route": name, "ms_per_batch": ms, "qps": Q / ms * 1e3,
                        "top10_overlap_with_b1": overlap(fn()[1], b1_slots)})
    t0 = time.perf_counter()
    ok = sp.prepare_device_refine(ds, "vector")
    records.append({"prepare_device_refine": ok, "s": time.perf_counter() - t0})
    qh = q[:Q]
    for name, params in (("fused refined sp.search", SearchParams(k=10, nprobes=20,
                                                                   refine_factor=10)),
                         ("plain sp.search", SearchParams(k=10, nprobes=20))):
        sp.search(qh, params)  # warm
        reps = []
        for _ in range(5):
            t = time.perf_counter()
            sp.search(qh, params)
            reps.append(time.perf_counter() - t)
        med = float(np.median(reps))
        records.append({"route": name, "ms_per_batch_host_clock": med * 1e3, "qps": Q / med})
    return records


if __name__ == "__main__":
    print_records("probe_pq_real", run())
