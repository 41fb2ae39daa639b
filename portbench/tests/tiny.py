"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
same code path, traffic and limits, fewer and narrower rows."""

import copy

from portbench import spec

ROOT = spec.HERE.parent


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.resolve(spec.read_json(ROOT / "BENCHMARK.json"), name, ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg.update(rows=12_000, dim=32, query_pool=400)
    cfg["data"].update(n_coarse=48, n_parents=384)
    cfg["index"].update(num_partitions=24, num_sub_vectors=8, num_bits=4, max_iterations=10)
    cell.config = cfg
    cell.traffic = dict(cell.traffic)
    if cell.traffic["loop"] == "closed_batches":
        cell.traffic.update(batch=48, check_calls=3, warm_calls=1)
    else:
        # 8-bit codes of 8-d sub-vectors, as the configuration's, and many
        # small clusters: with 4-bit codes or a few tight clusters the
        # control's rounding would seldom move a row or a code
        cfg["index"].update(num_bits=8)
        cfg.update(dim=64)
        cfg["data"].update(n_coarse=1024, n_parents=16384)
        cell.traffic.update(check_sample_rows=1024, check_search_batch=48)
    return cell
