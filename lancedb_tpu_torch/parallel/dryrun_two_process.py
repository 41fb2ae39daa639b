"""Two processes under torch.distributed, one mesh: the port of the
reference's scripts/dryrun_two_process.py.

    python -m lancedb_tpu_torch.parallel.dryrun_two_process [--device cpu|cuda] [--out FILE]
    python -m lancedb_tpu_torch.parallel.dryrun_two_process --backend nccl  # a card a rank

The parent picks a free 127.0.0.1 port and starts two children with
``subprocess`` (a fresh interpreter each: never a fork after CUDA is
initialised). Each child joins a gloo process group
(parallel/distributed.py; NCCL refuses two ranks on one card), builds a
process mesh of 4 local cells (``cpu`` x 4, or ``cuda:0`` x 4: 8 cells in
all, rank 0's first; with ``--backend nccl`` rank r joins over NCCL and
takes ``cuda:r`` x 4) and runs the reference's three parts at its sizes:

* distributed k-means: 512 x 16 rows (seed 0), each process handing over
  only its half (``shard_local_rows``), two steps of
  ``make_distributed_kmeans_step`` at K 8; the counts sum to 512;
* the sharded flat search, k 5, 4 queries, with shards on both
  processes; its ids equal an exact numpy search (on the card, whose
  products are bf16, one over the bf16-rounded rows and queries);
* per-worker metrics: each process's (rank, rows, scan ms) gathered with
  ``process_allgather``; rank 0 prints one ``--- worker N ---`` section a
  process, then ``TWO_PROCESS_DRYRUN OK workers=2 rows=512``;

then what the reference's mesh also serves: a sharded IVF_FLAT step on the
(1, 8) grid and on the 2 x 4 grid (``query_parallel=2``: rank 0 holds
query row 0, rank 1 row 1), ``ShardedFlatIndex`` on the 2 x 4 grid,
``distributed_kmeans`` over both ranks, and
the training feed: ``TorchBatchFeeder`` over ``StreamingDataset(rank,
world_size=2)``, a global batch of 64 (32 rows a rank), its state after 3
batches resuming the next 2.

``--out FILE`` writes every rank's results into one ``.npz`` (keys
``rank<r>_<name>``). The parent waits on the children with a deadline;
when one fails it gives the other the collective timeout to fail on its
own, then kills what still runs and exits non-zero with each child's
tail. A port can be taken between choosing it and rank 0 binding it
(tests and other jobs pick free ports at the same time): when rank 0
reports the address in use, the parent starts the pair once more on a new
port. ``--exit-rank R`` makes rank R exit right after joining, before its
first collective, which is how the tests show that a dead peer fails the
other rank instead of hanging it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import distributed
from .mesh import (QUERY_AXIS, SHARD_AXIS, first_owned, make_process_mesh, replicate,
                   shard_local_rows, shard_rows)

WORLD, LOCAL_CELLS = 2, 4
N_ROWS, DIM, K_CLUSTERS, KMEANS_STEPS = 512, 16, 8, 2
FLAT_K, FLAT_QUERIES = 5, 4
IVF_PARTS, IVF_PMAX, IVF_LIVE, IVF_NPROBES, IVF_K, IVF_QUERIES = 16, 64, 50, 4, 10, 8
DKM_ROWS, DKM_ITERS = 500, 5  # 500 rows pad to 504 over the 8 cells
FEED_BATCH, FEED_SPLITS, FEED_SEED, FEED_RESUME_AFTER, FEED_RESUMED = 64, 8, 5, 3, 2
PAD = np.float32(3.0e38)
CHILD_THREADS = 1  # torch threads a child on the CPU
PAIR_DEADLINE_S = 600.0
EXIT_RANK_CODE = 3


def dryrun_data(seed: int = 0) -> dict[str, np.ndarray]:
    """Every input of the dryrun, drawn as the reference draws its rows and
    queries (``default_rng(0)``: rows, then queries), then the IVF_FLAT
    partitions: 16 of 64 slots, the last 14 of each padding (norm PAD,
    id -1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    q = rng.standard_normal((FLAT_QUERIES, DIM)).astype(np.float32)
    cents = rng.standard_normal((IVF_PARTS, DIM)).astype(np.float32)
    parts = (cents[:, None, :] + 0.3 * rng.standard_normal((IVF_PARTS, IVF_PMAX, DIM))).astype(
        np.float32)
    norms2 = np.sum(parts.astype(np.float64) ** 2, axis=2).astype(np.float32)
    norms2[:, IVF_LIVE:] = PAD
    rowids = np.arange(IVF_PARTS * IVF_PMAX, dtype=np.int32).reshape(IVF_PARTS, IVF_PMAX)
    rowids[:, IVF_LIVE:] = -1
    ivf_q = (cents[rng.integers(0, IVF_PARTS, IVF_QUERIES)]
             + 0.3 * rng.standard_normal((IVF_QUERIES, DIM))).astype(np.float32)
    return {"x": x, "q": q, "ivf_centroids": cents, "ivf_parts": parts, "ivf_norms2": norms2,
            "ivf_rowids": rowids, "ivf_q": ivf_q}


def numpy_topk_ids(q: np.ndarray, x: np.ndarray, k: int, bf16: bool) -> np.ndarray:
    """Exact l2 top-k ids in float64; ``bf16`` rounds the product's inputs
    to bf16 first, as the card's flat scan does (the norms stay f32)."""
    def rounded(a):
        return torch.from_numpy(a).to(torch.bfloat16).double().numpy() if bf16 else a

    dots = rounded(q).astype(np.float64) @ rounded(x).astype(np.float64).T
    d = (np.sum(q.astype(np.float64) ** 2, 1)[:, None] - 2.0 * dots
         + np.sum(x.astype(np.float64) ** 2, 1)[None, :])
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def feed_table(x: np.ndarray, device: str, root: str):
    """The feed's table: the rows' ids and vectors, in a directory of this
    process's own."""
    import pyarrow as pa

    import lancedb_tpu_torch

    return lancedb_tpu_torch.connect(root, device=device).create_table("rows", pa.table({
        "id": np.arange(len(x), dtype=np.int64),
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), x.shape[1]),
    }))


def feed_part(mesh, tbl, rank: int) -> dict[str, np.ndarray]:
    """This rank's batches of ids and vectors, and the resume after
    FEED_RESUME_AFTER batches."""
    from ..data import StreamingDataset, TorchBatchFeeder, permutation_builder

    perm = permutation_builder(tbl).shuffle(seed=FEED_SEED).execute()
    owned = {mesh.devices[c] for c in mesh.cells}

    def feeder():
        sds = StreamingDataset(perm, num_splits=FEED_SPLITS, rank=rank, world_size=WORLD,
                               columns=["id", "vector"])
        return TorchBatchFeeder(sds, FEED_BATCH, mesh=mesh, columns=["id", "vector"])

    def rows(batch):
        for col in batch.values():
            if len(col) != len(mesh.cells) or any(t.device not in owned for t in col):
                raise AssertionError(f"rank {rank}: a batch is not on this rank's cells")
        return torch.cat(batch["id"]).cpu().numpy(), torch.cat(batch["vector"]).cpu().numpy()

    got = [rows(b) for b in feeder()]
    f = feeder()
    it = iter(f)
    for _ in range(FEED_RESUME_AFTER):
        next(it)
    state = f.state_dict()
    it.close()
    again = feeder()
    again.load_state_dict(state)
    resumed = [rows(b)[0] for b in itertools.islice(again, FEED_RESUMED)]
    return {"feed_ids": np.stack([g[0] for g in got]),
            "feed_vectors": np.stack([g[1] for g in got]),
            "feed_resumed_ids": np.stack(resumed)}


def ivf_part(mesh, d: dict) -> tuple[np.ndarray, np.ndarray]:
    from .search import make_sharded_ivf_search

    step = make_sharded_ivf_search(mesh, k=IVF_K, nprobes=IVF_NPROBES)
    vals, ids = step(shard_rows(mesh, d["ivf_q"], over=QUERY_AXIS),
                     replicate(mesh, d["ivf_centroids"]), shard_rows(mesh, d["ivf_parts"]),
                     shard_rows(mesh, d["ivf_norms2"]), shard_rows(mesh, d["ivf_rowids"]))
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    if np.any(ids < 0) or np.any(vals >= PAD / 2):
        raise AssertionError("the sharded IVF_FLAT step returned a padding slot")
    return vals, ids


def run_child(rank: int, dev: torch.device, root: str) -> dict[str, np.ndarray]:
    """The dryrun's parts on this rank; returns what --out saves."""
    from .build import distributed_kmeans
    from .search import ShardedFlatIndex, make_distributed_kmeans_step, make_sharded_flat_search

    d = dryrun_data()
    x, q = d["x"], d["q"]
    mesh = make_process_mesh([dev] * LOCAL_CELLS)
    if mesh.size != WORLD * LOCAL_CELLS or mesh.process_count != WORLD:
        raise AssertionError(f"a mesh of {mesh.size} cells over {mesh.process_count} processes")
    out: dict[str, np.ndarray] = {"owner_1x8": mesh.owner}
    n_loc = N_ROWS // WORLD
    mine = slice(rank * n_loc, (rank + 1) * n_loc)
    t0 = time.perf_counter()

    # distributed k-means: this rank hands over only its half of the rows
    xj = shard_local_rows(mesh, x[mine], x.shape, over=(QUERY_AXIS, SHARD_AXIS))
    step = make_distributed_kmeans_step(mesh, k=K_CLUSTERS)
    cents = replicate(mesh, x[:K_CLUSTERS].copy())
    for s in range(KMEANS_STEPS):
        cents, counts = step(xj, cents)
        out[f"kmeans_centroids_{s}"] = first_owned(cents).cpu().numpy()
        out[f"kmeans_counts_{s}"] = first_owned(counts).cpu().numpy()
    if out[f"kmeans_counts_{KMEANS_STEPS - 1}"].sum() != N_ROWS:
        raise AssertionError(f"k-means counts {out[f'kmeans_counts_{KMEANS_STEPS - 1}']}")
    kmeans_s = time.perf_counter() - t0

    # the sharded flat search: shards on both processes
    t0 = time.perf_counter()
    norms2 = np.sum(x.astype(np.float64) ** 2, axis=1).astype(np.float32)
    slot_ids = np.arange(N_ROWS, dtype=np.int32)
    flat = make_sharded_flat_search(mesh, k=FLAT_K)
    vals, ids = flat(shard_rows(mesh, q, over=QUERY_AXIS),
                     shard_local_rows(mesh, x[mine], x.shape),
                     shard_local_rows(mesh, norms2[mine], norms2.shape),
                     shard_local_rows(mesh, slot_ids[mine], slot_ids.shape))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["flat_vals"], out["flat_ids"] = vals.cpu().numpy(), ids.cpu().numpy()
    scan_s = time.perf_counter() - t0
    expect = numpy_topk_ids(q, x, FLAT_K, bf16=dev.type == "cuda")
    for i in range(FLAT_QUERIES):
        if set(out["flat_ids"][i].tolist()) != set(expect[i].tolist()):
            raise AssertionError(f"query {i}: ids {out['flat_ids'][i]}, numpy {expect[i]}")

    # per-worker metrics from the two processes (reference query.rs:671-693)
    workers = distributed.process_allgather(
        np.array([float(rank), float(n_loc), scan_s * 1e3], np.float32))
    if workers.shape != (WORLD, 3) or sorted(int(r[0]) for r in workers) != [0, 1]:
        raise AssertionError(f"per-worker metrics {workers}")
    out["workers"] = workers
    if rank == 0:
        print("\n".join(f"--- worker {int(r[0])} ---\nShardedScanExec: rows={int(r[1])}, "
                        f"metrics=[elapsed_compute={r[2]:.2f}ms]" for r in workers), flush=True)
        print(f"TWO_PROCESS_DRYRUN OK workers={len(workers)} rows={int(workers[:, 1].sum())}",
              flush=True)

    # what the reference's mesh also serves: IVF_FLAT on the (1, 8) and
    # the 2 x 4 grid, distributed_kmeans, the feed
    t0 = time.perf_counter()
    out["ivf_1x8_vals"], out["ivf_1x8_ids"] = ivf_part(mesh, d)
    mesh24 = make_process_mesh([dev] * LOCAL_CELLS, query_parallel=2)
    out["owner_2x4"] = mesh24.owner
    out["ivf_2x4_vals"], out["ivf_2x4_ids"] = ivf_part(mesh24, d)
    out["flat_index_2x4_vals"], out["flat_index_2x4_ids"] = ShardedFlatIndex(
        mesh24, x, np.arange(N_ROWS, dtype=np.uint64) * 7).search(q, FLAT_K)
    out["dkm_centroids"] = distributed_kmeans(mesh, x[:DKM_ROWS], K_CLUSTERS, iters=DKM_ITERS,
                                              seed=0)
    ivf_dkm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(feed_part(mesh, feed_table(x, str(dev), root), rank))
    feed_s = time.perf_counter() - t0
    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
        m in ("jax", "lancedb_tpu") or m.startswith(("jax.", "lancedb_tpu."))))
    out["no_jax"] = np.array(not loaded)
    print(f"rank {rank}: processes {distributed.process_count()}, cells {mesh.cells}; "
          f"kmeans {kmeans_s:.3f} s, flat {scan_s:.3f} s, ivf + distributed_kmeans "
          f"{ivf_dkm_s:.3f} s, feed {feed_s:.3f} s; jax or lancedb_tpu in sys.modules: "
          f"{loaded or 'none'}", flush=True)
    return out


def child_main(a) -> int:
    if a.device == "cpu":
        torch.set_num_threads(CHILD_THREADS)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", a.child if a.backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    distributed.initialize(a.coordinator, WORLD, a.child, backend=a.backend, timeout_s=a.timeout)
    if a.exit_rank == a.child:
        print(f"rank {a.child}: exiting before the first collective", flush=True)
        os._exit(EXIT_RANK_CODE)
    try:
        with tempfile.TemporaryDirectory(prefix=f"dryrun_rank{a.child}_") as root:
            out = run_child(a.child, dev, root)
        if a.out:
            np.savez(a.out, **out)
        distributed.shutdown()
    except BaseException:
        # a failed collective can leave the group unable to tear down:
        # report and leave at once
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


def _spawn(a, port: int, workdir: Path):
    """Start both children; each writes its output to files in workdir."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[2]) + os.pathsep + env.get(
        "PYTHONPATH", "")
    if a.device == "cpu":
        env["OMP_NUM_THREADS"] = str(CHILD_THREADS)
    procs = []
    for r in range(WORLD):
        cmd = [sys.executable, "-m", "lancedb_tpu_torch.parallel.dryrun_two_process",
               "--child", str(r), "--coordinator", f"127.0.0.1:{port}", "--device", a.device,
               "--timeout", str(a.timeout), "--backend", a.backend]
        if a.out:
            cmd += ["--out", str(workdir / f"rank{r}.npz")]
        if a.exit_rank is not None:
            cmd += ["--exit-rank", str(a.exit_rank)]
        out = open(workdir / f"rank{r}.out", "w+")
        err = open(workdir / f"rank{r}.err", "w+")
        procs.append((subprocess.Popen(cmd, env=env, stdout=out, stderr=err), out, err))
    return procs


def _wait(procs, grace_s: float) -> list:
    """Each child's exit code; None for one killed at the deadline, or
    ``grace_s`` after another child failed."""
    deadline = time.monotonic() + PAIR_DEADLINE_S
    while time.monotonic() < deadline:
        rcs = [p.poll() for p, _, _ in procs]
        if all(rc is not None for rc in rcs):
            break
        if any(rc not in (None, 0) for rc in rcs):
            deadline = min(deadline, time.monotonic() + grace_s)
        time.sleep(0.05)
    rcs = []
    for p, out, err in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
            rcs.append(None)
        else:
            rcs.append(p.returncode)
        out.close()
        err.close()
    return rcs


def _text(path: Path) -> str:
    return path.read_text(errors="replace")


def parent_main(a) -> int:
    with tempfile.TemporaryDirectory(prefix="dryrun_two_process_") as tmp:
        workdir = Path(tmp)
        for attempt in range(2):
            rcs = _wait(_spawn(a, distributed.free_port(), workdir), grace_s=a.timeout + 15)
            err0 = _text(workdir / "rank0.err")
            in_use = "EADDRINUSE" in err0 or "address already in use" in err0.lower()
            if not (attempt == 0 and rcs[0] != 0 and in_use):
                break
            print("rank 0 found the port taken; starting the pair again on a new port",
                  flush=True)
        for r, rc in enumerate(rcs):
            print(f"=== rank {r} (exit {'killed' if rc is None else rc}) ===", flush=True)
            print(_text(workdir / f"rank{r}.out").rstrip(), flush=True)
            if rc != 0:
                print(f"--- rank {r} stderr (tail) ---\n{_text(workdir / f'rank{r}.err')[-4000:]}",
                      flush=True)
        if any(rc != 0 for rc in rcs):
            print(f"TWO_PROCESS_DRYRUN FAILED exit codes {rcs}", flush=True)
            return 1
        if a.out:
            merged = {}
            for r in range(WORLD):
                with np.load(workdir / f"rank{r}.npz") as z:
                    merged.update({f"rank{r}_{k}": z[k] for k in z.files})
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            np.savez(a.out, **merged)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cpu: 4 CPU cells a rank; cuda: cuda:0 x 4 a rank (the default)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="gloo (the default; two ranks on one card) or nccl (rank r on cuda:r)")
    ap.add_argument("--out", help="write every rank's results to this .npz")
    ap.add_argument("--timeout", type=float, default=distributed.DEFAULT_TIMEOUT_S,
                    help="seconds a rendezvous or collective waits for the other rank")
    ap.add_argument("--exit-rank", type=int, choices=range(WORLD),
                    help="this rank exits right after joining, before its first collective")
    ap.add_argument("--child", type=int, choices=range(WORLD), help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda needs a CUDA card and none is available", file=sys.stderr)
        return 2
    if a.backend == "nccl" and (a.device != "cuda" or torch.cuda.device_count() < WORLD):
        print(f"--backend nccl needs --device cuda and {WORLD} cards", file=sys.stderr)
        return 2
    return child_main(a) if a.child is not None else parent_main(a)


if __name__ == "__main__":
    sys.exit(main())
