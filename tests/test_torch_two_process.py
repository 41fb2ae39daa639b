"""Two processes under torch.distributed: lancedb_tpu_torch.parallel's
process mesh against the one-process mesh, the reference and numpy.

The pair (python -m lancedb_tpu_torch.parallel.dryrun_two_process
--device cpu) is spawned once for the module: two ranks of 4 CPU cells
each over gloo, 8 cells in all. Its k-means, flat and IVF_FLAT results
must be bit-equal to the port's one-process mesh of the same 8 cells
(computed here at the children's torch thread count), its k-means counts
and flat ids equal to the reference's 8-device mesh (centroids within
1e-5, the tolerance of test_kmeans_step_matches_reference) and to numpy;
each rank's feed equals the reference's StreamingDataset for that rank.
A rank that dies before its first collective, or never comes, fails the
other within the collective timeout.
"""

import os
import signal
import socket
import subprocess
import sys
import time
import uuid
from pathlib import Path

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import lancedb_tpu
import lancedb_tpu.data as RD
import lancedb_tpu.parallel as RP
import lancedb_tpu_torch
import lancedb_tpu_torch.parallel as TP
from lancedb_tpu_torch.errors import InvalidInputError
from lancedb_tpu_torch.parallel import distributed
from lancedb_tpu_torch.parallel import dryrun_two_process as DR
from lancedb_tpu_torch.parallel.mesh import Mesh

REPO = Path(__file__).resolve().parent.parent
PAIR_TIMEOUT_S = 240  # the spawned pair's limit; it takes about 10 s
COLLECTIVE_TIMEOUT_S = 20.0
ALONE_TIMEOUT_S = 3.0

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _start(*args):
    """The dryrun in a session of its own, so that its ranks die with it."""
    return subprocess.Popen(
        [sys.executable, "-m", "lancedb_tpu_torch.parallel.dryrun_two_process", "--device",
         "cpu", *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _kill(proc):
    """The process and every rank it started."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


def _finish(proc, started):
    """(exit code, stdout, stderr, seconds since the start), the process
    and its ranks killed if it outlives PAIR_TIMEOUT_S."""
    try:
        out, err = proc.communicate(timeout=max(1.0, started + PAIR_TIMEOUT_S - time.monotonic()))
    except subprocess.TimeoutExpired:
        _kill(proc)
        out, err = proc.communicate(timeout=30)
        pytest.fail(f"the dryrun outlived {PAIR_TIMEOUT_S} s:\n{out}\n{err}")
    return proc.returncode, out, err, time.monotonic() - started


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, started together: the pair with --out,
    the pair with rank 0 and with rank 1 exiting before their first
    collective, and rank 0 alone (its peer never comes)."""
    out = tmp_path_factory.mktemp("dryrun") / "pair.npz"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    started = time.monotonic()
    timeout = ["--timeout", str(COLLECTIVE_TIMEOUT_S)]
    procs = {"pair": _start("--out", str(out), *timeout),
             "exit0": _start("--exit-rank", "0", *timeout),
             "exit1": _start("--exit-rank", "1", *timeout),
             "alone": _start("--child", "0", "--coordinator", f"127.0.0.1:{port}", "--timeout",
                             str(ALONE_TIMEOUT_S))}
    try:
        done = {name: _finish(p, started) for name, p in procs.items()}
    finally:
        for p in procs.values():
            _kill(p)  # a rank left behind by its parent goes too
    rc, stdout, stderr, _ = done["pair"]
    assert rc == 0, stdout + stderr
    with np.load(out) as z:
        done["ranks"] = [{k.split("_", 1)[1]: z[k] for k in z.files if k.startswith(f"rank{r}_")}
                         for r in range(2)]
    return done


@pytest.fixture(scope="module")
def pair(runs):
    """(the parent's stdout, each rank's results)."""
    return runs["pair"][1], runs["ranks"]


@pytest.fixture(scope="module")
def data():
    return DR.dryrun_data()


@pytest.fixture(scope="module")
def one_process(data):
    """The same steps on the port's one-process mesh of 8 CPU cells, at
    the children's thread count (a product's bits may follow it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(DR.CHILD_THREADS)
    try:
        x, q = data["x"], data["q"]
        mesh = TP.make_mesh(devices=["cpu"] * 8)
        step = TP.make_distributed_kmeans_step(mesh, k=DR.K_CLUSTERS)
        xj = TP.shard_rows(mesh, x, over=("query", "shard"))
        cents = TP.replicate(mesh, x[:DR.K_CLUSTERS].copy())
        out = {}
        for s in range(DR.KMEANS_STEPS):
            cents, counts = step(xj, cents)
            out[f"kmeans_centroids_{s}"] = cents[0][0].numpy()
            out[f"kmeans_counts_{s}"] = counts[0][0].numpy()
        norms2 = np.sum(x.astype(np.float64) ** 2, axis=1).astype(np.float32)
        vals, ids = TP.make_sharded_flat_search(mesh, k=DR.FLAT_K)(
            TP.shard_rows(mesh, q, over="query"), TP.shard_rows(mesh, x),
            TP.shard_rows(mesh, norms2), TP.shard_rows(mesh, np.arange(DR.N_ROWS, dtype=np.int32)))
        out["flat_vals"], out["flat_ids"] = vals.numpy(), ids.numpy()
        for name, qp in (("1x8", 1), ("2x4", 2)):
            out[f"ivf_{name}_vals"], out[f"ivf_{name}_ids"] = DR.ivf_part(
                TP.make_mesh(devices=["cpu"] * 8, query_parallel=qp), data)
        out["flat_index_2x4_vals"], out["flat_index_2x4_ids"] = TP.ShardedFlatIndex(
            TP.make_mesh(devices=["cpu"] * 8, query_parallel=2), x,
            np.arange(DR.N_ROWS, dtype=np.uint64) * 7).search(q, DR.FLAT_K)
        out["dkm_centroids"] = TP.distributed_kmeans(mesh, x[:DR.DKM_ROWS], DR.K_CLUSTERS,
                                                     iters=DR.DKM_ITERS, seed=0)
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def reference(data):
    """The reference's steps on its 8 virtual devices."""
    x, q = data["x"], data["q"]
    rm = RP.make_mesh(8)
    step = RP.make_distributed_kmeans_step(rm, k=DR.K_CLUSTERS)
    xj = jax.device_put(x, NamedSharding(rm, P(("query", "shard"), None)))
    cents = jax.device_put(x[:DR.K_CLUSTERS].copy(), NamedSharding(rm, P()))
    out = {}
    for s in range(DR.KMEANS_STEPS):
        cents, counts = step(xj, cents)
        out[f"kmeans_centroids_{s}"] = np.asarray(cents)
        out[f"kmeans_counts_{s}"] = np.asarray(counts)
    norms2 = np.sum(x.astype(np.float64) ** 2, axis=1).astype(np.float32)

    def put(a, spec):
        return jax.device_put(a, NamedSharding(rm, spec))

    vals, ids = RP.make_sharded_flat_search(rm, k=DR.FLAT_K)(
        put(q, P("query", None)), put(x, P("shard", None)), put(norms2, P("shard")),
        put(np.arange(DR.N_ROWS, dtype=np.int32), P("shard")))
    out["flat_vals"], out["flat_ids"] = np.asarray(vals), np.asarray(ids)
    return out


# ------------------------------------------------------------ the dryrun


def test_dryrun_succeeds_with_the_per_worker_display(pair):
    stdout, _ = pair
    assert "--- worker 0 ---" in stdout and "--- worker 1 ---" in stdout
    assert "TWO_PROCESS_DRYRUN OK workers=2 rows=512" in stdout
    assert "ShardedScanExec: rows=256, metrics=[elapsed_compute=" in stdout
    for r in range(2):
        assert f"rank {r}: processes 2" in stdout


@pytest.mark.parametrize("rank", [0, 1])
def test_per_worker_metrics_name_two_workers(pair, rank):
    workers = pair[1][rank]["workers"]
    assert workers.shape == (2, 3)
    assert workers[:, 0].tolist() == [0.0, 1.0] and workers[:, 1].tolist() == [256.0, 256.0]
    assert np.all(workers[:, 2] > 0)


@pytest.mark.parametrize("rank", [0, 1])
def test_children_import_no_jax(pair, rank):
    stdout, ranks = pair
    assert bool(ranks[rank]["no_jax"])
    line = next(s for s in stdout.splitlines() if s.startswith(f"rank {rank}: processes"))
    assert line.endswith("jax or lancedb_tpu in sys.modules: none")


def test_process_mesh_orders_ranks_like_the_global_device_list(pair):
    for res in pair[1]:
        np.testing.assert_array_equal(res["owner_1x8"], [[0, 0, 0, 0, 1, 1, 1, 1]])
        np.testing.assert_array_equal(res["owner_2x4"], [[0, 0, 0, 0], [1, 1, 1, 1]])


def test_every_rank_gets_every_result(pair):
    r0, r1 = pair[1]
    shared = [k for k in r0 if not k.startswith(("feed_", "owner_", "no_jax"))]
    assert len(shared) >= 10
    for k in shared:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


# -------------------------------------------------------------- k-means


@pytest.mark.parametrize("against", ["port_one_process", "reference", "numpy"])
def test_kmeans_matches(pair, data, one_process, reference, against):
    x = data["x"]
    res = pair[1][0]
    assert res[f"kmeans_counts_{DR.KMEANS_STEPS - 1}"].sum() == DR.N_ROWS
    for s in range(DR.KMEANS_STEPS):
        counts, cents = res[f"kmeans_counts_{s}"], res[f"kmeans_centroids_{s}"]
        if against == "port_one_process":
            np.testing.assert_array_equal(counts, one_process[f"kmeans_counts_{s}"])
            np.testing.assert_array_equal(cents, one_process[f"kmeans_centroids_{s}"])
        elif against == "reference":
            np.testing.assert_array_equal(counts, reference[f"kmeans_counts_{s}"])
            np.testing.assert_allclose(cents, reference[f"kmeans_centroids_{s}"], rtol=1e-5,
                                       atol=1e-5)
        else:
            before = x[:DR.K_CLUSTERS] if s == 0 else res[f"kmeans_centroids_{s - 1}"]
            d = ((x[:, None, :].astype(np.float64) - before[None]) ** 2).sum(-1)
            np.testing.assert_array_equal(
                counts, np.bincount(d.argmin(1), minlength=DR.K_CLUSTERS))


def test_distributed_kmeans_matches_one_process(pair, one_process):
    for res in pair[1]:
        np.testing.assert_array_equal(res["dkm_centroids"], one_process["dkm_centroids"])


# ------------------------------------------------------------- searches


@pytest.mark.parametrize("against", ["port_one_process", "reference", "numpy", "flat_index"])
def test_flat_search_matches(pair, data, one_process, reference, against):
    res = pair[1][0]
    if against == "flat_index":
        # ShardedFlatIndex on the 2 x 4 grid: queries split over the ranks
        np.testing.assert_array_equal(res["flat_index_2x4_vals"],
                                      one_process["flat_index_2x4_vals"])
        np.testing.assert_array_equal(res["flat_index_2x4_ids"], res["flat_ids"] * 7)
        np.testing.assert_array_equal(res["flat_index_2x4_ids"],
                                      one_process["flat_index_2x4_ids"])
    elif against == "port_one_process":
        np.testing.assert_array_equal(res["flat_vals"], one_process["flat_vals"])
        np.testing.assert_array_equal(res["flat_ids"], one_process["flat_ids"])
    elif against == "reference":
        np.testing.assert_array_equal(res["flat_ids"], reference["flat_ids"])
        np.testing.assert_allclose(res["flat_vals"], reference["flat_vals"], rtol=1e-5,
                                   atol=1e-5)
    else:
        want = DR.numpy_topk_ids(data["q"], data["x"], DR.FLAT_K, bf16=False)
        np.testing.assert_array_equal(res["flat_ids"], want)


@pytest.mark.parametrize("grid", ["1x8", "2x4"])
def test_ivf_flat_matches_one_process(pair, one_process, grid):
    for res in pair[1]:
        vals, ids = res[f"ivf_{grid}_vals"], res[f"ivf_{grid}_ids"]
        assert vals.shape == ids.shape == (DR.IVF_QUERIES, DR.IVF_K)
        np.testing.assert_array_equal(vals, one_process[f"ivf_{grid}_vals"])
        np.testing.assert_array_equal(ids, one_process[f"ivf_{grid}_ids"])
        assert np.all(ids >= 0) and np.all(ids % DR.IVF_PMAX < DR.IVF_LIVE)  # no padding slot


# ------------------------------------------------------------- the feed


def _reference_stream_ids(data, rank):
    x = data["x"]
    ref = lancedb_tpu.connect(f"memory://{uuid.uuid4().hex}").create_table("rows", pa.table({
        "id": np.arange(len(x), dtype=np.int64),
        "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), x.shape[1]),
    }))
    perm = RD.permutation_builder(ref).shuffle(seed=DR.FEED_SEED).execute()
    sds = RD.StreamingDataset(perm, num_splits=DR.FEED_SPLITS, rank=rank, world_size=2,
                              columns=["id", "vector"])
    return [row["id"] for row in sds]


@pytest.mark.parametrize("rank", [0, 1])
def test_feed_rank_rows_equal_reference_stream(pair, data, rank):
    res = pair[1][rank]
    ids, vecs = res["feed_ids"], res["feed_vectors"]
    assert ids.shape == (DR.N_ROWS // DR.FEED_BATCH, DR.FEED_BATCH // 2)
    assert ids.ravel().tolist() == _reference_stream_ids(data, rank)
    np.testing.assert_array_equal(vecs, data["x"][ids])


def test_feed_ranks_cover_the_table_once(pair):
    both = np.concatenate([res["feed_ids"].ravel() for res in pair[1]])
    assert sorted(both.tolist()) == list(range(DR.N_ROWS))


@pytest.mark.parametrize("rank", [0, 1])
def test_feed_rank_resumes_exactly(pair, rank):
    res = pair[1][rank]
    a, n = DR.FEED_RESUME_AFTER, DR.FEED_RESUMED
    np.testing.assert_array_equal(res["feed_resumed_ids"], res["feed_ids"][a:a + n])


# ------------------------------------------------------------- no hang


@pytest.mark.parametrize("rank", [0, 1])
def test_a_dead_peer_fails_the_other_rank(runs, rank):
    rc, stdout, _, took = runs[f"exit{rank}"]
    assert rc != 0
    assert f"rank {rank}: exiting before the first collective" in stdout
    assert f"=== rank {1 - rank} (exit 1) ===" in stdout  # failed on its own, not killed
    assert "Connection" in stdout and "TWO_PROCESS_DRYRUN FAILED" in stdout
    assert took < COLLECTIVE_TIMEOUT_S + 60


def test_a_missing_peer_fails_within_the_timeout(runs):
    """Rank 0 alone: the rendezvous waits for rank 1 only as long as the
    timeout, then raises."""
    rc, _, stderr, took = runs["alone"]
    assert rc != 0 and "Traceback" in stderr
    assert took < ALONE_TIMEOUT_S + 60


# ------------------------------------------- one process, no group up


def test_without_a_group_a_process_mesh_is_the_local_mesh():
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    m = TP.make_process_mesh(["cpu"] * 4, query_parallel=2)
    assert m.shape == {"query": 2, "shard": 2} and not m.multiprocess
    assert m.cells == [(0, 0), (0, 1), (1, 0), (1, 1)]
    np.testing.assert_array_equal(distributed.process_allgather(np.arange(3)), [[0, 1, 2]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.make_process_mesh(["cuda:0"] * 2)


def test_shard_local_rows_checks_the_rank_share():
    """A rank of a two-process (1, 4) mesh holds blocks 2-3 of 8 rows;
    the rows it passes must be exactly those."""
    m = Mesh([["cpu"] * 4], owner=[[0, 0, 1, 1]], rank=1)
    a = np.arange(16, dtype=np.float32).reshape(8, 2)
    placed = TP.shard_local_rows(m, a[4:], a.shape)
    assert placed[0][0] is None and placed[0][1] is None
    np.testing.assert_array_equal(placed[0][2].numpy(), a[4:6])
    np.testing.assert_array_equal(placed[0][3].numpy(), a[6:8])
    whole = TP.shard_rows(m, a)
    assert whole[0][:2] == [None, None] and torch.equal(whole[0][3], placed[0][3])
    with pytest.raises(ValueError, match="take"):
        TP.shard_local_rows(m, a, a.shape)
    with pytest.raises(ValueError, match="does not split"):
        TP.shard_local_rows(m, a[5:], (7, 2))
    # on a (2, 2) grid over both axes the blocks of rank 1 are 2 and 3,
    # over the shard axis 0 and 1 of each row: both one run of rows
    m22 = Mesh([["cpu"] * 2] * 2, owner=[[0, 0], [1, 1]], rank=1)
    assert TP.shard_local_rows(m22, a[4:], a.shape, over=("query", "shard"))[1][1].shape == (2, 2)
    assert TP.shard_local_rows(m22, a, a.shape)[1][0].shape == (4, 2)


def test_sharded_ivf_pq_refuses_a_multiprocess_mesh(tmp_path):
    m = Mesh([["cpu"] * 4], owner=[[0, 0, 1, 1]], rank=0)
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    with pytest.raises(InvalidInputError, match="one-process mesh"):
        TP.ShardedIvfPqIndex(m, x, np.arange(64, dtype=np.uint64), num_partitions=4)
    tbl = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", pa.table({
        "id": np.arange(64), "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 8)}))
    with pytest.raises(InvalidInputError, match="one-process mesh"):
        tbl.enable_sharded_serving(m)
