"""The training feed: lancedb_tpu_torch.data against lancedb_tpu.data.

The same seeded tables go into both packages (the reference's in
memory, the port's on the CPU); permutations, StreamingDataset streams
and resumes, the external shuffle and the feeders must give the same
rows in the same order. TorchBatchFeeder on a mesh of 8 CPU devices is
held to JaxBatchFeeder on the 8 virtual devices tests/conftest.py gives
the reference, down to each device's block of rows.
"""

import functools
import pickle
import threading
import time
import uuid
from dataclasses import dataclass

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

import lancedb_tpu
import lancedb_tpu.data as RD
import lancedb_tpu_torch
import lancedb_tpu_torch.data as TD
from lancedb_tpu.data.shuffle import external_shuffle as ref_shuffle
from lancedb_tpu_torch.data.shuffle import external_shuffle as port_shuffle
from lancedb_tpu_torch.errors import InvalidInputError
from lancedb_tpu_torch.parallel import make_mesh

N, DIM = 240, 8


@dataclass
class FakeWorkerInfo:
    id: int
    num_workers: int


def _data(n=N):
    rng = np.random.default_rng(0)
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "value": pa.array(np.arange(n, dtype=np.float64) * 1.5),
        "group": pa.array([f"g{i % 4}" for i in range(n)]),
        "vector": pa.FixedSizeListArray.from_arrays(
            pa.array(rng.standard_normal(n * DIM).astype(np.float32)), DIM),
        "label": pa.array((np.arange(n) % 5).astype(np.int64)),
    })


@pytest.fixture
def bases():
    """The same table in both packages: (reference, port)."""
    ref = lancedb_tpu.connect(f"memory://{uuid.uuid4().hex}").create_table("base", _data())
    port = lancedb_tpu_torch.connect(f"memory://{uuid.uuid4().hex}", device="cpu").create_table(
        "base", _data())
    return ref, port


def _ids(tbl):
    return tbl.column("id").to_pylist()


def _split_ids(perm):
    return [_ids(perm.read(s, 0, perm.split_size(s))) for s in sorted(perm._split_offsets)]


# ------------------------------------------------------------- permutations

BUILDS = {
    "none": lambda b: b,
    "random_fractions": lambda b: b.split_random(seed=1, fractions=[0.75, 0.25]),
    "random_counts_clumped": lambda b: b.split_random(seed=7, counts=[50, 70], clump_size=4),
    "hash": lambda b: b.split_hash(["id"], [1, 1]),
    "hash_discard": lambda b: b.split_hash(["id", "group"], [2, 1], discard_weight=2),
    "sequential": lambda b: b.split_sequential(sizes=[100, 140]),
    "calculated": lambda b: b.split_calculated("id % 3"),
    "filter": lambda b: b.filter("id < 100 AND label != 2"),
    "shuffle": lambda b: b.shuffle(seed=3),
    "split_shuffle_clump": lambda b: b.split_random(seed=2, fractions=[0.5, 0.5]).shuffle(
        seed=5, clump_size=3),
}


@pytest.mark.parametrize("kind", list(BUILDS))
def test_permutation_builder_matches_reference(bases, kind):
    ref, port = bases
    want = BUILDS[kind](RD.permutation_builder(ref)).execute()
    got = BUILDS[kind](TD.permutation_builder(port)).execute()
    assert got.num_splits == want.num_splits and len(got) == len(want)
    assert _split_ids(got) == _split_ids(want)
    cols = got.read(0, 3, 4, columns=["value", "vector"])
    assert cols.equals(want.read(0, 3, 4, columns=["value", "vector"]))


def test_named_splits_and_views_match_reference(bases):
    ref, port = bases
    out = []
    for pkg, base in ((RD, ref), (TD, port)):
        perm = pkg.permutation_builder(base).split_random(
            seed=1, fractions=[0.8, 0.2], split_names=["train", "val"]).execute()
        ps = pkg.Permutations.from_tables(base, perm.perm_table)
        view = ps.get_by_name("val").select_columns(["id", "label"]).with_skip(3).with_take(20)
        out.append((ps.split_names, ps["train"].num_rows, ps[1].shape,
                    [r["id"] for b in view.iter(7) for r in b],
                    view.with_format("numpy").take_offsets([0, 4])["label"].tolist(),
                    sorted(pkg.Permutation.identity(base).unique("group"))))
    assert out[0] == out[1]
    with pytest.raises(InvalidInputError):
        TD.Permutations(port, TD.permutation_builder(port).split_random(
            fractions=[0.5, 0.5]).execute().perm_table)["train"]
    with pytest.raises(InvalidInputError):
        TD.permutation_builder(port).split_random(fractions=[0.5, 0.5], split_names=["a", "a"])


def test_permutation_transforms_and_torch_formats(bases):
    _, port = bases
    p = TD.Permutation.identity(port).select_columns(["id", "value", "label"])
    rows = p.with_format("torch").take_offsets([0, 1])
    assert rows[1]["id"].item() == 1 and rows[1]["value"].dtype == torch.float64
    assert tuple(p.with_format("torch_col").take_offsets([0, 1, 2]).shape) == (3, 3)
    assert isinstance(p.with_format("arrow").take_offsets([0, 1]), pa.RecordBatch)
    loader = torch.utils.data.DataLoader(p.with_format("torch"), batch_size=16)
    assert sorted(i for b in loader for i in b["id"].tolist()) == list(range(N))


def test_pickled_views_carry_the_device(bases, tmp_path):
    """A pickled view reopens its table on the connection's device, from
    memory (fragment by fragment, deletions kept) or by URI."""
    _, mem = bases
    mem.delete("id % 7 = 0")
    local = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", _data(30))
    for base in (mem, local):
        perm = TD.permutation_builder(base).split_random(seed=2).execute()
        view = TD.Permutation.from_tables(base, perm.perm_table, 0).with_skip(2)
        clone = pickle.loads(pickle.dumps(view))
        assert clone.base_table._conn.device.type == "cpu"
        assert clone.__getitems__(list(range(5))) == view.__getitems__(list(range(5)))
    factory = functools.partial(_open_port_table, str(tmp_path))
    view = TD.Permutation.identity(local).with_connection_factory(factory)
    assert pickle.loads(pickle.dumps(view))[5] == view[5]


def _open_port_table(uri, name):
    return lancedb_tpu_torch.connect(uri, device="cpu").open_table(name)


# ---------------------------------------------------------- external shuffle


@pytest.mark.parametrize("budget", [1 << 20, 4096 * 24])
@pytest.mark.parametrize("clump", [None, 5])
def test_external_shuffle_matches_reference(budget, clump):
    rng = np.random.default_rng(4)
    n = 20_000
    rids = rng.permutation(n).astype(np.uint64)
    sids = rng.integers(0, 3, n).astype(np.int32)
    stats = {}
    got = list(port_shuffle(rids, sids, seed=11, clump_size=clump,
                            memory_budget_bytes=budget, _stats=stats))
    want = list(ref_shuffle(rids, sids, seed=11, clump_size=clump, memory_budget_bytes=budget))
    assert stats["spilled"] == (budget < n * 24)
    for (gr, gs), (wr, ws) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gs, ws)
    assert len(got) == len(want)


# -------------------------------------------------------- StreamingDataset


def _stream(pkg, base, shuffle_seed=5, **kw):
    perm = pkg.permutation_builder(base).shuffle(seed=shuffle_seed).execute()
    return pkg.StreamingDataset(perm, **kw)


def _collect(ds):
    return [row["id"] for row in ds]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 12])
def test_streaming_topologies_match_reference(bases, world):
    """Every rank's stream equals the reference's, in order, and their
    union is the table, for each world size over 12 fixed splits."""
    ref, port = bases
    seen = []
    for rank in range(world):
        kw = dict(num_splits=12, rank=rank, world_size=world, read_batch_size=7)
        got = _collect(_stream(TD, port, **kw))
        assert got == _collect(_stream(RD, ref, **kw))
        seen.extend(got)
    assert sorted(seen) == list(range(N))


def test_streaming_workers_and_validation_match_reference(bases):
    ref, port = bases
    for wid in range(3):
        kw = dict(num_splits=12, rank=0, world_size=2,
                  worker_info=FakeWorkerInfo(id=wid, num_workers=3))
        assert _collect(_stream(TD, port, **kw)) == _collect(_stream(RD, ref, **kw))
    perm = TD.permutation_builder(port).execute()
    with pytest.raises(InvalidInputError):
        TD.StreamingDataset(perm, num_splits=7, world_size=2)
    with pytest.raises(InvalidInputError):
        TD.StreamingDataset(perm, num_splits=4, rank=9, world_size=2)
    split = TD.permutation_builder(port).split_random(seed=1, fractions=[0.5, 0.5]).execute()
    with pytest.raises(InvalidInputError, match="split="):
        TD.StreamingDataset(split)
    ds = TD.StreamingDataset(split, split=1, num_splits=4, columns=["value"],
                             transform=lambda t: list(t.column("value").to_numpy() * 2))
    assert len(list(ds)) == 120 and ds.bytes_loaded > 0 and ds.fetch_time > 0


def test_streaming_resume_matches_reference(bases):
    """Resume mid-epoch (exact continuation) and across a change of world
    size (2 ranks → 3), as the reference resumes."""
    ref, port = bases
    out = []
    for pkg, base in ((RD, ref), (TD, port)):
        ds = _stream(pkg, base, shuffle_seed=9, num_splits=6, read_batch_size=5)
        it = iter(ds)
        first = [next(it)["id"] for _ in range(100)]
        state = ds.state_dict()
        del it
        resumed = _stream(pkg, base, shuffle_seed=9, num_splits=6, read_batch_size=5)
        resumed.load_state_dict(state)
        rest = _collect(resumed)
        states, consumed = [], []
        for rank in range(2):
            d = _stream(pkg, base, shuffle_seed=2, num_splits=12, rank=rank, world_size=2)
            it = iter(d)
            consumed.extend(next(it)["id"] for _ in range(45))
            states.append(np.asarray(d.state_dict()["consumed"]))
            del it
        merged = np.maximum.reduce(states).tolist()
        tail = []
        for rank in range(3):
            d = _stream(pkg, base, shuffle_seed=2, num_splits=12, rank=rank, world_size=3)
            d.load_state_dict({"consumed": merged, "num_splits": 12, "total_rows": N})
            tail.extend(_collect(d))
        out.append((first, rest, consumed, tail))
    assert out[0] == out[1]
    first, rest, consumed, tail = out[1]
    assert sorted(first + rest) == list(range(N)) and sorted(consumed + tail) == list(range(N))


def test_streaming_windows_and_views_match_reference(bases):
    """A windowed, column-selected dataset view streams its window; a
    bare table streams in stored order; with_repeat is refused."""
    ref, port = bases
    out = []
    for pkg, base in ((RD, ref), (TD, port)):
        perm = pkg.permutation_builder(base).split_random(seed=3, fractions=[0.5, 0.5]).execute()
        view = (pkg.Permutation.from_tables(base, perm.perm_table, 1)
                .select_columns(["id", "label"]).with_skip(10).with_take(50))
        ds = pkg.StreamingDataset(view, num_splits=5, read_batch_size=6)
        rows = list(ds)
        clone = pickle.loads(pickle.dumps(pkg.StreamingDataset(view, num_splits=5)))
        out.append(([(r["id"], r["label"]) for r in rows], sorted(r.keys() for r in rows[:1]),
                    _collect(pkg.StreamingDataset(base, num_splits=3)), sorted(_collect(clone))))
        with pytest.raises(Exception, match="repeat"):
            pkg.StreamingDataset(view.with_repeat(2))
    assert out[0] == out[1]
    assert len(out[1][0]) == 50


def _worker_row(batch: pa.Table) -> list[dict]:
    init = torch.cuda.is_initialized()
    return [{"id": r["id"], "cuda_initialized": init} for r in batch.to_pylist()]


def test_streaming_two_worker_dataloader(tmp_path):
    """Two spawned DataLoader workers each unpickle the dataset, reconnect
    on the table's device, split the splits between them, and never
    initialise CUDA."""
    base = lancedb_tpu_torch.connect(str(tmp_path), device="cpu").create_table("t", _data())
    perm = TD.permutation_builder(base).shuffle(seed=4).execute()
    ds = TD.StreamingDataset(perm, num_splits=4, columns=["id"], transform=_worker_row)
    loader = torch.utils.data.DataLoader(ds, batch_size=16, num_workers=2, timeout=120,
                                         multiprocessing_context="spawn")
    batches = list(loader)
    assert sorted(i for b in batches for i in b["id"].tolist()) == list(range(N))
    assert not any(b["cuda_initialized"].any() for b in batches)


# ------------------------------------------------------------- the feeders


def _feeders(bases, n_dev=8, batch_size=64, prefetch=2, columns=("vector", "label"), seed=1):
    ref, port = bases
    rds = _stream(RD, ref, shuffle_seed=seed, num_splits=8)
    tds = _stream(TD, port, shuffle_seed=seed, num_splits=8)
    rf = RD.JaxBatchFeeder(rds, batch_size=batch_size, columns=list(columns), prefetch=prefetch)
    tf = TD.TorchBatchFeeder(tds, batch_size=batch_size, columns=list(columns),
                             prefetch=prefetch, mesh=make_mesh(devices=["cpu"] * n_dev))
    return rf, tf


def _ref_blocks(arr):
    """A jax.Array's per-device blocks, in the order of jax.devices()."""
    order = {d: i for i, d in enumerate(jax.devices())}
    return [np.asarray(s.data) for s in sorted(arr.addressable_shards,
                                               key=lambda s: order[s.device])]


def test_torch_feeder_matches_jax_feeder(bases):
    rf, tf = _feeders(bases)
    want, got = list(rf), list(tf)
    assert len(got) == len(want) == len(tf) == N // 64
    for w, g in zip(want, got):
        assert set(g) == {"vector", "label"}
        for col in g:
            blocks = _ref_blocks(w[col])
            assert len(g[col]) == 8 == len(blocks)
            for tb, rb in zip(g[col], blocks):
                # int64 stays int64 here; JAX narrows it to int32 (x64 off)
                assert tb.device.type == "cpu" and tb.dtype in (torch.float32, torch.int64)
                np.testing.assert_array_equal(tb.numpy(), rb)
            np.testing.assert_array_equal(torch.cat(g[col]).numpy(), np.asarray(w[col]))


def test_torch_feeder_one_device_plain_tensors(bases):
    """With one device a column is a plain tensor; integer nested columns
    keep their dtype; a batch that does not split is refused."""
    _, port = bases
    ds = _stream(TD, port, num_splits=8)
    f = TD.TorchBatchFeeder(ds, batch_size=32, columns=["vector", "id"],
                            mesh=make_mesh(devices=["cpu"]))
    b = next(iter(f))
    assert isinstance(b["vector"], torch.Tensor) and b["vector"].shape == (32, DIM)
    assert b["id"].dtype == torch.int64
    big = 1 << 25
    t = lancedb_tpu_torch.connect(f"memory://{uuid.uuid4().hex}", device="cpu").create_table(
        "ints", pa.table({"ids": pa.array([[big + i, i] for i in range(64)],
                                          type=pa.list_(pa.int64()))}))
    f = TD.TorchBatchFeeder(_stream(TD, t, num_splits=8), batch_size=16, columns=["ids"],
                            mesh=make_mesh(devices=["cpu"]))
    arr = next(iter(f))["ids"]
    assert arr.dtype == torch.int64 and int(arr.max()) >= big
    with pytest.raises(InvalidInputError, match="shard|divide"):
        TD.TorchBatchFeeder(ds, batch_size=7, mesh=make_mesh(devices=["cpu"] * 8))
    with pytest.raises(InvalidInputError, match="non-numeric"):
        next(iter(TD.TorchBatchFeeder(_stream(TD, port, num_splits=8), batch_size=8,
                                      columns=["group"], mesh=make_mesh(devices=["cpu"]))))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.TorchBatchFeeder(ds, batch_size=8)  # no mesh: every card, and there is none


def test_torch_feeder_resume(bases):
    """state_dict() after n batches is the state at the n-th batch handed
    out: a new feeder loaded from it yields the uninterrupted run's next
    batches exactly. The reference's state may run up to prefetch + 1
    batches ahead, so its resumed rows are the tail of the same run."""
    rf, tf = _feeders(bases, batch_size=16, columns=("label", "vector"))
    full = [b["label"] for b in _feeders(bases, batch_size=16, columns=("label",))[1]]
    it = iter(tf)
    first = [next(it)["label"] for _ in range(5)]
    state = tf.state_dict()
    it.close()
    again = next(iter(tf))["label"]  # the same feeder continues at batch 6
    for a, b in zip(again, full[5]):
        assert torch.equal(a, b)
    _, tf2 = _feeders(bases, batch_size=16)
    tf2.load_state_dict(state)
    rest = [b["label"] for b in tf2]
    assert len(first) + len(rest) == len(full) == N // 16
    for got, want in zip(first + rest, full):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    it = iter(rf)
    for _ in range(5):
        next(it)
    ref_state = rf.state_dict()
    it.close()
    _, tf3 = _feeders(bases, batch_size=16)
    tf3.load_state_dict(ref_state)
    tail = [torch.cat(b["label"]) for b in tf3]
    flat = [torch.cat(b) for b in full]
    assert len(tail) <= len(flat) - 5 and all(
        torch.equal(a, b) for a, b in zip(tail, flat[len(flat) - len(tail):]))


def test_torch_feeder_releases_on_abandonment(bases):
    _, tf = _feeders(bases, batch_size=16, prefetch=1)
    for _ in tf:
        break  # abandon mid-stream
    deadline = time.time() + 5
    while time.time() < deadline and any(
        th.name == "lancedb-torch-feed" and th.is_alive() for th in threading.enumerate()
    ):
        time.sleep(0.05)
    assert not any(th.name == "lancedb-torch-feed" and th.is_alive()
                   for th in threading.enumerate())
