"""lancedb_tpu_torch stands alone: it imports neither JAX nor lancedb_tpu,
and it runs on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pydantic
import pytest
import torch

import lancedb_tpu_torch

REPO = Path(__file__).resolve().parent.parent

_SMOKE = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["lancedb_tpu"] = None  # and so does any import of the reference
import numpy as np, pyarrow as pa, torch
import lancedb_tpu_torch
from lancedb_tpu_torch.index import HnswFlat, IvfFlat, IvfPq, IvfRq, IvfSq
from lancedb_tpu_torch.index import multivector
from lancedb_tpu_torch.ops.distance import hamming_distance
from lancedb_tpu_torch.ops import ivf_pq_adc_grouped_scan
from lancedb_tpu_torch.ops.probe_kernels import adc_sum, smem_gather
from lancedb_tpu_torch.probes import ab_adc8, ab_gather_min, common, probe_adc_grouped, probe_pq_real
from lancedb_tpu_torch.probes import probe_deep100m, probe_scale_30m
from lancedb_tpu_torch import native, query_fts
from lancedb_tpu_torch.filters import substrait
from lancedb_tpu_torch.index import fts, scalar, tokenizer
from lancedb_tpu_torch.rerankers import LinearCombinationReranker, MRRReranker, RRFReranker
from lancedb_tpu_torch import blob, context, lsm, pydantic, test_utils
from lancedb_tpu_torch.embeddings import get_registry, multimodal, providers, rest_providers

rng = np.random.default_rng(0)
x = rng.standard_normal((600, 16)).astype(np.float32)
words = np.array(["alpha", "beta", "gamma", "delta", "epsilon"])
tbl = lancedb_tpu_torch.connect(sys.argv[1], device="cpu").create_table("t", pa.table({
    "id": np.arange(600), "category": np.arange(600) % 10,
    "text": [" ".join(words[rng.integers(0, 5, 4)]) for _ in range(600)],
    "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 16),
}))
tbl.create_index(config=IvfPq(num_partitions=4, num_sub_vectors=4, num_bits=4, max_iterations=5))
out = tbl.search(x[7] + 0.01).nprobes(4).refine_factor(10).limit(3).to_arrow()
assert out["id"][0].as_py() == 7, out
tbl.create_index(config=IvfFlat(num_partitions=4, max_iterations=5))
out = tbl.search(x[9] + 0.01).nprobes(2).limit(3).to_arrow()
assert out["id"][0].as_py() == 9, out
tbl.create_fts_index("text")
tbl.create_scalar_index("category", index_type="BITMAP")
assert native.native_available()
assert tbl.search("gamma", query_type="fts").limit(3).to_arrow().num_rows == 3
for rr in (RRFReranker(), LinearCombinationReranker(), MRRReranker()):
    out = tbl.search((x[9] + 0.01, "gamma delta")).nprobes(2).where("category = 9").limit(3)
    assert out.rerank(rr).to_arrow()["id"][0].as_py() == 9, out
tbl.create_index(config=HnswFlat(m=8))
out = tbl.search(x[5] + 0.01).ef(32).limit(3).to_arrow()
assert out["id"][0].as_py() == 5, out
for cfg in (IvfSq(num_partitions=4, max_iterations=5), IvfRq(num_partitions=4, max_iterations=5)):
    tbl.create_index(config=cfg)
    out = tbl.search(x[3] + 0.01).nprobes(4).refine_factor(5).limit(3).to_arrow()
    assert out["id"][0].as_py() == 3, out
out = tbl.search(x[3]).metric("dot").distance_range(upper_bound=0.0).offset(1).limit(3)
assert out.where("category < 5").postfilter().to_arrow().num_rows <= 3
assert tbl.search(x[3]).bypass_vector_index().fast_search().limit(1).to_arrow()["id"][0].as_py() == 3
bits = rng.integers(0, 256, (4, 8), dtype=np.uint8)
assert hamming_distance(torch.from_numpy(bits), torch.from_numpy(bits)).diagonal().sum() == 0
mv = lancedb_tpu_torch.connect(sys.argv[1], device="cpu").create_table("mv", pa.table({
    "id": np.arange(30),
    "vector": pa.array([x[i : i + 3].tolist() for i in range(30)],
                       type=pa.list_(pa.list_(pa.float32(), 16))),
}))
mv.create_index()
assert mv.search(x[10:13]).limit(1).to_arrow()["id"][0].as_py() == 10
assert multivector.maxsim_rescore(x[:2], [x[:2]], device="cpu")[0] > 1.99
args = probe_adc_grouped.make_inputs(rng, 8, 16, "cpu", p=16, pmax=128, q=8, np_=3)
assert ivf_pq_adc_grouped_scan(*args).shape == (8, 3, 128)
assert adc_sum(args[1], args[2], 5, "select").shape == (5, 128)
x, idx = ab_gather_min.make_inputs(8, 128, 1)
assert smem_gather(torch.from_numpy(x), torch.from_numpy(idx), 1).shape == (8, 128)
# the lifecycle: upsert, update, optimize, time travel, plain scans, plans,
# jobs, the background refresher and the async surface
import asyncio
from lancedb_tpu_torch import aio, jobs, session
tbl.merge_insert("id").when_matched_update_all().when_not_matched_insert_all().execute(
    pa.table({"id": [7, 900], "category": [1, 2], "text": ["alpha", "beta"],
              "vector": pa.FixedSizeListArray.from_arrays(pa.array(np.zeros(32, np.float32)), 16)}))
tbl.update(where="category = 3", values={"category": 42})
assert tbl.optimize()["indices_rebuilt"] >= 1 and tbl.count_rows() == 601
v = tbl.version
tbl.checkout(v - 1); tbl.checkout_latest()
assert tbl.query().where("category = 42").to_arrow().num_rows == 60
assert "ANNSubIndexExec" in tbl.search(np.ones(16, np.float32)).analyze_plan()
assert tbl.create_index_async(index_type="FLAT").wait(timeout=60) is None
db2 = lancedb_tpu_torch.connect(sys.argv[1], device="cpu", read_consistency_interval=0.1)
db2.open_table("t")
db2.close()
assert db2._refresher.stop(timeout=5)
async def _count():
    t = await (await lancedb_tpu_torch.connect_async(sys.argv[1], device="cpu")).open_table("t")
    return await t.count_rows()
assert asyncio.run(asyncio.wait_for(_count(), 60)) == 601
# the mesh (sharded serving on two CPU shards) and the training feed
from lancedb_tpu_torch.data import StreamingDataset, TorchBatchFeeder, permutation_builder
from lancedb_tpu_torch.parallel import make_mesh
tbl.enable_sharded_serving(make_mesh(devices=["cpu", "cpu"]))
tbl.create_index(config=IvfPq(num_partitions=4, num_sub_vectors=4, max_iterations=5))
x11 = np.random.default_rng(0).standard_normal((600, 16)).astype(np.float32)[11]  # the table's row
assert tbl.search(x11 + 0.01).nprobes(4).refine_factor(10).limit(1).to_arrow()["id"][0].as_py() == 11
tbl.disable_sharded_serving()
sds = StreamingDataset(permutation_builder(tbl).shuffle(seed=1).execute(), num_splits=2)
batch = next(iter(TorchBatchFeeder(sds, 8, columns=["vector"], mesh=make_mesh(devices=["cpu"] * 2))))
assert [tuple(b.shape) for b in batch["vector"]] == [(4, 16), (4, 16)]
# embedding functions, a pydantic model, blobs and the LSM write path
fn = get_registry().get("hash").create(dim=16)
class Doc(pydantic.LanceModel):
    id: int
    text: str = fn.SourceField()
    vector: pydantic.Vector(16) = fn.VectorField()
docs = lancedb_tpu_torch.connect(sys.argv[1], device="cpu").create_table("docs", schema=Doc)
docs.add([{"id": i, "text": f"w{i} w{i + 1} w{i % 3}"} for i in range(40)])
assert docs.search("w7 w8 w1", query_type="vector").limit(1).to_pydantic(Doc)[0].id == 7
docs.set_lsm_write_spec("bucket", key_columns=["id"], num_shards=2)
v = fn.compute_source_embeddings(["new text"])[0].tolist()
docs.merge_insert("id").when_matched_update_all().when_not_matched_insert_all().use_lsm(
    ).execute([{"id": 99, "text": "new text", "vector": v}])
assert docs.query().use_lsm().to_arrow().num_rows == 41 and docs.flush_lsm()["rows_flushed"] == 1
b = lancedb_tpu_torch.connect(sys.argv[1], device="cpu").create_table(
    "b", schema=pa.schema([pa.field("id", pa.int64()), blob.blob_field("media")]))
b.add([{"id": 0, "media": b"payload"}])
assert b.fetch_blobs("media", [0]) == [b"payload"]
assert context.contextualize([{"text": "a b c"}]).text_col("text").window(2).to_list()
# SQL: a grouped scan, fts() with a WHERE, a join through the spilling path
from lancedb_tpu_torch import sql, sql_spill
sdb = lancedb_tpu_torch.connect(sys.argv[1], device="cpu")
assert sdb.sql("SELECT COUNT(*) AS n FROM t").to_pydict() == {"n": [601]}
assert sdb.sql("SELECT id FROM fts(t, 'gamma', 3) WHERE category = 9").num_rows <= 3
sdb.create_table("k", pa.table({"id": np.arange(50), "w": np.arange(50) * 2}))
sdb.create_table("k2", pa.table({"id": np.arange(0, 600, 3)}))
lancedb_tpu_torch.set_sql_memory_budget(1 << 16)
assert sdb.sql("SELECT COUNT(*) AS n FROM k JOIN k2 ON k.id = k2.id").to_pydict() == {"n": [17]}
lancedb_tpu_torch.set_sql_memory_budget(None)
# the query server and its client, the namespace catalogues and the rest
# of the surface
from lancedb_tpu_torch import expr, integrations, metrics, namespace, namespace_rest, scannable
from lancedb_tpu_torch.remote import QueryServer, batching, oauth, protocol
from lancedb_tpu_torch.rerankers import ColbertReranker, CohereReranker, CrossEncoderReranker
from lancedb_tpu_torch.ops.topk import blocked_topk_scan
with QueryServer(sdb, batch_window_ms=0) as srv:
    rdb = lancedb_tpu_torch.connect("db://x", host_override=srv.url)
    assert rdb.open_table("t").search(x11).nprobes(4).limit(1).to_arrow()["id"][0].as_py() == 11
    assert rdb.sql("SELECT COUNT(*) AS n FROM k").to_pydict() == {"n": [50]}
ns = lancedb_tpu_torch.connect_namespace(sys.argv[1] + "/catalog", device="cpu")
ns.create_namespace(["prod"])
ns.create_table(["prod", "items"], pa.table({"id": np.arange(40), "vector": pa.FixedSizeListArray
    .from_arrays(pa.array(x11.tolist() * 40, pa.float32()), 16)}))
with lancedb_tpu_torch.NamespaceServer(sys.argv[1] + "/catalog", device="cpu") as nsrv:
    client = lancedb_tpu_torch.connect_namespace_client(nsrv.address, device="cpu")
    assert client.open_table(["prod", "items"]).search(x11).limit(2).to_arrow().num_rows == 2
assert tbl.count_rows((expr.col("id") < 5).sql()) == 5
assert integrations.to_pyarrow_dataset(tbl).count_rows(filter="id < 5") == 5
assert scannable.to_scannable({"a": [1, 2]}).num_rows == 2
assert any(c["name"] == "lancedb.queries" for c in metrics.snapshot_metrics()["counters"])
v, i = blocked_topk_scan(lambda b: (torch.arange(4.0).repeat(2, 1), torch.arange(4)), 2, 3, 2)
assert i.tolist() == [[0, 0, 1]] * 2
# several processes: the dryrun's two ranks over gloo, each child with jax
# and the reference made unimportable as here
import subprocess
from lancedb_tpu_torch.parallel import distributed, dryrun_two_process
child = ("import sys; sys.modules['jax'] = None; sys.modules['lancedb_tpu'] = None; "
         "from lancedb_tpu_torch.parallel.dryrun_two_process import main; "
         "sys.exit(main(sys.argv[1:]))")
port = distributed.free_port()
kids = [subprocess.Popen([sys.executable, "-c", child, "--child", str(r), "--coordinator",
                          f"127.0.0.1:{port}", "--device", "cpu", "--timeout", "60"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
try:
    outs = [k.communicate(timeout=120)[0] for k in kids]
finally:
    for k in kids:
        k.kill()
        k.wait(timeout=30)
assert all(k.returncode == 0 for k in kids), outs
assert "TWO_PROCESS_DRYRUN OK workers=2 rows=512" in outs[0], outs
assert all("jax or lancedb_tpu in sys.modules: none" in o for o in outs), outs
assert not any(m == "jax" or m.startswith(("jax.", "lancedb_tpu."))
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""


def test_runs_without_jax_or_reference(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _SMOKE, str(tmp_path / "db")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _forbidden_imports(path: Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "lancedb_tpu"):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
    return bad


def test_no_jax_or_reference_imports():
    files = sorted((REPO / "lancedb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [b for f in files for b in _forbidden_imports(f)]
    assert not bad, bad


class _IdModel(pydantic.BaseModel):
    id: int


def test_unported_surface_names_its_roadmap_item(tmp_path):
    import numpy as np
    import pyarrow as pa

    db = lancedb_tpu_torch.connect(str(tmp_path), device="cpu")
    x = np.zeros((4, 8), np.float32)
    tbl = db.create_table("t", pa.table({
        "id": np.arange(4), "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 8),
    }))
    assert db.table_names() == ["t"] and db.open_table("t").count_rows() == 4
    # what ROADMAP A12b lifted is served: SQL over the connection's tables
    assert db.sql("SELECT 1").num_rows == 1
    assert db.sql("SELECT COUNT(*) AS n FROM t").to_pydict() == {"n": [4]}
    # what ROADMAP A12e and A12f lifted is served: the namespace methods,
    # and db:// through a server, which owns the device (so a device beside
    # a db:// URI is refused); no method of the port names a ROADMAP item
    db.create_namespace(["ns"])
    assert db.list_namespaces() == ["ns"] and db.table_names() == ["t"]
    from lancedb_tpu_torch.errors import InvalidInputError

    with pytest.raises(InvalidInputError, match="server's device"):
        lancedb_tpu_torch.connect("db://remote", device="cpu")
    with pytest.raises(AttributeError):
        tbl.no_such_method
    with pytest.raises(AttributeError):
        db.no_such_method
    for path in (REPO / "lancedb_tpu_torch").rglob("*.py"):
        assert "not ported to lancedb_tpu_torch" not in path.read_text(), path
    # what ROADMAP A12a, A12c and A12d lifted is served: a text query on a
    # table without an embedding function and a search with use_lsm are
    # refused as the reference refuses them, the rest runs
    for call in (lambda: tbl.search("some text", query_type="vector"),
                 lambda: tbl.search(x[0]).use_lsm().to_arrow(),
                 lambda: tbl.fetch_blobs("vector", [0])):
        with pytest.raises(InvalidInputError):
            call()
    tbl.set_lsm_write_spec("unsharded", key_columns="id")
    assert tbl.merge_insert("id").use_lsm()._use_lsm
    assert tbl.query().use_lsm().to_arrow().num_rows == 4
    assert tbl.embedding_functions == {} and tbl.blob_columns == []
    assert len(tbl.search(x[0]).limit(2).to_pydantic(_IdModel)) == 2


def test_default_device_is_cuda_without_fallback(tmp_path):
    if torch.cuda.is_available():
        assert lancedb_tpu_torch.connect(str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lancedb_tpu_torch.connect(str(tmp_path))
    assert lancedb_tpu_torch.connect(str(tmp_path), device="cpu").device.type == "cpu"
