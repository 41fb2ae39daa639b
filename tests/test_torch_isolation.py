"""lancedb_tpu_torch stands alone: it imports neither JAX nor lancedb_tpu,
and it runs on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

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
from lancedb_tpu_torch.index import HnswFlat, IvfFlat, IvfPq
from lancedb_tpu_torch.ops import ivf_pq_adc_grouped_scan
from lancedb_tpu_torch.ops.probe_kernels import adc_sum, smem_gather
from lancedb_tpu_torch.probes import ab_adc8, ab_gather_min, common, probe_adc_grouped, probe_pq_real

rng = np.random.default_rng(0)
x = rng.standard_normal((600, 16)).astype(np.float32)
tbl = lancedb_tpu_torch.connect(sys.argv[1], device="cpu").create_table("t", pa.table({
    "id": np.arange(600), "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 16),
}))
tbl.create_index(config=IvfPq(num_partitions=4, num_sub_vectors=4, num_bits=4, max_iterations=5))
out = tbl.search(x[7] + 0.01).nprobes(4).refine_factor(10).limit(3).to_arrow()
assert out["id"][0].as_py() == 7, out
tbl.create_index(config=IvfFlat(num_partitions=4, max_iterations=5))
out = tbl.search(x[9] + 0.01).nprobes(2).limit(3).to_arrow()
assert out["id"][0].as_py() == 9, out
tbl.create_index(config=HnswFlat(m=8))
out = tbl.search(x[5] + 0.01).ef(32).limit(3).to_arrow()
assert out["id"][0].as_py() == 5, out
args = probe_adc_grouped.make_inputs(rng, 8, 16, "cpu", p=16, pmax=128, q=8, np_=3)
assert ivf_pq_adc_grouped_scan(*args).shape == (8, 3, 128)
assert adc_sum(args[1], args[2], 5, "select").shape == (5, 128)
x, idx = ab_gather_min.make_inputs(8, 128, 1)
assert smem_gather(torch.from_numpy(x), torch.from_numpy(idx), 1).shape == (8, 128)
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


def test_unported_surface_names_its_roadmap_item(tmp_path):
    import numpy as np
    import pyarrow as pa

    db = lancedb_tpu_torch.connect(str(tmp_path), device="cpu")
    x = np.zeros((4, 8), np.float32)
    tbl = db.create_table("t", pa.table({
        "id": np.arange(4), "vector": pa.FixedSizeListArray.from_arrays(pa.array(x.ravel()), 8),
    }))
    assert db.table_names() == ["t"] and db.open_table("t").count_rows() == 4
    for call, item in (
        (lambda: tbl.update(where="id = 1", values={"id": 2}), "A4"),
        (lambda: tbl.create_fts_index("id"), "A12"),
        (lambda: tbl.search(x[0]).offset(1), "A4"),
        (lambda: db.drop_table("t"), "A4"),
        (lambda: tbl.create_index(index_type="IVF_RQ"), "A7"),
    ):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            call()
    with pytest.raises(AttributeError):
        tbl.no_such_method


def test_default_device_is_cuda_without_fallback(tmp_path):
    if torch.cuda.is_available():
        assert lancedb_tpu_torch.connect(str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lancedb_tpu_torch.connect(str(tmp_path))
    assert lancedb_tpu_torch.connect(str(tmp_path), device="cpu").device.type == "cpu"
