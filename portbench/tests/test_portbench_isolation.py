"""No run may load JAX or the JAX package, compared by whole top-level
names; the reference imports nothing of the port."""

import subprocess
import sys

from portbench import isolation, spec


def test_top_level_names_are_compared_whole():
    mods = ["lancedb_tpu_torch", "lancedb_tpu_torch.index.vector", "numpy", "jaxtyping"]
    assert isolation.forbidden_modules(mods) == []
    assert isolation.forbidden_modules(mods + ["lancedb_tpu.ops"]) == ["lancedb_tpu.ops"]
    assert isolation.forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client"]


def test_reference_imports_nothing_of_the_port():
    assert isolation.reference_imports(spec.HERE / "reference") == []


def test_scan_flags_a_planted_import(tmp_path):
    (tmp_path / "a.py").write_text("import numpy\nfrom lancedb_tpu_torch.ops import adc\n")
    (tmp_path / "b.py").write_text("import jax.numpy as jnp\nfrom .x import y\n")
    assert isolation.reference_imports(tmp_path) == [
        "a.py: lancedb_tpu_torch.ops", "b.py: jax.numpy"]


def test_the_harness_loads_no_jax():
    """Importing the harness, the port and the reference in a fresh
    interpreter loads no forbidden module."""
    code = ("import sys, portbench.run, portbench.control, portbench.drive, "
            "portbench.reference.judge, lancedb_tpu_torch; "
            "from portbench import isolation; print(isolation.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.HERE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    """The benchmark's files alone: the run exits non-zero and prints nothing."""
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.HERE.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sift1m_ivfpq.batch256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
