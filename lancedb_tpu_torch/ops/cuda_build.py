"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -shared -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``lancedb_tpu_torch/_build/`` under a name that
carries a hash of the source, so an edited source never loads a stale
library. Nothing builds at import time: ``load(name)`` builds on first
use, and ``build_all()`` starts one nvcc per source at once. A failed
build raises with nvcc's own message.

Each source exports ``<name>_launch(pointers..., ints..., stream)``,
returning a CUDA error code, and ``<name>_error_string(code)``;
``launch()`` calls the first on PyTorch's current stream and raises with
the second.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict = {}  # their launch entries, by name
# ptxas report (registers, shared memory, spills) of each build, by source
build_logs: dict[str, str] = {}

# launches of each kernel, counted by its wrapper where it launches it
# (through count_launch: the query server launches from several threads)
launch_counts: dict[str, int] = {
    "ivf_pq_adc_scan": 0, "ivf_pq_adc_grouped_scan": 0, "ivf_flat_grouped_scan": 0,
    "ivf_flat_scan": 0, "adc_sum_select": 0, "adc_sum_gather": 0, "smem_gather": 0,
    "group_plan": 0,
}
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count, under a lock: a bare ``+= 1``
    on the dict is a read-modify-write that concurrent threads can lose."""
    with _count_lock:
        launch_counts[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA toolkit's nvcc")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, cmd)


def _finish(name: str, target: Path, started) -> None:
    if started is None:
        return
    proc, tmp, cmd = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu ({' '.join(cmd)}):\n{out}")
    os.replace(tmp, target)


def build_all() -> dict[str, Path]:
    """Compile every source, one nvcc process each, all started together."""
    with _lock:
        started = {name: _start(name) for name in sources()}
        for name, (target, st) in started.items():
            _finish(name, target, st)
        return {name: target for name, (target, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, st = _start(name)
            _finish(name, target, st)
            lib = _libs[name] = ctypes.CDLL(str(target))
    return lib


def _entry(name: str, nptrs: int, nints: int):
    """``<name>_launch`` of the library, its argument types set (ctypes
    would cut 64-bit pointers without them)."""
    fn = _entries.get(name)
    if fn is None:
        lib = load(name)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * nptrs + [ctypes.c_int] * nints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _entries[name] = fn
    return fn


def _raw_stream(index: int) -> int:
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(index) if get is not None else torch.cuda.current_stream(index).cuda_stream


def launch(name: str, ptrs: list[int], ints: list[int], device: torch.device) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` on ``device``'s current
    stream: ``ptrs`` are ``data_ptr()`` values (0 for a null pointer),
    ``ints`` the C ints after them. Raises if the launch is refused. The
    host's part is kept short (no stream object, no device switch where
    the device is current): on the main path it runs once per launch."""
    fn = _entry(name, len(ptrs), len(ints))
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        code = fn(*ptrs, *ints, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*ptrs, *ints, _raw_stream(index))
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def max_smem_bytes() -> int:
    """Shared memory one block may opt into on the current card, as the
    CUDA runtime reports it (through ``csrc/adc_scan.cu``'s C entry)."""
    return _max_smem_bytes(torch.cuda.current_device())


@functools.cache
def _max_smem_bytes(index: int) -> int:
    fn = load("adc_scan").adc_scan_max_smem_bytes
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@functools.cache
def static_smem_bytes(name: str) -> int:
    """Static shared memory of the kernel of ``csrc/<name>.cu``, which its
    ``<name>_static_smem_bytes`` entry reads from the CUDA runtime."""
    fn = getattr(load(name), f"{name}_static_smem_bytes")
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()
