"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``lancedb_tpu_torch/``. The run draws its rows and queries on the card
from ``--seed``, creates the table in memory (``memory://``) through
``lancedb_tpu_torch.connect``, builds the index, warms the cell's shapes,
measures for ``--seconds`` (``--trace 1``: with spans and torch.profiler,
reporting the per-layer metrics), then frees the port's state and holds
what the window produced to the plain reference. The last line of
standard output is the result (JSON); the last lines of standard error
are each compared number beside its limit. It exits 2 without a result
where there is no card, too few cards, no port in the checkout, or a JAX
module loaded."""

from __future__ import annotations

import time

T0 = time.monotonic()  # the set-up is counted from here (the interpreter's start is not)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import isolation, spec  # noqa: E402

CACHE = ".portbench_cache"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _tracer_parts(cell: spec.Cell):
    spans, counters = {}, {}
    for mod in cell.per_layer.values():
        for name, s in getattr(mod, "SPANS", {}).items():
            if spans.setdefault(name, s) != s:
                raise spec.SpecError(f"span {name!r} declared with two targets")
        counters.update(getattr(mod, "COUNTERS", {}))
    return spans, counters


def _free() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             connect, t0: float | None = None) -> tuple[dict, list[str]]:
    """One run of ``cell`` on ``device`` → (result, the check lines)."""
    import torch

    from . import drive, trace as tr
    from .reference import judge

    cfg, traffic, loop = cell.config, cell.traffic, cell.loop
    cuda = torch.device(device).type == "cuda"
    t0 = time.monotonic() if t0 is None else t0
    t_setup = time.monotonic()
    st = loop.set_up(cfg, traffic, seed, device, connect)
    phases = {"imports": t_setup - t0, **st.phases}
    tracer = prof = None
    if trace:
        spans, counters = _tracer_parts(cell)
        tracer = tr.Tracer(spans, counters, device)
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = int(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t0
    if tracer is not None:
        tracer.__enter__()
        tracer.start_counters()
        if cuda:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
    w_start = time.perf_counter_ns()
    if cuda and prof is not None:
        torch.cuda._sleep(1000)  # the marker that ties the device clock to the host's
    try:
        w = loop.window(st, cfg, traffic, seconds, seed, device, tracer)
    finally:
        if cuda:
            torch.cuda.synchronize()
        w_end = time.perf_counter_ns()
        if prof is not None:
            prof.__exit__(None, None, None)
        if tracer is not None:
            tracer.__exit__(None, None, None)
    w.setup_s = setup_s
    w.peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0
    w.process_peak_bytes = max(setup_peak, w.peak_bytes)
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        window = (w_start, w_end)
        t = tr.Trace(window, w.calls, w.builds, w.queries, w.latencies, records=tracer.records,
                     counters=tracer.counter_deltas(),
                     events=tr.device_events(prof, w_start, window) if prof is not None else [])
        readers = cell.per_layer
        breakdown = t.breakdown() if t.events else None
        dev_extra = {"busy_s": t.busy_s(), "window_s": t.window_s}
    else:
        t = w
        readers = cell.end_to_end
    for name, mod in readers.items():
        v = mod.read(t)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": cell.units[name]}

    # the check: what the window produced, judged once the port's state is freed
    found = loop.answers(st, w, cfg, traffic)
    try:
        drive.close(st)
    finally:
        del st
        _free()
    checks = loop.judge(found, cfg, traffic, seed, device)
    del found
    _free()
    numbers = judge.worst(checks)
    numbers["failed"] = judge.check(w.failed, 0, "<=")
    correct = bool(checks) and all(c["ok"] for c in numbers.values())
    lines = [f"check {name} {c['value']!r} limit {c['op']} {c['limit']!r} "
             f"{'ok' if c['ok'] else 'FAIL'}" for name, c in numbers.items()]
    lines = ([f"setup {' '.join(f'{k} {v:.3f}' for k, v in phases.items())} s"]
             + [f"error {e}" for e in w.errors[:20]] + lines)
    device_doc = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": w.peak_bytes,
        **dev_extra,
    }
    result = {"correct": correct, "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": device_doc}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n_: {"value": c["value"], "limit": c["limit"], "op": c["op"]}
                        for n_, c in numbers.items()}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd().resolve()
    # the program's caches inside the checkout, at fixed paths; no JAX
    # through a library that would load it by itself
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / CACHE / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    try:
        cell = spec.resolve(spec.read_json(root / "BENCHMARK.json"), args.workload, root)
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    try:
        import lancedb_tpu_torch
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e})", file=sys.stderr)
        return 2
    where = Path(lancedb_tpu_torch.__file__).resolve()
    if root not in where.parents:
        print(f"portbench: lancedb_tpu_torch loads from {where}, outside {root}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card (nvidia-smi name, power.limit): {card}", file=sys.stderr, flush=True)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                             lancedb_tpu_torch.connect, t0=T0)
    result["device"]["power_limit"] = card.split(",")[-1].strip() if "," in card else card
    found = isolation.forbidden_modules()
    bad_refs = isolation.reference_imports(Path(__file__).resolve().parent / "reference")
    if found or bad_refs:
        print(f"portbench: loaded {found}; reference imports {bad_refs}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
