"""One cell's traced run laid out by the program's own spans, and the cost
of keeping them.

    python3 -m portbench.span_report --workload <cell> --seed <n> --seconds <s>
        [--out <file.json>]
    python3 -m portbench.span_report --workload <cell> --seed <n> --overhead <rounds>
        --seconds <s> [--out <file.json>]

The first form makes one traced run of the cell as ``portbench.run`` does
(the same set-up, window, readers and check) and adds, from the span
records the program kept in the window: each span's milliseconds and self
milliseconds a call (or a build), the roots' self share, the outside
spans of ``trace.py`` beside their twins inside the program, the device's
busiest operations, the ``top`` longest idle gaps named by the innermost
program span ("harness" where none is open), and the idle time charged to
each innermost span. The second sets the cell up once and alternates
untraced windows of ``--seconds`` with the program's recording off and on
(``metrics.tracing()``), ``--overhead`` of each, and gives each window's
mean call or build in ms. A summary goes to standard output, the whole
report to ``--out`` as JSON."""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

from . import program_spans as ps
from . import spec


def split(t, recs: list) -> dict:
    """The traced window laid out by the program's spans."""
    units = t.calls or t.builds
    by_name: dict[str, list] = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    spans = {n: {"count": len(rs), "ms_per_unit": ps.total_s(recs, n) * 1e3 / units,
                 "self_ms_per_unit": ps.self_s(recs, n) * 1e3 / units}
             for n, rs in sorted(by_name.items(), key=lambda kv: -ps.total_s(recs, kv[0]))}
    roots = {r.name for r in recs if ps.is_root(r)}
    root_total = ps.total_s(recs, *roots)
    root_self = sum(ps.self_s(recs, n) for n in roots)
    outside = {n: sum(r.t1 - r.t0 for r in t.records if r.name == n) / 1e6 / units
               for n in sorted({r.name for r in t.records})}
    out = {"units": units, "unit": "call" if t.calls else "build", "spans": spans,
           "root_self_share": root_self / root_total if root_total else None,
           "outside_ms_per_unit": outside, "window_s": t.window_s}
    if t.events:
        under = ps.idle_by_innermost(recs, ps.idle_gaps(t))
        out.update(idle_share=1.0 - t.busy_s() / t.window_s,
                   device_ops=t.breakdown()["device_ops"],
                   idle_gaps=ps.named_gaps(t, recs, top=10),
                   idle_unnamed_pct=ps.idle_unnamed_pct(t, recs),
                   idle_by_innermost_s={n: v / 1e9 for n, v in
                                        sorted(under.items(), key=lambda kv: -kv[1])})
    return out


def traced(cell: spec.Cell, seed: int, seconds: float) -> dict:
    import lancedb_tpu_torch
    from lancedb_tpu_torch import metrics

    from . import run, trace as tr

    kept = []

    class _Kept(tr.Trace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    tr.Trace = _Kept
    try:
        result, lines = run.run_cell(cell, seed, seconds, True, "cuda", lancedb_tpu_torch.connect)
    finally:
        tr.Trace = _Kept.__mro__[1]
    t = kept[0]
    recs = [r for r in metrics.span_records() if r.t1 > t.window[0] and r.t0 < t.window[1]]
    return {"result": result, "checks": lines, "records": len(recs), **split(t, recs)}


def overhead(cell: spec.Cell, seed: int, rounds: int, seconds: float) -> dict:
    """Alternating untraced windows with recording off and on, one set-up."""
    import lancedb_tpu_torch
    from lancedb_tpu_torch import metrics

    from . import drive

    loop, cfg, traffic = cell.loop, cell.config, cell.traffic
    st = loop.set_up(cfg, traffic, seed, "cuda", lancedb_tpu_torch.connect)
    windows = []
    try:
        for i in range(2 * rounds):
            on = i % 2 == 1
            metrics.span_records(clear=True)
            t0 = time.perf_counter()
            with metrics.tracing() if on else contextlib.nullcontext():
                w = loop.window(st, cfg, traffic, seconds, seed + i, "cuda")
            units = w.calls or w.builds
            windows.append({"recording": on, "units": units,
                            "ms_per_unit": (time.perf_counter() - t0) * 1e3 / units,
                            "failed": w.failed, "spans": len(metrics.span_records(clear=True))})
    finally:
        drive.close(st)
    off, on_ = (statistics.mean(x["ms_per_unit"] for x in windows if x["recording"] == side)
                for side in (False, True))
    return {"windows": windows, "off_ms": off, "on_ms": on_, "cost_ms": on_ - off,
            "cost_pct": 100.0 * (on_ - off) / off}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--overhead", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path.cwd().resolve()
    cell = spec.resolve(spec.read_json(root / "BENCHMARK.json"), args.workload, root)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from .run import card_line

    report = {"workload": cell.name, "seed": args.seed, "card": card_line()}
    if args.overhead:
        report["overhead"] = overhead(cell, args.seed, args.overhead, args.seconds)
        summary = {k: report["overhead"][k] for k in ("off_ms", "on_ms", "cost_ms", "cost_pct")}
    else:
        report.update(traced(cell, args.seed, args.seconds))
        summary = {k: report.get(k) for k in ("root_self_share", "idle_gaps", "idle_unnamed_pct")}
        summary["metrics"] = report["result"]["metrics"]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"workload": cell.name, "card": report["card"], **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
