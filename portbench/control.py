"""The controls, which have to come out not correct; their readings set
the upper end of each limit.

    python3 -m portbench.control --workload <cell> --seeds a,b,c [--fault F]

prints a JSON line a seed: the cell's loop's control (the plain reference
in the port's place, one precision step below the configuration's, or a
planted fault) at the cell's own size, judged by the run's comparison.

    python3 -m portbench.control --workload <cell> --seeds a,b,c \\
        --port-search nprobes=10 --port-search refine_factor=1 --seconds 5

runs the port itself on each seed: one set-up, then a window of
``--seconds`` as the configuration states it (the lower readings) and one
with each ``--port-search`` change to its ``search`` group (a guarantee
broken: fewer probes, no refine), each judged against the configuration's
own limits."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import drive, spec
from .reference import judge


def _line(cell: spec.Cell, seed: int, control, checks: list[dict], **extra) -> str:
    numbers = judge.worst(checks)
    correct = bool(checks) and all(c["ok"] for c in numbers.values())
    return json.dumps({"workload": cell.name, "seed": seed, "control": control,
                       "correct": correct, "checks": numbers, **extra})


def port_variants(cell: spec.Cell, seed: int, seconds: float, changes: list[dict],
                  device, connect) -> list[str]:
    """The port on one seed, as configured and with each change to its
    ``search`` group, on one set-up; a JSON line each."""
    cfg, traffic, loop = cell.config, cell.traffic, cell.loop
    st = loop.set_up(cfg, traffic, seed, device, connect)
    runs = []
    for change in [{}] + changes:
        run_cfg = dict(cfg, search=dict(cfg["search"], **change))
        w = loop.window(st, run_cfg, traffic, seconds, seed, device)
        runs.append((change, w, loop.answers(st, w, run_cfg, traffic)))
    drive.close(st)
    del st
    torch.cuda.empty_cache()
    out = []
    for change, w, found in runs:
        checks = loop.judge(found, cfg, traffic, seed, device)
        checks.append({"failed": judge.check(w.failed, 0, "<=")})
        out.append(_line(cell, seed, change or False, checks, calls=w.attempted))
    return out


def _change(text: str) -> dict:
    key, _, value = text.partition("=")
    return {key: int(value)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the controls' readings, a JSON line a seed")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--port-search", action="append", default=[],
                    help="key=value: a change to the search group, run through the port")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    root = Path.cwd().resolve()
    cell = spec.resolve(spec.read_json(root / "BENCHMARK.json"), args.workload, root)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.port_search:
        sys.path.insert(0, str(root))
        import lancedb_tpu_torch

        changes = [_change(c) for c in args.port_search]
        for seed in seeds:
            for line in port_variants(cell, seed, args.seconds, changes, "cuda",
                                      lancedb_tpu_torch.connect):
                print(line, flush=True)
        return 0
    for seed in seeds:
        checks = cell.loop.control(cell.config, cell.traffic, seed, "cuda", args.fault)
        print(_line(cell, seed, args.fault or True, checks), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
