#!/usr/bin/env python3
"""The readings that the limits of the output check are set from, on the
card at each cell's own size: the program's numbers over a dozen seeds or
more, the control's (the reference in float8 in the program's place), and
for a training cell a planted fault (the mean taken over half the batch).

    python3 h100bench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults] [--seconds 2]

One JSON line a reading: {"cell", "seed", "kind", "numbers"}. A seed runs
set-up, a short window at the cell's own load, then the check, as a run
does; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def read_cell(cell: str, seeds, control_seeds, faults: bool = False, seconds: float = 2.0,
              out=None) -> list:
    import torch

    from h100bench import run

    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    w = {c["name"]: c for c in bench["workloads"]}[cell]
    cfg = run.read_json(HERE / "configs" / f"{w['config']}.json")
    mix = run.read_json(HERE / "traffic" / f"{w['traffic']}.json")
    entry_cls = run.load_module(HERE / "entries" / f"{mix['entry']}.py").Entry
    rows = []
    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        entry = entry_cls(cfg, mix, seed, "cuda", sys.stderr)
        entry.warm()
        entry.window(seconds)
        found = []
        if seed in seeds:
            found.append(("program", entry.check()))
        else:
            entry.free_program()
        if seed in control_seeds:
            found.append(("control", entry.control()))
            if faults and hasattr(entry, "half_batch"):
                found.append(("half_batch", entry.half_batch()))
        for kind, numbers in found:
            row = {"cell": cell, "seed": seed, "kind": kind, "numbers": numbers}
            rows.append(row)
            if out:
                print(json.dumps(row), file=out, flush=True)
        del entry
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    sys.path = [str(HERE.parent)] + [q for q in sys.path if Path(q or ".").resolve() != HERE]

    def ints(text):
        return [int(x) for x in text.split(",") if x]

    read_cell(a.workload, ints(a.seeds), ints(a.control_seeds), a.faults, a.seconds, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
