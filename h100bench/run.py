#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. The cell is found by name in ``BENCHMARK.json``;
everything about it sits in files found by name under ``h100bench/``: its
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json`` (which names the entry, ``entries/<entry>.py``),
the limits of its output check in ``limits/<cell>.json``, and each metric's
reader in ``metrics/<metric>.py``. A later cell, configuration or metric is
files added, not code edited.

A run sets up (pool, weights, the program, warm-up: ``setup_s``), measures
for ``--seconds`` with nothing traced, and with ``--trace 1`` traces a fixed
slice after the window with ``torch.profiler``. It then frees the program and
checks the window's outputs against the plain reference. The last line of
standard output is the result; the numbers compared, each beside its limit,
are the last lines of standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits 2.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the JAX package's name is a prefix of the port's: names are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_modal_early_exit_tpu")


class Run:
    """What a metric's reader gets: ``cell`` (the BENCHMARK.json entry),
    ``cfg`` and ``mix`` (the configuration and traffic files), ``setup_s``,
    ``peak_bytes`` (the window's peak of allocated device memory),
    ``window`` (the entry's record: ``docs``, ``seconds``, ``model_flops``,
    and ``latencies`` for a server), and after a traced slice ``trace`` (a
    ``tracing.Trace``), ``units`` (batches or steps in it) and
    ``attention_calls`` ((b, heads, s, d) of each attention call in it)."""

    def __init__(self, cell, cfg, mix):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.setup_s = self.peak_bytes = None
        self.window, self.trace, self.units, self.attention_calls = {}, None, 0, []


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"h100bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, name: str):
    """(end-to-end, per-layer) metric entries that ``name`` reports: those
    that list it, or list no cells; a per-layer metric without a list goes
    where the metric it moves is reported."""
    def listed(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             started: float, data_dir: Path = HERE, log=sys.stderr) -> dict:
    """One run of cell ``name``: the result line's object, with the check's
    numbers under ``checks``."""
    import torch

    from h100bench import tracing

    cell = {w["name"]: w for w in bench["workloads"]}[name]
    cfg = read_json(data_dir / "configs" / f"{cell['config']}.json")
    mix = read_json(data_dir / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(data_dir / "limits" / f"{name}.json")
    e2e, per_layer = cell_metrics(bench, name)
    entry = load_module(HERE / "entries" / f"{mix['entry']}.py").Entry(cfg, mix, seed, device, log)
    entry.warm()
    # the set-up's objects leave the collector's sight, so a collection in
    # the window scans only what the window allocates
    gc.collect()
    gc.freeze()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell, cfg, mix)
    run.setup_s = time.perf_counter() - started
    run.window = entry.window(seconds)
    run.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        run.units, run.trace = tracing.record(lambda: entry.slice(mix["trace_units"]))
        run.attention_calls = entry.attention_calls(run.units)
    numbers = entry.check()
    if set(limits) - set(numbers):
        raise ValueError(f"limits/{name}.json names numbers the check does not make: "
                         f"{sorted(set(limits) - set(numbers))}")
    # the limits file decides which numbers are compared; the rest are logged
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    log.write(f"numbers not compared: { {k: v for k, v in numbers.items() if k not in limits} }\n")
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = load_module(data_dir / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values())
              and run.window["failed"] == 0,
              "attempted": run.window["attempted"], "failed": run.window["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.top_gaps()}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")  # keep transformers, if imported, off JAX
    os.environ.setdefault("USE_TF", "0")
    # one process, one CPU thread for PyTorch's host ops, as a serving worker
    # runs: the pool of OpenMP threads only contends with the launching
    # thread for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    # import h100bench and the port from the checkout's root, not this
    # directory, whose module names are not meant to be top-level
    sys.path = [str(ROOT)] + [q for q in sys.path if Path(q or ".").resolve() != HERE]
    bench = read_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"the cell needs {chips[args.workload]} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed % 2 ** 63, args.seconds, bool(args.trace),
                      "cuda", STARTED)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
