"""One run of one cell: set-up, the measured window, the traced calls, the
reference's judgement and the result line.

    python3 kzgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to a cell is found by name from BENCHMARK.json:
the configuration file it names, traffic/<traffic>.json (run by the call
kind calls/<call>.py that it names, callkind.py), work/<traffic>.json
(workcount.py, each operation workops/<op>.py) and one reader a metric,
metrics/<metric>.py, with `read(run) -> float or None`.

The loop is closed, with one caller: each call starts when the previous
one has returned its bytes or boolean on the host. The window counts the
calls that end inside it; the call that straddles its end is finished and
judged, but not counted. Python's cyclic garbage collector is off in the
window (a collection before it), so that no pause of the harness's
process lands in one call's wall.
"""

import gc
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from . import byname, callkind, workcount
from .reference import setup as ref_setup
from .trace import Trace, traced

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "kzg_tpu")
CACHE_DIRS = {  # the program's and PyTorch's build and kernel caches, fixed paths in the checkout
    "KZG_TPU_TORCH_CACHE_DIR": "build/kzgbench/tables",
    "TORCH_EXTENSIONS_DIR": "build/kzgbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/kzgbench/triton",
}


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    setup_s: float = 0.0  # process start to the window, less inputs_s
    inputs_s: float = 0.0  # the benchmark's own inputs: pool, cells, blobs (not the program's set-up)
    settings_load_s: float = 0.0
    window_start: float = 0.0
    ends: list = field(default_factory=list)  # host clock at each counted call's end
    walls: list = field(default_factory=list)  # each counted call's wall, seconds
    trace: Optional[Trace] = None
    work_madds: Optional[float] = None  # least multiply-adds of one call
    peak_madds_per_s: Optional[float] = None


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc: 10 ms
    resolution), or now where /proc is missing."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def read_metric(name: str, run: Run):
    return byname.load("metrics", name).read(run)


def cell_spec(workload: str):
    """(benchmark, cell, configuration, traffic) of a cell by name."""
    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {', '.join(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(cfg_entry["file"])
    traffic = load_json("kzgbench", "traffic", cell["traffic"] + ".json")
    return bench, cell, config, traffic


def wanted_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The end-to-end metrics of the cell (trace 0) or its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, api=None, device=None, t_start=None) -> dict:
    """One run; returns the result line as a dict. `api` and `device`
    replace the program's API module and the card (the tests drive a run
    with a stand-in program on the CPU)."""
    t_proc = process_start() if t_start is None else t_start
    bench, cell, config, traffic = cell_spec(workload)
    import torch

    if api is None:
        from kzg_tpu_torch import api
    t0 = time.perf_counter()
    kind = callkind.kind(traffic, ROOT)
    kind.setup(seed)
    n_prep = traffic["prepared_calls"]
    inputs = [kind.prepare(seed, i) for i in range(n_prep)]
    warm = [kind.prepare(seed, callkind.WARM_BASE + i) for i in range(traffic["warm_calls"])]
    run = Run(inputs_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    s = api.load_trusted_setup_file(os.path.join(ROOT, config["trusted_setup"]), device=device)
    for table in traffic["tables"]:
        getattr(s, table)
    _sync(torch)
    run.settings_load_s = time.perf_counter() - t0
    for w in warm:
        kind.run(api, s, w)
    _sync(torch)
    gc.collect()

    results, failed, i = {}, 0, 0
    gc.disable()
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - t_proc - run.inputs_s
    deadline = run.window_start + seconds
    while time.perf_counter() < deadline:
        inp = inputs[i % n_prep]
        c0 = time.perf_counter()
        try:
            out = kind.run(api, s, inp)
        except Exception as exc:  # a call that raises is a failed call; the run goes on and reports it
            print(f"call {i} raised {type(exc).__name__}: {exc}", file=sys.stderr)
            out, failed = None, failed + 1
        c1 = time.perf_counter()
        if out is not None:
            results[i] = out
        if c1 <= deadline and out is not None:
            run.ends.append(c1)
            run.walls.append(c1 - c0)
        i += 1
    gc.enable()
    attempted = i
    counted = len(run.walls)
    print(f"inputs: {run.inputs_s:.2f} s, left out of setup_s", flush=True)
    print(f"calls: {counted} completed inside the {seconds} s window, {attempted} started, {failed} failed", flush=True)
    print("walls_ms: " + " ".join(f"{w * 1e3:.1f}" for w in run.walls), flush=True)

    if trace:
        nxt = [inputs[(attempted + j) % n_prep] for j in range(traffic["trace_calls"])]
        run.trace = traced([lambda x=x: kind.run(api, s, x) for x in nxt])
    cuda = torch.cuda.is_available() and device is None
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0,
    }
    run.work_madds = workcount.load(ROOT, cell["traffic"])
    peak = load_json("kzgbench", "peaks.json").get(dev["kind"])
    run.peak_madds_per_s = peak["int32_madds_per_s"] if peak else None
    del s
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = judge(kind, config, seed, inputs, results, traffic)
    checks["calls_failed"] = {"value": failed, "limit": 0}
    correct = counted > 0 and all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in wanted_metrics(bench, cell, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.wall_s
    line = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    line["checks"] = checks
    return line


def judge(kind, config: dict, seed: int, inputs: list, results: dict, traffic: dict) -> dict:
    """The reference's counts over a sample of the calls, drawn from the
    seed, each beside its limit (0: every comparison is exact)."""
    rng = random.Random(seed * 1_000_003 + callkind.STREAM_CHECK)
    done = sorted(results)
    sample = sorted(rng.sample(done, min(traffic["checked_calls"], len(done))))
    t0 = time.perf_counter()
    setup = ref_setup.load(os.path.join(ROOT, config["trusted_setup"]), n_monomial=64)
    totals = {name: 0 for name in kind.checks}
    for i in sample:
        for name, value in kind.check(setup, inputs[i % len(inputs)], results[i], rng).items():
            totals[name] += value
    print(f"reference: {len(sample)} calls judged in {time.perf_counter() - t0:.1f} s", flush=True)
    return {name: {"value": v, "limit": 0} for name, v in totals.items()}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse

    t_proc = process_start()
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of kzg_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)
    _, cell, _, _ = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kzgbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 3
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_proc)
    bad = forbidden_modules()
    if bad:
        print(f"kzgbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
