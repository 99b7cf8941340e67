"""One run of one cell: set up, measure a closed loop, check, print one line.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names everything by name:
the configuration's file (``configs``' ``file``) and, in it, the module of
its kind (``benchmark/kinds/<kind>.py``), the traffic mix
(``benchmark/traffic/<mix>.json``) and the per-layer metrics
(``benchmark/metrics/<metric>.py``, each a ``read(run)``). A new cell of an
existing kind is new data files and entries only.

A kind's ``Cell(config, mix, seed, device)`` has:
``unit`` ('steps' or 'frames'); ``make_inputs()``, the program's set-up
from the seed; ``warm()``, every shape the window will use; ``step(i,
spans)``, one closed-loop step that returns when its result is done;
``end_to_end(n, window_s)``, the end-to-end metrics; ``counters()``;
``release()``, which drops the program's state and keeps its outputs;
``check()``, the numbers compared with the plain reference; and
``limits``, what each may read.

The run prints its set-up stages, counts and checks on standard error, and
one JSON object as the last line of standard output.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from benchmark import imports, trace

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Spans:
    """Host-clock spans of the harness's calls into the program's layers,
    kept in memory: ``with spans('render'): ...``."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name):
        return _Span(self.seconds.setdefault(name, []))


class _Span:
    def __init__(self, out):
        self.out = out

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.out.append(time.perf_counter() - self.t0)
        return False


class Run:
    """What a per-layer metric's reader reads: the window's unit count,
    length and device operations, the program's kernel names, the
    harness's spans and the cell's counters."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_config(workload: str, root: Path = ROOT) -> dict:
    """The configuration file of a cell, by the cell's name."""
    bench = load_benchmark(root)
    name = find_cell(bench, workload)["config"]
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def load_mix(root: Path, name: str) -> dict:
    path = root / "benchmark" / "traffic" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no traffic mix {path}")
    return json.loads(path.read_text())


def load_reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The cell's end-to-end (``kind`` 'end_to_end') or per-layer metrics:
    those that list it, or list no cells (a per-layer metric without a
    list belongs to every cell that reports what it moves)."""
    e2e = cell_metrics(bench, cell, "end_to_end") if kind == "per_layer" else None
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in {x["name"] for x in e2e}:
            out.append(m)
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start: float, root: Path = ROOT, device: str = "cuda",
             config_override=None, after_check=None, stages=None) -> dict:
    """Run one cell and return the result's object (the harness prints it).
    ``device='cpu'`` and ``config_override`` (sizes that a test can hold)
    serve the harness's own tests, and ``after_check(job, numbers)``
    the control's readings (``calibrate.py``); a benchmark run is on the
    card. ``stages``: set-up stages already timed (seconds by name)."""
    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    config = load_config(workload, root)
    config.update(config_override or {})
    mix = load_mix(root, cell["traffic"])
    e2e_names = [m["name"] for m in cell_metrics(bench, workload, "end_to_end")]
    layer_names = [m["name"] for m in cell_metrics(bench, workload, "per_layer")]
    readers = {name: load_reader(root, name) for name in layer_names} if traced else {}

    stages = dict(stages or {})
    t = time.perf_counter()
    import torch

    if device == "cuda":
        from vrdd_tpu_torch.kernels import _build
    kind_mod = importlib.import_module(f"benchmark.kinds.{config['kind']}")
    stages["import"] = time.perf_counter() - t
    build_s = 0.0
    if device == "cuda":
        t = time.perf_counter()
        build_s = _build.build()["seconds"]
        _build.library()
        stages["kernels"] = time.perf_counter() - t
    dev = torch.device(device)
    job = kind_mod.Cell(config, mix, seed, dev)
    for stage, fn in (("inputs", job.make_inputs), ("warm-up", job.warm)):
        t = time.perf_counter()
        fn()
        stages[stage] = time.perf_counter() - t
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    note("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
         + f"; kernel build {build_s:.3f} s (0 when the library was built); "
         f"setup_s {setup_s:.3f} s")

    spans = Spans()
    prof = trace.profiler(dev.type) if traced else None
    if prof is not None:
        prof.start()
    n = 0
    t0 = time.perf_counter()
    while True:
        job.step(n, spans)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    peak = window_peak = 0
    if cuda:
        window_peak = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, window_peak)
    counters = dict(job.counters(), window_peak_bytes=window_peak)
    note(f"window: {n} {job.unit} in {window_s:.6f} s; "
         + ", ".join(f"{k} {v}" for k, v in counters.items()))
    e2e = job.end_to_end(n, window_s)

    t = time.perf_counter()
    job.release()
    numbers = job.check()
    note(f"reference: {time.perf_counter() - t:.3f} s")
    if after_check is not None:
        after_check(job, numbers)

    metrics, device_info, breakdown = {}, {}, None
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if traced:
        ops = trace.device_ops(prof, dev.type)
        summ = trace.summary(ops, window_s)
        port = set()
        if cuda:
            port = trace.kernel_names(_build.SOURCES)
        run = Run(cell=workload, unit=job.unit, units=n, window_s=window_s,
                  ops=ops, busy_s=summ["busy_s"], port_kernels=port,
                  short=trace.short, spans=spans.seconds, counters=counters,
                  roofline=getattr(job, "roofline", lambda: None)())
        for name, read in readers.items():
            value = read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        device_info = {"busy_s": summ["busy_s"], "window_s": window_s}
        breakdown = {"device_ops": summ["device_ops"],
                     "idle_gaps": summ["idle_gaps"]}
        note(f"trace: {len(ops)} device operations, busy {summ['busy_s']:.6f} "
             f"of {window_s:.6f} s")
        if run.roofline:
            note("roofline: " + ", ".join(f"{k} {v}" for k, v in run.roofline.items()))
        if cuda:
            note(f"peaks: H100 SXM HBM 3.35 TB/s, FP32 67 TFLOP/s; card "
                 f"{power_limit()}")
    else:
        e2e["setup_s"] = setup_s
        metrics = {k: {"value": e2e[k], "unit": units[k]} for k in e2e_names
                   if k in e2e}

    checks, correct = {}, True
    for name, limit in job.limits.items():
        value = numbers.get(name, float("nan"))
        ok = math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    correct &= job.failed == 0
    result = {
        "correct": bool(correct), "attempted": n, "failed": job.failed,
        "metrics": metrics,
        "device": dict({
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak}, **device_info),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        note(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}")
    print(json.dumps(result), flush=True)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    import torch

    torch_s = time.perf_counter() - t

    bench = load_benchmark(ROOT)
    chips = find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        note(f"{args.workload} needs {chips} CUDA device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start,
                      stages={"import torch": torch_s})
    bad = imports.loaded_forbidden()
    if bad:
        note(f"the run loaded forbidden modules: {', '.join(bad)}")
        return 3
    print_result(result)
    return 0
