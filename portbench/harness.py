"""The port's benchmark: one cell, one run.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own and is found by name:

- ``BENCHMARK.json`` (the checkout's root): the cells and which metrics
  each one reports;
- ``configs/<config>.json``: a deployment's sizes and guarantees;
- ``workloads/<cell>.json``: the cell's generator, its parameters and the
  limits of its correctness check;
- ``traffic/<generator>.py``: the code that makes a cell's inputs from the
  seed, drives the program and judges its answers against ``reference/``;
- ``metrics/<metric>.py``: ``read(ctx)`` returns one metric or None;
- ``rooflines/<kernel>.py``: the work of one kernel and the peaks it is
  set against.

``run_cell`` does a run on any device; ``run.py`` adds the command line,
the look for cards and the check that JAX never loaded.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import time
import traceback

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "matchinglib_poselib_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str | None = None):
    """Import a file by path (metric file names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {path.relative_to(ROOT)}")
    name = name or "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, cell) and m["moves"] in names]
    return e2e, layer


@dataclasses.dataclass
class Cell:
    """A cell as the files describe it."""

    name: str
    entry: dict      # its line in BENCHMARK.json
    spec: dict       # workloads/<cell>.json
    config: dict     # configs/<config>.json
    generator: object  # traffic/<generator>.py


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"portbench: no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"portbench: workloads/{name}.json has {key} "
                             f"{spec[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    gen = load_module(HERE / "traffic" / f"{spec['generator']}.py")
    return Cell(name, entry, spec, config, gen)


@dataclasses.dataclass
class Window:
    """What the measured window did (host clock)."""

    seconds: float = 0.0
    requests: int = 0
    units: int = 0
    failed_units: int = 0
    spans_ms: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: Cell
    driver: object        # the generator's driver of this run
    setup_s: float
    window: Window
    trace: dict | None    # tracing.summary of the traced requests

    def roofline(self, kernel: str):
        return load_module(HERE / "rooflines" / f"{kernel}.py")


def read_metric(name: str, ctx: Context):
    value = load_module(HERE / "metrics" / f"{name}.py").read(ctx)
    if value is None:
        return None
    value = float(value)
    return value if math.isfinite(value) else None


def measure(driver, seconds: float, first: int = 0) -> Window:
    """Closed loop, one client: requests back to back, from request number
    `first` on, until `seconds` have passed; the request in flight then
    finishes, and the window ends with it, so every request and all of its
    time are counted."""
    w = Window()
    spans0 = driver.spans_ms()
    counters0 = driver.counters()
    start = time.perf_counter()
    while True:
        try:
            units = driver.request(first + w.requests)
        except Exception:  # a failed request is counted, not fatal
            traceback.print_exc(file=sys.stderr)
            units = -driver.units_per_request
        t1 = time.perf_counter()
        w.requests += 1
        if units < 0:
            w.failed_units += -units
        else:
            w.units += units
        if t1 - start >= seconds:
            break
    w.seconds = t1 - start
    w.spans_ms = {k: v - spans0.get(k, 0.0)
                  for k, v in driver.spans_ms().items()}
    w.counters = {k: v - counters0.get(k, 0)
                  for k, v in driver.counters().items()}
    return w


def memory_peak_bytes(device) -> int:
    import torch

    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def device_record(device, chips: int) -> dict:
    import torch

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": memory_peak_bytes(device)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, t_start: float | None = None,
             bench: dict | None = None) -> dict:
    """One run of a cell on `device`: set-up, the window, the traced
    requests, then the check against the reference. Returns the result
    line's object (``checks`` last). `overrides` {"config": {...},
    "params": {...}} replace keys of the configuration or the workload's
    parameters (tests run a small copy on the CPU)."""
    import torch

    from portbench import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    cell = find_cell(name, bench)
    e2e, layer = cell_metrics(bench, name)
    overrides = overrides or {}
    params = {**cell.spec["params"], **overrides.get("params", {})}
    config = {**cell.config, **overrides.get("config", {})}
    t_driver = time.perf_counter()
    driver = cell.generator.Driver(config, params, seed, device, seconds)
    driver.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    split = {"start": t_driver - t_start, **driver.setup_split}
    print("setup_s " + " ".join(f"{k} {v:.4f}" for k, v in split.items()),
          file=sys.stderr, flush=True)
    # the warm-up's requests are its own; the window's come after them,
    # and the traced ones after the window's
    first = params["warm_requests"]
    window = measure(driver, seconds, first=first)

    summary = None
    if trace:
        summary = tracing.trace_requests(driver, params["traced_requests"],
                                         device, first + window.requests)
    ctx = Context(cell, driver, setup_s, window, summary)
    dev = device_record(device, cell.entry["chips"])
    metrics = {}
    for m in (layer if trace else e2e):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]

    driver.free_program()
    checks = driver.check(cell.spec["limits"])
    driver.close()
    correct = window.failed_units == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct),
           "attempted": window.units + window.failed_units,
           "failed": window.failed_units,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    return out


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the benchmark must never
    load, compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))
