"""The benchmark's harness: finds a cell's files by name, sets the run up,
measures the window, reads the metrics and judges the outputs.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json            the configuration (path in BENCHMARK.json)
    traffic/<traffic>.json           the traffic's parameters, naming its driver
    drivers/<driver>.py              the call loop's body and its comparison
    metrics/end_to_end/<metric>.py   read(window) -> number
    metrics/per_layer/<metric>.py    read(ctx) -> number or None; a metric
                                     split by the rate it moves, such as
                                     idle_share.compress, may share the
                                     reader of its first part, idle_share.py

A run: set-up (imports and CUDA, the object from the seed, the driver's own
set-up, one warm-up call), then the window: calls back to back until the
first call that ends at or after ``seconds``.  Rates are over the window's
whole length.  Outputs of a sample of the calls, drawn from the seed, and of
the last call are kept and judged once the window has closed and the device
peak has been read.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
CACHE = CHECKOUT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KEEP = 3                     # judged outputs drawn from the window, besides the last
PROFILED_CALLS = (1, 2)      # window calls the traced run's profiler covers
MARK = "portbench.profiled"


def cache_env() -> dict:
    """The program's build and kernel caches: fixed directories inside the
    checkout, so only a checkout's first run builds."""
    return {"REPRO_TORCH_BUILD_DIR": str(CACHE / "kernels"),
            "TRITON_CACHE_DIR": str(CACHE / "triton"),
            "TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions")}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file, under a name made from its path."""
    name = re.sub(r"\W", "_", f"portbench_{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object                 # the module drivers/<driver>.py
    end_to_end: list               # [(entry, module)]
    per_layer: list                # [(entry, module)]


def metric_path(root: Path, kind: str, name: str) -> Path:
    """The reader of metric ``name``: ``<name>.py``, else the reader of the
    part of the name before its first dot."""
    path = root / "metrics" / kind / f"{name}.py"
    if path.is_file() or "." not in name:
        return path
    return root / "metrics" / kind / f"{name.split('.')[0]}.py"


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` with its files loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root.parent / configs[w["config"]]["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    driver = load_module(root / "drivers" / f"{traffic['driver']}.py")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        driver=driver,
        end_to_end=[(m, load_module(metric_path(root, "end_to_end", m["name"])))
                    for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[(m, load_module(metric_path(root, "per_layer", m["name"])))
                   for m in bench["per_layer"] if _applies(m, workload)])


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    calls: list          # [(start, end, bytes_in, bytes_out)] of calls that returned
    failed: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self, setup_s: float) -> dict:
        return dict(seconds=self.seconds, calls=len(self.calls) + self.failed,
                    bytes_in=sum(c[2] for c in self.calls),
                    bytes_out=sum(c[3] for c in self.calls), setup_s=setup_s)


def run_window(call: Callable, seconds: float, clock: Callable = time.perf_counter,
               keep: Callable | None = None, around: Callable | None = None,
               min_calls: int = 1, log=sys.stderr) -> Window:
    """Calls back to back from the window's opening until the first call
    that ends at or after ``seconds`` (and at least ``min_calls`` calls).

    ``call()`` returns (bytes_in, bytes_out, output); ``keep(i, output)``
    sees each output; ``around(i, phase)`` runs before ("enter") and after
    ("exit") call i, for the traced run's profiler.  A call that raises is
    counted as failed and logged once.
    """
    calls, failed = [], 0
    t0 = clock()
    i = 0
    while True:
        if around is not None:
            around(i, "enter")
        start = clock()
        try:
            nin, nout, out = call()
        except Exception:   # noqa: BLE001 - a failed call is counted, not fatal
            end = clock()
            if not failed:
                traceback.print_exc(file=log)
            failed += 1
        else:
            end = clock()
            calls.append((start, end, nin, nout))
            if keep is not None:
                keep(i, out)
            out = None
        if around is not None:
            around(i, "exit")
        i += 1
        if end - t0 >= seconds and i >= min_calls:
            return Window(t0, end, calls, failed)


class Reservoir:
    """A sample of ``k`` outputs drawn from the seed, uniform over the calls
    (reservoir sampling), plus the last call's output."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.kept: dict = {}
        self.last = None

    def __call__(self, i: int, out) -> None:
        # The previous last output joins the draw once a later one exists.
        if self.last is not None:
            j, prev = self.last
            if len(self.kept) < self.k:
                self.kept[j] = prev
            else:
                slot = int(self.rng.integers(0, j + 1))
                if slot < self.k:
                    del self.kept[sorted(self.kept)[slot]]
                    self.kept[j] = prev
        self.last = (i, out)

    def outputs(self) -> list:
        items = dict(self.kept)
        if self.last is not None:
            items[self.last[0]] = self.last[1]
        return [items[i] for i in sorted(items)]


def _peaks(kind: str) -> dict | None:
    for entry in load_json(ROOT / "peaks.json")["devices"]:
        if entry["match"] in kind:
            return entry
    return None


class Profiled:
    """The traced run's profiler over calls PROFILED_CALLS of the window."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.prof = self.mark = None
        self.mark_ns = 0
        self.calls: list = []

    def __call__(self, i: int, phase: str) -> None:
        if i not in PROFILED_CALLS:
            return
        torch = self.torch
        if phase == "enter" and i == PROFILED_CALLS[0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.mark = torch.profiler.record_function(MARK)
            self.mark_ns = time.perf_counter_ns()
            self.mark.__enter__()
        if phase == "exit":
            self.calls.append(i)
            if i == PROFILED_CALLS[-1]:
                if self.cuda:
                    torch.cuda.synchronize()
                self.mark.__exit__(None, None, None)
                self.prof.__exit__(None, None, None)

    def events(self) -> list:
        path = CACHE / "trace" / "profile.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        with open(path) as f:
            data = json.load(f)
        return data["traceEvents"] if isinstance(data, dict) else data


def _span_view(spans: list, calls: list, skip: set) -> tuple[dict, int, int]:
    """Seconds and counts of each span name over the calls not in ``skip``,
    with those calls' bytes in and out.  ``calls``: (index, start_ns,
    end_ns, bytes_in, bytes_out) on the tracer's clock."""
    totals: dict = {}
    nin = nout = 0
    kept = [c for c in calls if c[0] not in skip]
    for _, s, e, a, b in kept:
        nin += a
        nout += b
    bounds = [(s, e) for _, s, e, _, _ in kept]
    for r in spans:
        t = r["start_ns"]
        if any(s <= t <= e for s, e in bounds):
            d = totals.setdefault(r["name"], {"seconds": 0.0, "count": 0})
            d["seconds"] += r["dur_ns"] / 1e9
            d["count"] += 1
    return totals, nin, nout


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float | None = None, object_bytes: int | None = None,
             control: bool = False, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    from portbench import objects

    t_start = time.perf_counter() if t_start is None else t_start
    parts: dict = {}
    mark = t_start

    def part(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    import torch

    part("import_torch")
    # Torch's host threads as the configuration states them (host_threads),
    # else torch's default.
    if cell.config.get("host_threads"):
        torch.set_num_threads(int(cell.config["host_threads"]))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    part("device_init")
    from repro_torch import obs

    part("import_program")
    obj = objects.build(seed, cell.traffic, CACHE / "cache", object_bytes)
    part("object")
    driver = cell.driver.Driver(cell.config, cell.traffic, obj, device,
                                telemetry=trace, control=control, seed=seed)
    part("driver_setup")
    driver.call()
    if cuda:
        torch.cuda.synchronize()
    part("warmup_call")
    # What set-up made stays for the run: the collector need not walk it.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"setup_parts": parts, "setup_s": setup_s}), file=log)

    reservoir = Reservoir(KEEP, objects.rng_of(seed, 1))
    profiled = Profiled(torch, cuda) if trace else None
    ns_calls: list = []
    if trace:
        obs.reset()
    origin = obs.tracer().origin_ns

    def timed_call():
        s = time.perf_counter_ns()
        result = driver.call()
        ns_calls.append((len(ns_calls), s - origin,
                         time.perf_counter_ns() - origin, result[0], result[1]))
        return result

    window = run_window(timed_call, seconds, keep=reservoir, around=profiled,
                        min_calls=PROFILED_CALLS[-1] + 1 if trace else 1, log=log)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    summary = window.summary(setup_s)
    counters = driver.counters()
    print(json.dumps({"window": summary, "counters": counters,
                      "call_seconds": [round(c[1] - c[0], 6) for c in window.calls]}),
          file=log)

    metrics: dict = {}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        for entry, module in cell.end_to_end:
            metrics[entry["name"]] = {"value": module.read(summary),
                                      "unit": entry["unit"]}
    else:
        from portbench import trace as tr

        spans = obs.tracer().finished()
        main = [r for r in spans if r["tid"] == threading.get_ident()]
        span_totals, nin, nout = _span_view(main, ns_calls, set(profiled.calls))
        profile = None
        if profiled.calls:
            events = profiled.events()
            lo, _ = tr.annotation(events, MARK)
            offset = lo - (profiled.mark_ns - origin) / 1e3
            span_us = [(r["start_ns"] / 1e3 + offset,
                        (r["start_ns"] + r["dur_ns"]) / 1e3 + offset, r["name"])
                       for r in main]
            profile = tr.summarize(events, MARK, span_us)
            picked = [c for c in ns_calls if c[0] in profiled.calls]
            profile["bytes_in"] = sum(c[3] for c in picked)
            profile["bytes_out"] = sum(c[4] for c in picked)
            dev["busy_s"] = profile["busy_s"]
            dev["window_s"] = profile["window_s"]
            breakdown = {"device_ops": profile["device_ops"],
                         "idle_gaps": profile["idle_gaps"]}
        ctx = dict(spans=span_totals, span_bytes_in=nin, span_bytes_out=nout,
                   profile=profile, peaks=_peaks(kind), counters=counters)
        for entry, module in cell.per_layer:
            value = module.read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    outputs = reservoir.outputs()
    reservoir = None
    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check(outputs, seed)
    outputs = None
    limits = cell.driver.LIMITS
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = window.failed == 0 and bool(window.calls) and all(
        numbers[k] <= limits[k] for k in limits)
    print(json.dumps({"judged_outputs": min(len(window.calls), KEEP + 1),
                      "check_seconds": time.perf_counter() - t_check}), file=log)
    result = {"correct": correct, "attempted": summary["calls"],
              "failed": window.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts"] = parts
    result["compared"] = compared
    return result


def print_compared(result: dict, log=sys.stderr) -> None:
    """Each number compared beside its limit, as the last lines of stderr."""
    for name, d in result["compared"].items():
        print(f"compared {name} {d['value']} limit {d['limit']}", file=log)
