"""`repro_torch.obs` — unified telemetry: span tracing + metrics, off by default.

One import point for every instrumented site in the repo:

    from repro_torch import obs

    with obs.span("compress.dispatch", blocks=8):
        ...
    obs.counter("engine.bytes_in").inc(n)
    obs.histogram("engine.block_ratio", obs.DEFAULT_RATIO_BUCKETS).observe(r)

Gating
------
Telemetry is OFF unless the ``REPRO_OBS`` env var is truthy (anything but
``""``/``"0"``/``"false"``/``"off"``) or `obs.configure(enabled=True)` ran.
Disabled, `span()` hands back a shared no-op context manager and
`counter/gauge/histogram` hand back a shared no-op instrument — the cost
is one flag test per call site, budgeted at < 2 % of a compress microloop
by `tests/test_obs.py`.  The engines additionally accept a ``telemetry``
kwarg (True/False/None) that overrides the global flag per instance.

``REPRO_OBS_NVTX=1`` (or `configure(nvtx=True)`) additionally wraps every
span in a `torch.cuda.nvtx` range, so span names line up with the kernels
on a CUDA profiler timeline.

Artifacts
---------
`obs.dump_artifacts(dir)` writes the full bundle:

    trace.json     Chrome trace-event JSON  (load at https://ui.perfetto.dev)
    events.jsonl   one JSON object per span (grep-able log)
    metrics.json   registry snapshot (counters/gauges/histograms + p50/90/99)
    metrics.prom   Prometheus text exposition

`tools/trace_report.py <dir>` prints the per-stage breakdown table from a
bundle and `--check` schema-validates it (CI runs both).  Full API and
span catalog: docs/observability.md.
"""
from __future__ import annotations

import json
import os

from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    DEFAULT_RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
    linear_buckets,
)
from .trace import NOOP_SPAN, Span, Tracer  # noqa: F401

__all__ = [
    "configure", "is_enabled", "enabled_for",
    "span", "live_span", "span_factory",
    "counter", "gauge", "histogram", "registry", "tracer",
    "snapshot", "dump_artifacts", "reset",
    "NOOP_SPAN", "NOOP_METRIC", "Span", "Tracer", "MetricsRegistry",
    "Counter", "Gauge", "Histogram",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_RATIO_BUCKETS",
    "exponential_buckets", "linear_buckets",
]

ARTIFACT_SCHEMA_VERSION = 1


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


_ENABLED = _env_truthy("REPRO_OBS")
_TRACER = Tracer()
_REGISTRY = MetricsRegistry()
if _env_truthy("REPRO_OBS_NVTX"):
    _TRACER.set_nvtx(True)


class _NoopMetric:
    """Counter/Gauge/Histogram stand-in when telemetry is off."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


_NOOP_METRIC = NOOP_METRIC = _NoopMetric()


def configure(enabled: bool | None = None,
              nvtx: bool | None = None) -> None:
    """Runtime override of the env-var gates (tests, notebooks, scripts)."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)
    if nvtx is not None:
        _TRACER.set_nvtx(nvtx)


def is_enabled() -> bool:
    return _ENABLED


def enabled_for(override: bool | None) -> bool:
    """Resolve a per-instance ``telemetry`` kwarg against the global flag."""
    return _ENABLED if override is None else bool(override)


def tracer() -> Tracer:
    return _TRACER


def registry() -> MetricsRegistry:
    return _REGISTRY


# -- hot-path entry points --------------------------------------------------

def span(name: str, **args):
    """Timed context manager; a shared no-op when telemetry is off."""
    if not _ENABLED:
        return NOOP_SPAN
    return Span(_TRACER, name, args or None)


def live_span(name: str, **args) -> Span:
    """A recording span regardless of the global flag (engine ``telemetry=
    True`` instances use this so a single engine can be traced without
    turning the whole process on)."""
    return Span(_TRACER, name, args or None)


def span_factory(enabled: bool):
    """`live_span` or the no-op maker, picked once per engine call."""
    return live_span if enabled else _noop_span


def _noop_span(name: str, **args):
    return NOOP_SPAN


def counter(name: str, help: str = ""):
    return _REGISTRY.counter(name, help) if _ENABLED else _NOOP_METRIC


def gauge(name: str, help: str = ""):
    return _REGISTRY.gauge(name, help) if _ENABLED else _NOOP_METRIC


def histogram(name: str, buckets=DEFAULT_LATENCY_BUCKETS, help: str = ""):
    return _REGISTRY.histogram(name, buckets, help) if _ENABLED \
        else _NOOP_METRIC


# -- snapshots / artifacts --------------------------------------------------

def snapshot() -> dict:
    """Registry snapshot wrapped with the artifact schema header."""
    return {
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "enabled": _ENABLED,
        "metrics": _REGISTRY.snapshot(),
    }


def dump_artifacts(out_dir: str) -> dict:
    """Write trace.json / events.jsonl / metrics.json / metrics.prom.

    Returns ``{name: path}`` for the four files.  The directory is created;
    existing artifacts are overwritten (a dump is a point-in-time export —
    recording continues afterwards; call `reset()` to start a fresh
    window).
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    trace_path = os.path.join(out_dir, "trace.json")
    with open(trace_path, "w") as f:
        json.dump(_TRACER.chrome_trace(), f)
    paths["trace"] = trace_path
    jsonl_path = os.path.join(out_dir, "events.jsonl")
    with open(jsonl_path, "w") as f:
        f.write(_TRACER.jsonl_events())
    paths["events"] = jsonl_path
    metrics_path = os.path.join(out_dir, "metrics.json")
    with open(metrics_path, "w") as f:
        json.dump(snapshot(), f, indent=1)
    paths["metrics"] = metrics_path
    prom_path = os.path.join(out_dir, "metrics.prom")
    with open(prom_path, "w") as f:
        f.write(_REGISTRY.to_prometheus())
    paths["prometheus"] = prom_path
    return paths


def reset() -> None:
    """Clear recorded spans and all metrics (tests; fresh windows)."""
    _TRACER.reset()
    _REGISTRY.reset()
