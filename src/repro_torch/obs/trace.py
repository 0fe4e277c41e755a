"""Span tracer: nested, thread-aware timing with Chrome-trace export.

The write model is built for hot paths:

  * `span("compress.dispatch", blocks=8)` is a context manager; enter/exit
    take `perf_counter_ns` stamps and push/pop a THREAD-LOCAL span stack,
    so nesting depth and parentage are tracked per thread with no locking
    on the hot path;
  * finished spans append one tuple to a per-thread buffer (buffers are
    registered once, under a lock, on a thread's first span) — concurrent
    threads never contend;
  * when tracing is disabled the module-level `span()` returns a shared
    no-op context manager: the disabled cost is one flag test + one
    attribute call (budgeted by `tests/test_obs.py`'s overhead guard).

Exports:

  * `Tracer.chrome_trace()` — Chrome trace-event JSON (`ph: "X"` complete
    events, microsecond timestamps) that chrome://tracing and Perfetto
    (https://ui.perfetto.dev) load directly;
  * `Tracer.jsonl_events()` — one JSON object per finished span (name,
    thread, start_ns, dur_ns, depth, parent, args), the grep-able log.

Optional bridge: `configure(nvtx=True)` (or env ``REPRO_OBS_NVTX=1``)
wraps every span in a `torch.cuda.nvtx` range (push on enter, pop on exit),
so the same span names show up on the host track of a CUDA profiler
timeline and host spans can be lined up against the kernels they launched.
Lazy import — the tracer itself is stdlib-only and never requires torch.

See docs/observability.md for the span catalog and Perfetto how-to.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Span", "Tracer", "NOOP_SPAN"]


class _NoopSpan:
    """Shared do-nothing span (returned whenever tracing is off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One live timed section.  Use via `Tracer.span` / `repro_torch.obs.span`."""

    __slots__ = ("tracer", "name", "args", "depth", "parent",
                 "start_ns", "_nvtx")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.depth = 0
        self.parent: str | None = None
        self.start_ns = 0
        self._nvtx = None

    def set(self, **args) -> "Span":
        """Attach/overwrite args (visible in both export formats)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        stack = self.tracer._stack()
        if stack:
            top = stack[-1]
            self.depth = top.depth + 1
            self.parent = top.name
        stack.append(self)
        nvtx = self.tracer._nvtx_module()
        if nvtx is not None:
            nvtx.range_push(self.name)
            self._nvtx = nvtx
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        if self._nvtx is not None:
            self._nvtx.range_pop()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:            # tolerate misnested exits
            stack.remove(self)
        self.tracer._record(self, end_ns)
        return False


class Tracer:
    """Collects finished spans; one instance is the process-wide default.

    ``max_events`` bounds memory: past it new spans are counted in
    ``dropped`` instead of stored (the artifact records the drop count, so
    a truncated trace is never mistaken for a complete one).  The default
    holds a minute of 256 MiB compress calls with their per-block spans
    (about 8,500 spans a call).
    """

    def __init__(self, max_events: int = 2_000_000):
        self.max_events = max_events
        self.dropped = 0
        self.origin_ns = time.perf_counter_ns()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._buffers: list[tuple[int, str, list]] = []  # (tid, name, events)
        self._nvtx_on = False
        self._nvtx_mod = None
        self._n_events = 0

    # -- configuration ------------------------------------------------------

    def set_nvtx(self, on: bool) -> None:
        self._nvtx_on = bool(on)
        if not on:
            self._nvtx_mod = None

    def _nvtx_module(self):
        """`torch.cuda.nvtx` when bridging is on and CUDA is usable, else None."""
        if not self._nvtx_on:
            return None
        if self._nvtx_mod is None:
            try:
                import torch

                if not torch.cuda.is_available():
                    raise RuntimeError("no CUDA device")
                nvtx = torch.cuda.nvtx
            except Exception:           # torch/CUDA absent: bridge silently off
                self._nvtx_on = False
                return None
            self._nvtx_mod = nvtx
        return self._nvtx_mod

    # -- hot path -----------------------------------------------------------

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _events(self) -> list:
        ev = getattr(self._local, "events", None)
        if ev is None:
            ev = self._local.events = []
            t = threading.current_thread()
            with self._lock:
                self._buffers.append((t.ident or 0, t.name, ev))
        return ev

    def span(self, name: str, **args) -> Span:
        return Span(self, name, args or None)

    def _record(self, span: Span, end_ns: int) -> None:
        if self._n_events >= self.max_events:
            self.dropped += 1
            return
        self._n_events += 1  # benign race: the cap is a bound, not a ledger
        self._events().append(
            (span.name, span.start_ns, end_ns - span.start_ns,
             span.depth, span.parent, span.args)
        )

    # -- export -------------------------------------------------------------

    def finished(self) -> list[dict]:
        """All finished spans as dicts, ordered by start time."""
        with self._lock:
            bufs = [(tid, name, list(ev)) for tid, name, ev in self._buffers]
        rows = []
        for tid, tname, events in bufs:
            for name, start, dur, depth, parent, args in events:
                rows.append({
                    "name": name, "tid": tid, "thread": tname,
                    "start_ns": start - self.origin_ns, "dur_ns": dur,
                    "depth": depth, "parent": parent,
                    "args": args or {},
                })
        rows.sort(key=lambda r: r["start_ns"])
        return rows

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (load in Perfetto as-is)."""
        pid = os.getpid()
        events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro-lz4"},
        }]
        with self._lock:
            bufs = [(tid, name, list(ev)) for tid, name, ev in self._buffers]
        for tid, tname, buf in bufs:
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
            for name, start, dur, depth, parent, args in buf:
                ev = {
                    "name": name, "cat": "repro", "ph": "X", "pid": pid,
                    "tid": tid,
                    "ts": (start - self.origin_ns) / 1e3,   # microseconds
                    "dur": dur / 1e3,
                }
                if args:
                    ev["args"] = {k: _jsonable(v) for k, v in args.items()}
                events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def jsonl_events(self) -> str:
        """One JSON object per finished span, newline-delimited."""
        return "".join(
            json.dumps(
                {**r, "args": {k: _jsonable(v) for k, v in r["args"].items()}},
                sort_keys=True) + "\n"
            for r in self.finished()
        )

    def reset(self) -> None:
        """Drop recorded spans (thread-local stacks of LIVE spans survive)."""
        with self._lock:
            for _, _, ev in self._buffers:
                ev.clear()
            self._n_events = 0
            self.dropped = 0
            self.origin_ns = time.perf_counter_ns()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
