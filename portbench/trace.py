"""Reading a profiled part of the window: device busy time, the device
operations that took most of it, and the idle gaps by what the host was
doing.

The profiler's trace is read in its Chrome trace-event form (the events of
``torch.profiler.profile.export_chrome_trace``).  Device work is every
event of category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; the profiled
part is the ``user_annotation`` event the harness opens around it.  The
program's spans (`repro_torch.obs`) are on the host's ``perf_counter_ns``
clock; the annotation, opened at a known reading of that clock, ties the two
clocks together.
"""
from __future__ import annotations

import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside_the_program_s_spans"
TOP = 10


def op_name(name: str) -> str:
    """A device operation's name, cut to 64 characters of [A-Za-z0-9_:.-]."""
    return re.sub(r"[^A-Za-z0-9_:.-]", "_", name)[:64]


def annotation(events: list, name: str) -> tuple[float, float]:
    """(start, end) in microseconds of the host annotation ``name``."""
    for ev in events:
        if ev.get("cat") == "user_annotation" and ev.get("name") == name:
            return float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
    raise ValueError(f"no annotation {name!r} in the trace")


def device_ops(events: list, lo: float, hi: float) -> list:
    """(start, end, name) of the device operations inside [lo, hi], sorted."""
    out = []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            s = float(ev["ts"])
            e = s + float(ev.get("dur", 0.0))
            if e > lo and s < hi:
                out.append((max(s, lo), min(e, hi), ev.get("name", "")))
    out.sort()
    return out


def busy_intervals(ops: list) -> list:
    """The union of the operations' intervals, as sorted (start, end)."""
    merged: list = []
    for s, e, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle (start, end) intervals of [lo, hi] between busy ones."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def attribute(idle: list, spans: list) -> dict:
    """Seconds of idle time by the innermost span open at each gap's middle.

    ``spans``: (start_us, end_us, name) of one thread's spans, which nest."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)]
                   + [((a + b) / 2, 2, j) for j, (a, b) in enumerate(idle)])
    stack: list = []
    out: dict = {}
    for _, kind, i in marks:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            if i in stack:
                stack.remove(i)
        else:
            a, b = idle[i]
            name = spans[stack[-1]][2] if stack else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(events: list, mark: str, spans: list) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of the part of the trace
    inside annotation ``mark``; ``spans`` as for `attribute`, already on the
    trace's clock."""
    lo, hi = annotation(events, mark)
    ops = device_ops(events, lo, hi)
    busy = busy_intervals(ops)
    by_op: dict = {}
    for s, e, name in ops:
        key = op_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
    return dict(busy_s=sum(e - s for s, e in busy) / 1e6,
                window_s=(hi - lo) / 1e6,
                device_ops=top(by_op),
                idle_gaps=top(attribute(gaps(busy, lo, hi), spans)))
