"""Metrics registry: counters, gauges, fixed-bucket histograms.

Dependency-free (stdlib only) so the telemetry layer can ship with the
core library and never gates on an optional package.  Three instrument
types, one process-wide registry (plus private registries for tests):

  * `Counter`   — monotone accumulator (`inc`), e.g. bytes compressed;
  * `Gauge`     — last-value instrument (`set`/`inc`), e.g. in-flight
                  micro-batches in the engine's double buffer;
  * `Histogram` — fixed upper-bound buckets with a running sum/count and
                  interpolated quantile estimates (`quantile(0.99)`), e.g.
                  per-block compression ratio or dispatch latency.

Exporters:

  * `MetricsRegistry.snapshot()`      — plain-dict JSON form (the machine
                                        interface `tools/trace_report.py`
                                        consumes);
  * `MetricsRegistry.to_prometheus()` — Prometheus text exposition format
                                        (metric names sanitized `a.b` ->
                                        `a_b`; histograms emit the
                                        cumulative `_bucket`/`_sum`/`_count`
                                        series).

All instruments are thread-safe: one lock per instrument (registration
itself takes the registry lock).  Quantiles are estimates — linear
interpolation inside the covering bucket — with worst-case error of one
bucket width; pick buckets accordingly (`exponential_buckets` /
`linear_buckets`).  See docs/observability.md.
"""
from __future__ import annotations

import bisect
import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "exponential_buckets",
    "linear_buckets",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_RATIO_BUCKETS",
]


def exponential_buckets(start: float, factor: float, count: int) -> tuple:
    """`count` upper bounds: start, start*factor, ... (Prometheus idiom)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


def linear_buckets(start: float, width: float, count: int) -> tuple:
    if width <= 0 or count < 1:
        raise ValueError("need width > 0, count >= 1")
    return tuple(start + width * i for i in range(count))


# Seconds-scale latency: 1 us .. ~67 s, factor 2 (worst-case quantile
# error = one octave; plenty for per-stage breakdowns).
DEFAULT_LATENCY_BUCKETS = exponential_buckets(1e-6, 2.0, 26)
# Compression ratio (usize/csize): 0.25 .. 16, factor 2^(1/2).
DEFAULT_RATIO_BUCKETS = exponential_buckets(0.25, math.sqrt(2.0), 12)


class Counter:
    """Monotone counter.  `inc(n)` with n >= 0."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        return self._value


class Gauge:
    """Last-value instrument (`set`), with `inc`/`dec` for occupancy."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def set(self, v: int | float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: int | float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> int | float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated quantile estimates.

    ``buckets`` are sorted upper bounds; an implicit +Inf bucket catches
    the overflow.  `quantile(q)` walks the cumulative counts to the
    covering bucket and interpolates linearly between its bounds (the
    overflow bucket reports the largest finite bound — quantiles cannot
    resolve past the configured range).
    """

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS,
                 help: str = ""):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("buckets must be non-empty and increasing")
        self.name = name
        self.help = help
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)  # +Inf overflow at the end
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); nan when empty."""
        if not 0 <= q <= 1:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self._count
            if total == 0:
                return math.nan
            rank = q * total
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank and c:
                    if i >= len(self.buckets):      # overflow bucket
                        return self._max if math.isfinite(self._max) \
                            else self.buckets[-1]
                    hi = self.buckets[i]
                    lo = self.buckets[i - 1] if i else min(self._min, hi)
                    lo = max(lo, 0.0) if self._min >= 0 else lo
                    frac = (rank - (cum - c)) / c
                    return lo + (hi - lo) * frac
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            mn = self._min if self._count else None
            mx = self._max if self._count else None
        snap = {
            "count": total,
            "sum": s,
            "min": mn,
            "max": mx,
            "buckets": [[b, c] for b, c in zip(self.buckets, counts)]
            + [["+Inf", counts[-1]]],
        }
        for q in (0.5, 0.9, 0.99):
            v = self.quantile(q)
            snap[f"p{int(q * 100)}"] = None if math.isnan(v) else v
        return snap


def _prom_name(name: str) -> str:
    """Sanitize a dotted metric name into a Prometheus identifier."""
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors and exporters."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, buckets=DEFAULT_LATENCY_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram, buckets, help)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready snapshot (the `metrics.json` artifact payload)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.value}")
            else:
                lines.append(f"# TYPE {pn} histogram")
                snap = m.snapshot()
                cum = 0
                for le, c in snap["buckets"]:
                    cum += c
                    le_s = "+Inf" if le == "+Inf" else repr(float(le))
                    lines.append(f'{pn}_bucket{{le="{le_s}"}} {cum}')
                lines.append(f"{pn}_sum {snap['sum']}")
                lines.append(f"{pn}_count {snap['count']}")
        return "\n".join(lines) + "\n"
