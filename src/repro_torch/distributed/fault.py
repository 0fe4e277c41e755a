"""Fault tolerance and straggler mitigation: host-side policy pieces.

The port of the JAX package's `distributed/fault.py`.  Failure domains at
fleet scale: host death (checkpoint / restart), slow hosts (straggler
detection -> re-mesh request) and I/O stalls.  `StepMonitor` tracks step
times; `RestartPolicy` budgets restarts; the recovery itself (restore and
reshard) is `checkpoint.checkpoint`.
"""
from __future__ import annotations

import dataclasses
import time

# RestartPolicy lives in `repro_torch.resilience.retry` beside the jittered
# RetryPolicy; re-exported here under the reference's old path.
from repro_torch.resilience.retry import RestartPolicy  # noqa: F401

__all__ = ["StepMonitor", "RestartPolicy", "SimulatedFailure"]


@dataclasses.dataclass
class StepMonitor:
    """EMA step-time tracker; flags stragglers and emits re-mesh requests."""

    ema_alpha: float = 0.1
    straggler_factor: float = 3.0
    warmup_steps: int = 5
    ema: float | None = None
    steps: int = 0
    straggler_events: int = 0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        dt = time.perf_counter() - self._t0
        self.steps += 1
        is_straggler = False
        if self.steps > self.warmup_steps and self.ema is not None:
            is_straggler = dt > self.straggler_factor * self.ema
            if is_straggler:
                self.straggler_events += 1
        if self.ema is None:
            self.ema = dt
        elif not is_straggler:  # don't poison the EMA with outliers
            self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
        return {"step_time": dt, "ema": self.ema, "straggler": is_straggler}

    def should_remesh(self, threshold: int = 3) -> bool:
        """Persistent stragglers -> ask the launcher for an elastic re-mesh."""
        return self.straggler_events >= threshold


class SimulatedFailure(RuntimeError):
    """Raised on purpose to exercise the recovery path."""
