"""Jittered-backoff retries for transient I/O failures (a copy of the JAX
package's `resilience/retry.py`; the same seed gives the same sleeps).

Generalizes `RestartPolicy` (kept here, unchanged in behaviour): where
`RestartPolicy` only *budgets* failures and hands back a sleep time,
`RetryPolicy` + `call` actually drive the retry loop — decorrelated-jitter
backoff (Brooker, "Exponential Backoff And Jitter": each sleep is drawn
uniformly from ``[base, prev * multiplier]`` instead of marching a
deterministic doubling ladder that synchronizes a fleet's retry storms),
a hard attempt budget, and an optional wall-clock deadline cap so a
retried operation can never outlive its caller's patience.

Used by checkpoint save/restore I/O and the offload/restore read paths;
the fault-injection harness (`repro_torch.resilience.inject`) raises
transient `OSError`s through these wrappers to prove the loop recovers.
Every retry is counted through `repro_torch.obs` (``resilience.retries``) when
telemetry is on.

Determinism: pass ``seed`` to pin the jitter sequence (tests and the
seeded chaos matrix do), and ``sleep=`` to capture sleeps instead of
paying them.
"""
from __future__ import annotations

import dataclasses
import random
import time

from repro_torch import obs

__all__ = ["RetryPolicy", "RestartPolicy", "call", "retrying"]


@dataclasses.dataclass
class RetryPolicy:
    """Retry budget + decorrelated-jitter backoff schedule.

    ``max_attempts`` counts the FIRST try: ``max_attempts=4`` means one
    attempt plus up to three retries.  ``deadline_s`` caps the total time
    from the first attempt — a retry is abandoned (and the last error
    re-raised) when the budget is spent or the next sleep would cross the
    deadline.  ``retry_on`` is the exception allowlist; anything else
    propagates immediately (corruption errors are NOT transient — never
    put `FrameError` here).
    """

    max_attempts: int = 4
    base_s: float = 0.02
    cap_s: float = 1.0
    multiplier: float = 3.0
    deadline_s: float | None = None
    retry_on: tuple[type[BaseException], ...] = (OSError,)
    seed: int | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_s < 0 or self.cap_s < self.base_s:
            raise ValueError("need 0 <= base_s <= cap_s")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1.0")

    def backoffs(self):
        """Yield the sleep schedule: decorrelated jitter, capped at
        ``cap_s`` (yields ``max_attempts - 1`` sleeps)."""
        rng = random.Random(self.seed)
        prev = self.base_s
        for _ in range(self.max_attempts - 1):
            prev = min(self.cap_s,
                       rng.uniform(self.base_s, max(self.base_s,
                                                    prev * self.multiplier)))
            yield prev


def call(fn, *args, policy: RetryPolicy | None = None, sleep=time.sleep,
         on_retry=None, clock=time.monotonic, **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying transient failures per policy.

    ``on_retry(attempt, exc, delay)`` (optional) observes each retry —
    the chaos benchmark logs through it.  Raises the LAST transient error
    once the attempt budget or deadline is spent; non-``retry_on``
    exceptions propagate immediately, un-retried.
    """
    pol = policy or RetryPolicy()
    start = clock()
    backoffs = pol.backoffs()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except pol.retry_on as e:
            delay = next(backoffs, None)
            if delay is None:
                raise
            if pol.deadline_s is not None \
                    and clock() - start + delay > pol.deadline_s:
                raise
            if obs.is_enabled():
                obs.counter("resilience.retries",
                            "transient-failure retries").inc()
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


def retrying(policy: RetryPolicy | None = None, sleep=time.sleep):
    """Decorator form of `call` (same semantics, fixed policy)."""
    def deco(fn):
        def wrapped(*args, **kwargs):
            return call(fn, *args, policy=policy, sleep=sleep, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "retrying")
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco


@dataclasses.dataclass
class RestartPolicy:
    """Bounded-retry policy with exponential backoff.

    Deliberately minimal — it budgets failures and hands back a sleep; the
    caller owns the loop.  New code should
    prefer `RetryPolicy` + `call`, which add jitter and a deadline.
    """

    max_failures: int = 5
    backoff_s: float = 1.0
    failures: int = 0

    def record_failure(self) -> float:
        """Returns backoff seconds to sleep; raises if the budget is spent."""
        self.failures += 1
        if self.failures > self.max_failures:
            raise RuntimeError(f"giving up after {self.failures - 1} failures")
        return self.backoff_s * (2 ** (self.failures - 1))
