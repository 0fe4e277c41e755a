"""Seeded fault injection: deterministic corruption + I/O failure harness.

A copy of the JAX package's `resilience/inject.py` in pure Python: the same
seed flips the same bits, cuts at the same point and arms the same faults
in both packages, so a corrupted frame can be fed to either.

The resilience acceptance criteria are negative-space properties ("no
single-block corruption is ever silent", "a torn checkpoint write can never
be mistaken for a valid step") — they can only be tested by *injecting* the
failures.  This module is the single source of injected faults so every
test and `chip_smoke.py` phase draws from the same deterministic
generators:

Pure, seeded corruption helpers (no global state):

    flip_bits(data, seed, n)          n deterministic bit flips
    truncate(data, seed)              cut at a seeded point
    corrupt_frame_block(frame, i, s)  flip bits inside block i's payload only
    frame_payload_region(frame, i)    the [start, end) the above targets

Process-global failure injection (armed via `install`):

    with install(FaultInjector(seed=7, crash_at="checkpoint.rename")):
        checkpoint.save(...)          # dies mid-save, like SIGKILL

  * `crash_point(name)` — instrumented code calls this at named crash
    seams (checkpoint.save does); the armed injector detonates at its
    configured point by raising `InjectedCrash`.  Unarmed cost: one
    global None-check.
  * `io_point(name)` — instrumented I/O calls this; the injector can
    raise a transient `OSError` the first ``fail[name]`` times (proving
    the `resilience.retry` wrappers recover) or sleep ``slow[name]``
    seconds (I/O stall simulation).

Pytest: the port's tests arm this module through their own ``chaos``
fixture (`tests/test_torch_util.py`; `chaos(seed=..., crash_at=...)` arms
an injector for the test and disarms on teardown).
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time

__all__ = ["InjectedCrash", "FaultInjector", "install", "active",
           "crash_point", "io_point", "flip_bits", "truncate",
           "corrupt_frame_block", "frame_payload_region"]


class InjectedCrash(RuntimeError):
    """A simulated process kill at a named crash point.

    RuntimeError (not BaseException) so test harnesses handle it normally,
    but raised from a point where the instrumented code performs no
    cleanup — the on-disk state it leaves behind is exactly what a SIGKILL
    at that seam would leave.
    """


@dataclasses.dataclass
class FaultInjector:
    """One armed set of deterministic faults (see module docstring).

    ``fail``: op name -> how many times `io_point(op)` raises a transient
    OSError before letting calls through (the retry loop's test surface).
    ``slow``: op name -> seconds each `io_point(op)` sleeps.
    ``crash_at``: crash-point name where `crash_point` raises
    `InjectedCrash` (once; the injector disarms its crash after firing so
    post-mortem recovery code can run under the same installation).
    """

    seed: int = 0
    crash_at: str | None = None
    fail: dict[str, int] = dataclasses.field(default_factory=dict)
    slow: dict[str, float] = dataclasses.field(default_factory=dict)
    # Observability for assertions: what actually fired.
    crashes: list[str] = dataclasses.field(default_factory=list)
    io_faults: list[str] = dataclasses.field(default_factory=list)
    slept_s: float = 0.0

    def __post_init__(self):
        self.rng = random.Random(self.seed)
        self._lock = threading.Lock()

    # -- corruption (instance-seeded wrappers over the pure helpers) -------

    def flip_bits(self, data: bytes, n: int = 1, start: int = 0,
                  end: int | None = None) -> bytes:
        return flip_bits(data, self.rng.randrange(2**31), n, start, end)

    def truncate(self, data: bytes) -> bytes:
        return truncate(data, self.rng.randrange(2**31))

    def corrupt_frame_block(self, frame: bytes, index: int,
                            n: int = 1) -> bytes:
        return corrupt_frame_block(frame, index, self.rng.randrange(2**31), n)

    # -- failure points -----------------------------------------------------

    def _crash(self, name: str) -> None:
        if self.crash_at == name:
            with self._lock:
                if self.crash_at != name:   # lost the race; already fired
                    return
                self.crash_at = None
                self.crashes.append(name)
            raise InjectedCrash(f"injected crash at {name!r}")

    def _io(self, name: str) -> None:
        delay = self.slow.get(name, 0.0)
        if delay:
            time.sleep(delay)
            self.slept_s += delay
        with self._lock:
            left = self.fail.get(name, 0)
            if left <= 0:
                return
            self.fail[name] = left - 1
            self.io_faults.append(name)
        raise OSError(f"injected transient I/O error at {name!r}")


_ACTIVE: FaultInjector | None = None
_INSTALL_LOCK = threading.Lock()


def active() -> FaultInjector | None:
    return _ACTIVE


@contextlib.contextmanager
def install(injector: FaultInjector):
    """Arm ``injector`` process-wide for the with-block (tests/benchmarks
    only; nested installs are a usage error)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultInjector is already installed")
        _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = None


def crash_point(name: str) -> None:
    """Named crash seam — a no-op unless an armed injector targets it."""
    inj = _ACTIVE
    if inj is not None:
        inj._crash(name)


def io_point(name: str) -> None:
    """Named I/O fault seam — a no-op unless an armed injector configures
    a transient failure or stall for it."""
    inj = _ACTIVE
    if inj is not None:
        inj._io(name)


# -- pure seeded corruption helpers -----------------------------------------

def flip_bits(data: bytes, seed: int, n: int = 1, start: int = 0,
              end: int | None = None) -> bytes:
    """Flip ``n`` deterministic bits of ``data[start:end]`` (distinct
    positions; same (data-length, seed, n, region) -> same output)."""
    end = len(data) if end is None else end
    if not 0 <= start < end <= len(data):
        raise ValueError(f"bad flip region [{start}, {end}) for {len(data)}")
    rng = random.Random(seed)
    out = bytearray(data)
    span = end - start
    n = min(n, span * 8)
    for pos in rng.sample(range(span * 8), n):
        out[start + pos // 8] ^= 1 << (pos % 8)
    return bytes(out)


def truncate(data: bytes, seed: int, min_keep: int = 1) -> bytes:
    """Cut ``data`` at a seeded point in [min_keep, len-1] — always drops
    at least one byte."""
    if len(data) <= min_keep:
        raise ValueError("nothing to truncate")
    rng = random.Random(seed)
    return data[: rng.randint(min_keep, len(data) - 1)]


def frame_payload_region(frame: bytes, index: int) -> tuple[int, int]:
    """[start, end) byte range of block ``index``'s stored payload inside
    ``frame`` — the region `corrupt_frame_block` flips (table/header stay
    intact, so damage is attributable to exactly that block)."""
    from repro_torch.core.frame import frame_info  # lazy: avoid import cycles

    b = frame_info(frame)["blocks"][index]
    if b["csize"] == 0:
        raise ValueError(f"block {index} has an empty payload")
    return b["offset"], b["offset"] + b["csize"]


def corrupt_frame_block(frame: bytes, index: int, seed: int,
                        n: int = 1) -> bytes:
    """Flip ``n`` seeded bits inside block ``index``'s payload bytes."""
    start, end = frame_payload_region(frame, index)
    return flip_bits(frame, seed, n, start, end)
