"""`repro_torch.resilience` — error recovery for the read/write stack.

The port of the JAX package's `resilience` package; each module keeps its
counterpart's names, signatures, spans and counters:

    errors    FrameError — unified corruption hierarchy with structured
              block_index/cause attributes (LZ4FormatError, FrameFormatError
              and CheckpointError are subclasses).
    retry     RetryPolicy/call — decorrelated-jitter backoff with deadline
              caps, wrapped around checkpoint I/O; RestartPolicy.
    salvage   SalvageReport + salvage_frame — decode every undamaged block
              of a corrupted frame through the seek index (all four
              executors; the device executor one block per dispatch) and
              reconstruct single damaged blocks from frame-v6 parity.
    inject    Seeded fault injection: deterministic bit flips, truncations,
              transient OSErrors, crash points (pure Python: the same seed
              does the same damage as the JAX package's).

NOTE This ``__init__`` loads submodules lazily (PEP 562): `repro_torch.core`
imports `repro_torch.resilience.errors` at module-import time, and eagerly
importing `salvage` here would close an import cycle back through
`repro_torch.core.decode_engine`.
"""
from __future__ import annotations

from .errors import FrameError  # noqa: F401  (dependency-free, safe eager)

__all__ = [
    "FrameError",
    "RetryPolicy", "RestartPolicy", "call", "retrying",
    "SalvageReport", "salvage_frame",
    "FaultInjector", "InjectedCrash",
    "errors", "retry", "salvage", "inject",
]

_LAZY = {
    "RetryPolicy": ("retry", "RetryPolicy"),
    "RestartPolicy": ("retry", "RestartPolicy"),
    "call": ("retry", "call"),
    "retrying": ("retry", "retrying"),
    "SalvageReport": ("salvage", "SalvageReport"),
    "salvage_frame": ("salvage", "salvage_frame"),
    "FaultInjector": ("inject", "FaultInjector"),
    "InjectedCrash": ("inject", "InjectedCrash"),
    "errors": ("errors", None),
    "retry": ("retry", None),
    "salvage": ("salvage", None),
    "inject": ("inject", None),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod if attr is None else getattr(mod, attr)
