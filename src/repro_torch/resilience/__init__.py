"""`repro_torch.resilience` — the corruption error hierarchy.

    errors    FrameError — unified corruption hierarchy with structured
              block_index/cause attributes (LZ4FormatError and
              FrameFormatError are subclasses).
"""
from __future__ import annotations

from .errors import FrameError  # noqa: F401  (dependency-free)

__all__ = ["FrameError", "errors"]
