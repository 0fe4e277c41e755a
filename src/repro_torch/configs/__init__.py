"""`repro_torch.configs` — model configs, layer programs, input shapes and
the registry: a copy of the JAX package's `configs` (pure Python).

    base       LayerSpec, Segment, ModelConfig (``.reduced()`` for the CPU
               tests), ShapeConfig, SHAPES, LONG_CONTEXT_ARCHS, get_config,
               all_arch_names, cells.
    arch_defs  the ten architectures; ``<arch>.py`` re-export them so that
               `get_config("qwen3-1.7b")` resolves through the registry.

Names load lazily (PEP 562), as in `repro_torch.resilience`.
"""
from __future__ import annotations

__all__ = ["LayerSpec", "Segment", "ModelConfig", "ShapeConfig", "SHAPES",
           "LONG_CONTEXT_ARCHS", "get_config", "all_arch_names", "cells"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from . import base

    return getattr(base, name)
