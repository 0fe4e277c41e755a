"""`repro_torch.launch` — entry points: the port of the JAX package's `launch`.

    inputs  batch_dims, input_specs ((shape, dtype) pairs), make_batch
            (seeded; the reference's tokens and stub embeddings).
    serve   `python -m repro_torch.launch.serve [--device cpu]`: requests
            through `ServingEngine` on a reduced model.
    mesh    make_production_mesh: the 16x16 (or 2x16x16) mesh of cards.

Training (steps, train, dryrun, hillclimb, report, roofline) is not ported
yet (ROADMAP A9b).  Submodules load lazily (PEP 562).
"""
from __future__ import annotations

__all__ = ["inputs", "serve", "mesh"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return importlib.import_module(f".{name}", __name__)
