"""`repro_torch.launch` — entry points: the port of the JAX package's `launch`.

    inputs    batch_dims, input_specs ((shape, dtype) pairs), make_batch
              (seeded; the reference's tokens and stub embeddings).
    serve     `python -m repro_torch.launch.serve [--device cpu]`: requests
              through `ServingEngine` on a reduced model.
    train     `python -m repro_torch.launch.train [--device cpu]`: the
              training loop with LZ4 checkpoints, failure recovery and
              optional int8 gradient compression.
    steps     make_train_step / make_prefill_step / make_decode_step, the
              batch and cache spec trees, optimized_config, serving_config.
    roofline  model_param_count, model_flops and the H100's peak rates.
    mesh      make_production_mesh: the 16x16 (or 2x16x16) mesh of cards.

Not ported yet (ROADMAP A9c): dryrun, hillclimb, report, roofline's dry-run
half and steps' struct functions.  Submodules load lazily (PEP 562).
"""
from __future__ import annotations

__all__ = ["inputs", "serve", "train", "steps", "roofline", "mesh"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return importlib.import_module(f".{name}", __name__)
