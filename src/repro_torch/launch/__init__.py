"""`repro_torch.launch` — entry points: the port of the JAX package's `launch`.

    inputs    batch_dims, input_specs ((shape, dtype) pairs), make_batch
              (seeded; the reference's tokens and stub embeddings).
    serve     `python -m repro_torch.launch.serve [--device cpu]`: requests
              through `ServingEngine` on a reduced model.
    train     `python -m repro_torch.launch.train [--device cpu]`: the
              training loop with LZ4 checkpoints, failure recovery and
              optional int8 gradient compression.
    steps     make_train_step / make_prefill_step / make_decode_step, the
              batch and cache spec trees, optimized_config, serving_config,
              and the dry run's struct trees (train_state_structs,
              decode_state_structs: meta tensors with their shardings).
    roofline  model_param_count, model_flops, the H100's peak rates, and the
              roofline rows of the dry run's records.
    mesh      make_production_mesh: the 16x16 (or 2x16x16) mesh of cards,
              or of repeated ``meta`` devices for the dry run.
    dryrun    `python -m repro_torch.launch.dryrun`: every cell's step traced
              over meta tensors; bytes and FLOPs counted, no compiler.
    hillclimb `python -m repro_torch.launch.hillclimb --cell ...`: config
              variants of a cell through the dry run's counts.
    report    `python -m repro_torch.launch.report`: prints the tables.

Submodules load lazily (PEP 562).
"""
from __future__ import annotations

__all__ = ["inputs", "serve", "train", "steps", "roofline", "mesh", "dryrun", "hillclimb",
           "report"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return importlib.import_module(f".{name}", __name__)
