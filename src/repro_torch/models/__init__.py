"""`repro_torch.models` — the language models that serve with their KV cache
offloaded through the LZ4 engines: the port of the JAX package's `models`.

    layers     norms, linear/MLP, rope, sinusoidal positions, softcap,
               chunked cross entropy.
    attention  GQA attention: chunked causal/local/bidirectional prefill,
               the KV cache (full and rolling), single-token decode.
    moe        Mixtral top-k experts, capacity counted per data-parallel
               shard of the current mesh.
    recurrent  RG-LRU, mLSTM (chunkwise + step) and sLSTM mixers.
    lm         init_params (stacked parameter tree), train_loss (autograd
               gives its gradient; remat through torch.utils.checkpoint),
               forward_logits, init_cache, prefill, decode_step.
    convert    params_from_numpy: the reference's weights in the port.

Submodules load lazily (PEP 562), as in `repro_torch.resilience`;
``train_loss`` is `lm.train_loss`.
"""
from __future__ import annotations

__all__ = ["layers", "attention", "moe", "recurrent", "lm", "convert", "train_loss"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    if name == "train_loss":
        return importlib.import_module(".lm", __name__).train_loss
    return importlib.import_module(f".{name}", __name__)
