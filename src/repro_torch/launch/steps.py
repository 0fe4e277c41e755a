"""Step functions (train / prefill / decode) and the sharding spec trees of
their inputs: the port of the JAX package's `launch/steps.py`.

`make_train_step` takes the loss's gradient with autograd over
``requires_grad`` views of the parameter leaves and applies `adamw.update`
under `torch.no_grad()`; nothing given to a step is modified.  The spec
functions build the reference's `PartitionSpec` trees on the port's `P` and
`Mesh`.  The dry run's struct functions (`with_shardings`,
`train_state_structs`, `decode_state_structs`) give a step's arguments as
`Struct`s: a ``meta`` tensor (shape and dtype, no storage; the reference's
`jax.ShapeDtypeStruct`) with its `NamedSharding`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import flatten, unflatten
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    batch_axes,
    get_mesh,
    param_specs,
)
from repro_torch.launch.inputs import input_specs
from repro_torch.models import lm
from repro_torch.optim import adamw

__all__ = ["loss_and_grads", "make_train_step", "make_prefill_step", "make_decode_step",
           "batch_specs", "cache_specs", "sanitize_spec", "Struct", "with_shardings",
           "train_state_structs", "optimized_config", "serving_config",
           "decode_state_structs"]


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def loss_and_grads(params, batch, cfg: ModelConfig):
    """(`lm.train_loss`, its gradient as a tree shaped like ``params``):
    `jax.value_and_grad` of the loss.  A leaf the loss does not reach gets
    a zero gradient, as in JAX."""
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = lm.train_loss(unflatten(treedef, live), batch, cfg)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), unflatten(treedef, list(grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, grad_compressor=None):
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg)
        with torch.no_grad():
            if grad_compressor is not None:
                grads = grad_compressor(grads)
            params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens, cache["pos"], cfg)

    return decode_step


# ---------------------------------------------------------------------------
# Sharding spec trees
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh=None) -> dict:
    ba = batch_axes(mesh or get_mesh(), cfg.pure_dp)
    return {
        "tokens": P(ba, None),
        "enc_embeds": P(ba, None, None),
        "vision_embeds": P(ba, None, None),
    }


def _decode_batchable(global_batch: int, mesh) -> bool:
    n = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return global_batch % n == 0


def cache_specs(cache_shapes, cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """PartitionSpec tree for the decode cache (``cache_shapes``: a cache
    tree, e.g. `lm.init_cache(..., device="meta")`).

    Sequence axes of KV caches shard on "model" (decode_32k) or
    ("data","model") (long_500k, batch=1); batch shards on the data axes
    when divisible.
    """
    mesh = mesh or get_mesh()
    ba = batch_axes(mesh) if _decode_batchable(shape.global_batch, mesh) else ()
    seq_ax = ("data", "model") if shape.global_batch == 1 else "model"

    def leaf(path: str, x):
        nd = len(x.shape)
        if nd == 0:
            return P()
        if path.endswith("pos") and nd <= 2:  # slot position arrays
            return P(*((None,) * (nd - 1) + (seq_ax,)))
        if path.endswith(("/k", "/v", "cross_k", "cross_v")):
            # (repeats, B, S, kv, hd)
            return P(None, ba, seq_ax, None, None)
        if path.endswith("enc_memory") and nd == 3:
            return P(ba, None, None)
        if nd >= 2:  # recurrent states (repeats, B, ...)
            return P(*((None, ba) + (None,) * (nd - 2)))
        return P(*((None,) * nd))

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}") for i, v in enumerate(tree))
        if tree is None:
            return None
        return leaf(path, tree)

    return walk(cache_shapes, "")


def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop sharded axes that do not divide the dim evenly (argument shardings
    must tile exactly)."""
    out = []
    for i, el in enumerate(spec):
        if el is None:
            out.append(None)
            continue
        axes = el if isinstance(el, tuple) else (el,)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(el if shape[i] % n == 0 else None)
    return P(*out)


@dataclasses.dataclass(frozen=True)
class Struct:
    """One argument of a step, as `jax.ShapeDtypeStruct` with a sharding:
    ``value`` is a ``meta`` tensor (shape and dtype, no storage)."""

    value: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def with_shardings(shape_tree, spec_tree, mesh=None):
    """A tree of `Struct`s: each tensor leaf of ``shape_tree`` (any device;
    its shape and dtype are kept) with its spec from the matching leaf of
    ``spec_tree``, sanitized for its shape, over ``mesh``."""
    mesh = mesh or get_mesh()

    def walk(x, s):
        if x is None:
            return None
        if isinstance(x, dict):
            if set(x) != set(s):
                raise ValueError(f"spec keys {sorted(s)} do not match {sorted(x)}")
            return {k: walk(x[k], s[k]) for k in x}
        if isinstance(x, (list, tuple)):
            if len(x) != len(s):
                raise ValueError(f"{len(s)} specs for {len(x)} subtrees")
            return type(x)(walk(a, b) for a, b in zip(x, s))
        return Struct(torch.empty(x.shape, dtype=x.dtype, device="meta"),
                      NamedSharding(mesh, sanitize_spec(s, tuple(x.shape), mesh)))

    return walk(shape_tree, spec_tree)


def train_state_structs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """`Struct` trees of the train step's (params, opt state, batch)."""
    mesh = mesh or get_mesh()
    params_s = lm.init_params(cfg, device="meta")
    p_specs = param_specs(params_s, cfg.fsdp, mesh, cfg.pure_dp)
    params_sh = with_shardings(params_s, p_specs, mesh)
    opt_sh = with_shardings(adamw.init(params_s), {"m": p_specs, "v": p_specs, "step": P()},
                            mesh)
    raw_batch = {k: torch.empty(s, dtype=d, device="meta")
                 for k, (s, d) in input_specs(cfg, shape).items()}
    b_specs = {k: v for k, v in batch_specs(cfg, mesh).items() if k in raw_batch}
    return params_sh, opt_sh, with_shardings(raw_batch, b_specs, mesh)


def decode_state_structs(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """`Struct` trees of a decode step's (params, cache, tokens).  Pass a
    `serving_config` here (bfloat16 parameters, the serving FSDP rule)."""
    mesh = mesh or get_mesh()
    params_s = lm.init_params(cfg, device="meta")
    params_sh = with_shardings(params_s, param_specs(params_s, cfg.fsdp, mesh), mesh)
    B = shape.global_batch
    cache_s = lm.init_cache(cfg, B, shape.seq_len, device="meta")
    cache_sh = with_shardings(cache_s, cache_specs(cache_s, cfg, shape, mesh), mesh)
    ba = batch_axes(mesh) if _decode_batchable(B, mesh) else ()
    tokens_sh = Struct(torch.empty((B,), dtype=torch.int32, device="meta"),
                       NamedSharding(mesh, P(ba)))
    return params_sh, cache_sh, tokens_sh


def _param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, counted on its ``meta`` shape tree (the
    reference's `jax.eval_shape`)."""
    return sum(x.numel() for x in flatten(lm.init_params(cfg, device="meta"))[0])


def optimized_config(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> ModelConfig:
    """The reference's optimized posture: dots-saveable remat; pure DP (and
    FSDP) for models under 3e9 parameters in train/prefill when the global
    batch fills the mesh; for decode, the cache's sequence axes pinned and
    masked cache writes."""
    mesh = mesh or get_mesh()
    kw: dict = {"remat_policy": "dots"}
    if (
        shape.mode in ("train", "prefill")
        and _param_count(cfg) < 3e9
        and shape.global_batch % mesh.size == 0
    ):
        kw["pure_dp"] = True
        kw["fsdp"] = True
    if shape.mode == "decode":
        kw["decode_cache_axes"] = (
            ("data", "model") if shape.global_batch == 1 else ("model",)
        )
        kw["cache_update"] = "masked"
    return dataclasses.replace(cfg, **kw)


def serving_config(cfg: ModelConfig, mesh=None) -> ModelConfig:
    """Serving posture: bfloat16 parameters; FSDP only when tensor
    parallelism alone leaves more than 8 GB of bfloat16 weights per device."""
    mesh = mesh or get_mesh()
    tp = mesh.shape["model"]
    serve_fsdp = cfg.fsdp and (2 * _param_count(cfg) / tp > 8e9)
    return dataclasses.replace(cfg, param_dtype="bfloat16", fsdp=serve_fsdp)
