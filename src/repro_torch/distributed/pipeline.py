"""GPipe-style pipeline parallelism over the "pod" axis of the current mesh.

The port of the JAX package's `distributed/pipeline.py`.
`pipeline_apply(stage_fn, stage_params, x)` computes

    y = stage_fn(p[S-1], stage_fn(p[S-2], ... stage_fn(p[0], x)))

with stage s's parameters on the device of pod position s and T
microbatches in flight.  The reference moves activations with
`jax.lax.ppermute` inside `shard_map`; here one process runs the same
schedule of ``T + S - 1`` steps and copies each microbatch's activation to
the next stage's device — the one place in the fabric's slice where data
moves between devices.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map

from .sharding import get_mesh

__all__ = ["pipeline_apply", "bubble_fraction"]


def _stage_devices(mesh, axis: str) -> list[torch.device]:
    pos = mesh.axis_names.index(axis)
    devs = []
    for s in range(mesh.shape[axis]):
        coords = [0] * len(mesh.axis_names)
        coords[pos] = s
        devs.append(mesh.device_at(coords))
    return devs


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, axis: str = "pod",
                   n_micro: int | None = None) -> torch.Tensor:
    """Run a pipelined stack of stages over the current mesh's ``axis``.

    stage_fn     : (params_leaf_tree, (mb, ...)) -> (mb, ...)
    stage_params : tree with leading axis = n_stages on every leaf
    x            : (batch, ...) global input (batch % n_micro == 0)

    Returns the output on ``x``'s device.
    """
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("pipeline_apply needs a current mesh (use_mesh)")
    S = mesh.shape[axis]
    B = x.shape[0]
    T = n_micro or S  # default: as many microbatches as stages
    if B % T:
        raise ValueError(f"batch {B} does not divide into {T} microbatches")
    xm = x.reshape(T, B // T, *x.shape[1:])
    devs = _stage_devices(mesh, axis)
    params = [tree_map(lambda a, s=s: a[s].to(devs[s]), stage_params)
              for s in range(S)]
    outs: list = [None] * T
    recv: list = [None] * S   # activation waiting at each stage
    for t in range(T + S - 1):
        nxt: list = [None] * S
        for s in range(S):
            m = t - s          # the microbatch stage s holds at step t
            if not 0 <= m < T:
                continue       # the bubble: nothing to run
            inp = xm[m].to(devs[0]) if s == 0 else recv[s]
            out = stage_fn(params[s], inp)
            if s == S - 1:
                outs[m] = out.to(x.device)
            else:
                nxt[s + 1] = out.to(devs[s + 1])
        recv = nxt
    return torch.stack(outs).reshape(B, *outs[0].shape[1:])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble: idle fraction of the pipeline schedule."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
