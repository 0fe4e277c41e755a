"""AdamW + LR schedules (cosine, WSD, constant): the port of the JAX package's
`optim/adamw.py`.

The optimizer state mirrors the parameter tree, ``{"m", "v", "step"}`` as in
the reference, so a train state checkpoints leaf for leaf in either package.
The arithmetic is the reference's, in float32 tensors: ``step`` is a 0-d
int32 tensor, the schedule and the bias corrections are float32 (Python
float64 arithmetic would drift from the reference in the last bits), and
`global_norm` adds the leaves in the reference's order (dict keys sorted,
as `jax.tree` visits them).  Call `update` under `torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._tree import flatten, tree_map, unflatten

__all__ = ["AdamWConfig", "lr_at", "init", "global_norm", "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # "cosine" | "wsd" | "constant"
    decay_frac: float = 0.1   # WSD: fraction of steps spent decaying


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (int or tensor) as a 0-d float32 tensor
    (on ``step``'s device, or ``device`` for a Python int)."""
    step = _f32(step, device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    if cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0, 1)
        return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))
    if cfg.schedule == "wsd":  # MiniCPM warmup-stable-decay
        decay_start = cfg.total_steps * (1 - cfg.decay_frac)
        t = torch.clamp((step - decay_start) / max(cfg.total_steps - decay_start, 1), 0, 1)
        log_floor = torch.log(_f32(0.01, step.device))
        return cfg.lr * warm * torch.exp(log_floor * t)  # exp decay to 1% of lr
    raise ValueError(cfg.schedule)


def init(params) -> dict:
    """Zero moments shaped like ``params`` and a 0-d int32 step, on the
    parameters' device (the first leaf's)."""
    device = flatten(params)[0][0].device
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in flatten(tree)[0]:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def update(grads, state, params, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics); nothing given is modified."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    def leaf(g, m, v, p):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * p.to(torch.float32)
        # float32 arithmetic for any parameter dtype, as jnp promotes
        # (float32 lr) x (bfloat16 update)
        new_p = p.to(torch.float32) - lr * upd.to(p.dtype).to(torch.float32)
        return new_p.to(p.dtype), m2, v2

    g_leaves, treedef = flatten(grads)
    out = [leaf(g, m, v, p) for g, m, v, p in zip(
        g_leaves, flatten(state["m"])[0], flatten(state["v"])[0], flatten(params)[0])]
    new_state = {"m": unflatten(treedef, [o[1] for o in out]),
                 "v": unflatten(treedef, [o[2] for o in out]),
                 "step": step}
    return unflatten(treedef, [o[0] for o in out]), new_state, {"grad_norm": gnorm, "lr": lr}
