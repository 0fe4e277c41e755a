"""Mixtral-style MoE FFN (8 experts, top-2): the port of the JAX package's
`models/moe.py`.

Tokens stay within their data-parallel shard: dispatch is a per-shard sort
(stable argsort by expert id + a capacity clamp), so the capacity, and with
it which tokens are dropped, is counted PER SHARD.  The reference runs that
under `shard_map`; the port splits the batch into the mesh's data-parallel
chunks in an explicit loop, so a mesh gives the values the reference gives
on the same mesh.  The reference's TP psum and FSDP all-gathers change no
value and have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import batch_axes, get_mesh

from .layers import _init


def moe_init(gen, cfg, dtype=torch.float32, device="cpu"):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "wr": {"w": _init(gen, (d, e), dtype=dtype, device=device)},
        "w1": {"w": _init(gen, (e, d, f), dtype=dtype, device=device)},
        "w3": {"w": _init(gen, (e, d, f), dtype=dtype, device=device)},
        "w2": {"w": _init(gen, (e, f, d), scale=1.0 / (f ** 0.5), dtype=dtype, device=device)},
    }


def top_k(x, k: int):
    """`jax.lax.top_k` along the last axis: ties go to the LOWER index
    (`torch.topk` does not promise an order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(flat_e, n_experts: int):
    """Rows routed to each expert: ``torch.bincount(flat_e,
    minlength=n_experts)`` (exact int64 counts), in a form that also runs
    on ``meta`` tensors, which `bincount` does not."""
    return torch.zeros((n_experts,), dtype=torch.int64, device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))


def _local_moe(x, wr, w1, w3, w2, cfg):
    """Expert compute over one data-parallel shard. x: (B_loc, S, d)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    C = max(8, int(T * k / E * cfg.capacity_factor))  # static capacity

    t = x.reshape(T, d)
    logits = t.float() @ wr.float()                             # (T, E)
    top_vals, top_idx = top_k(logits, k)                        # (T, k)
    gates = torch.softmax(top_vals, dim=-1)                     # mixtral renorm

    # --- sort-based dispatch ---
    flat_e = top_idx.reshape(-1)                                # (T*k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    pos_in_e = torch.arange(T * k, device=x.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos_in_e < C
    # Dropped rows go to the extra row E*C of the buffer, which is cut off
    # (the reference drops them as out-of-range indices).
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    tok = order // k
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, t[tok] * keep[:, None].to(x.dtype))
    be = buf[: E * C].reshape(E, C, d)

    # --- expert FFN ---
    h = torch.einsum("ecd,edf->ecf", be, w1.to(x.dtype))
    g = torch.einsum("ecd,edf->ecf", be, w3.to(x.dtype))
    o = torch.einsum("ecf,efd->ecd", F.silu(h) * g, w2.to(x.dtype))

    # --- combine ---
    slot_by_flat = torch.empty((T * k,), dtype=torch.long, device=x.device)
    slot_by_flat[order] = torch.where(keep, slot, -1)
    ok = slot_by_flat >= 0
    gathered = o.reshape(E * C, d)[slot_by_flat.clamp(min=0)]
    gathered = gathered * ok[:, None].to(x.dtype)
    y = (gathered.reshape(T, k, d) * gates[..., None].to(x.dtype)).sum(1)

    # load-balancing aux loss (GShard): E * sum_e fraction_e * prob_e
    probs = torch.softmax(logits, dim=-1)
    frac = expert_counts(flat_e, E).float() / (T * k)
    aux = E * torch.sum(frac * probs.mean(0))
    return y.reshape(B, S, d), aux


def _dense_moe(p, x, cfg):
    """All-experts einsum path for token counts that do not divide over the
    data-parallel shards (decode with a small batch): the same function
    value when no capacity drops occur."""
    E, k = cfg.n_experts, cfg.top_k
    w1, w3, w2 = p["w1"]["w"], p["w3"]["w"], p["w2"]["w"]
    logits = x.float() @ p["wr"]["w"].float()                    # (B,S,E)
    top_vals, top_idx = top_k(logits, k)
    gates = torch.softmax(top_vals, dim=-1)
    gate_full = torch.zeros(logits.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        gate_full = gate_full + F.one_hot(top_idx[..., i], E).float() * gates[..., i: i + 1]
    h = torch.einsum("bsd,edf->bsef", x, w1.to(x.dtype))
    g = torch.einsum("bsd,edf->bsef", x, w3.to(x.dtype))
    o = torch.einsum("bsef,efd->bsed", F.silu(h) * g, w2.to(x.dtype))
    y = torch.einsum("bsed,bse->bsd", o, gate_full.to(x.dtype))
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(top_idx, E).float().sum((0, 1, 2)) / (
        logits.shape[0] * logits.shape[1] * k)
    aux = E * torch.sum(frac * probs.mean((0, 1)))
    return y, aux


def moe_ffn(p, x, cfg):
    """x: (B, S, d) global. Returns (y, aux_loss).

    The batch is cut into one contiguous chunk per data-parallel position of
    the current mesh (none: one chunk), each chunk dispatched with its own
    capacity, and ``aux`` is the chunks' mean — as the reference's
    `shard_map` over the batch axes and its `pmean`.  A batch that does not
    divide takes `_dense_moe`, as in the reference.
    """
    mesh = get_mesh()
    ba = batch_axes(mesh, cfg.pure_dp)
    n_dp = int(np.prod([mesh.shape[a] for a in ba])) if (mesh and ba) else 1
    if x.shape[0] % n_dp != 0:
        return _dense_moe(p, x, cfg)
    w = (p["wr"]["w"], p["w1"]["w"], p["w3"]["w"], p["w2"]["w"])
    parts = [_local_moe(xx, *w, cfg) for xx in torch.chunk(x, n_dp, dim=0)]
    y = torch.cat([yy for yy, _ in parts], dim=0)
    aux = torch.stack([a for _, a in parts]).mean()
    return y, aux
