"""Shared neural building blocks (pure functional, dict params): the port of
the JAX package's `models/layers.py`.

Initializers draw from an explicit `torch.Generator` (``gen``) on its own
device and place the result on ``device``; on ``device="meta"`` they give
shape-and-dtype placeholders and draw nothing.  The scales are the
reference's; the values are not (the generators differ).  To run the
reference's weights, convert its `init_params` output with
`repro_torch.models.convert.params_from_numpy`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _init(gen, shape, scale=None, dtype=torch.float32, device="cpu"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def norm_init(d, layer_norm: bool, dtype=torch.float32, device="cpu"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if layer_norm:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, eps: float, layer_norm: bool):
    """RMSNorm (or LayerNorm), computed in float32 and cast back."""
    xf = x.float()
    if layer_norm:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def linear_init(gen, d_in, d_out, use_bias=False, dtype=torch.float32, device="cpu"):
    p = {"w": _init(gen, (d_in, d_out), dtype=dtype, device=device)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp_init(gen, d, f, use_bias=False, gated=True, dtype=torch.float32, device="cpu"):
    if gated:
        return {
            "w_gate": linear_init(gen, d, f, use_bias, dtype, device),
            "w_up": linear_init(gen, d, f, use_bias, dtype, device),
            "w_down": linear_init(gen, f, d, use_bias, dtype, device),
        }
    return {
        "w_in": linear_init(gen, d, f, use_bias, dtype, device),
        "w_out": linear_init(gen, f, d, use_bias, dtype, device),
    }


def gelu(x):
    """`jax.nn.gelu`'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x):
    if "w_gate" in p:
        return apply_linear(
            p["w_down"], F.silu(apply_linear(p["w_gate"], x)) * apply_linear(p["w_up"], x)
        )
    return apply_linear(p["w_out"], gelu(apply_linear(p["w_in"], x)))


def rope(x, positions, theta: float):
    """Rotary embeddings, halves split at hd // 2 (not interleaved).
    x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, offset=0, device="cpu"):
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    half = d // 2
    freq = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=device)
                       / max(half - 1, 1))
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def cross_entropy_chunked(logits_fn, x, labels, mask, vocab: int, chunk: int = 4096):
    """Mean CE without materializing (B,S,V): a loop over flattened token
    chunks (the reference's `lax.scan`); differentiable.

    logits_fn: (T, d) -> (T, V).  mask: (B,S) float weights.
    """
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    lt = labels.reshape(B * S)
    mt = mask.reshape(B * S)
    T = B * S
    chunk = min(chunk, T)
    n_chunks = T // chunk
    rem = T - n_chunks * chunk

    def one(xc, lc, mc):
        logits = logits_fn(xc).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lc[:, None].long(), dim=-1)[:, 0]
        return ((logz - gold) * mc).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + one(xt[sl], lt[sl], mt[sl])
    if rem:
        total = total + one(xt[-rem:], lt[-rem:], mt[-rem:])
    return total / torch.clamp(mt.sum(), min=1.0)
