"""GQA attention: chunked (train/prefill), cached single-token (decode) — the
port of the JAX package's `models/attention.py`.

Prefill loops over query chunks with *exact* KV slices (causal: [0:(i+1)C],
local: a window+chunk wide band), so nothing is computed for masked-out
chunks.  KV heads are repeated to the query heads (GQA).  Scores are masked
to -1e30 (not -inf) and the softmax runs in float32, as the reference's;
`F.scaled_dot_product_attention` is not used: it cannot apply
``attn_softcap`` and masks differently.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import batch_axes, constrain, get_mesh

from .layers import apply_norm, linear_init, rope, softcap

Q_CHUNK = 512
_MASKED = -1e30


def attention_init(gen, cfg, d_kv_src=None, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    hd = cfg.hd
    d_kv_src = d_kv_src or d
    p = {
        "wq": linear_init(gen, d, cfg.n_heads * hd, cfg.use_bias, dtype, device),
        "wk": linear_init(gen, d_kv_src, cfg.n_kv_heads * hd, cfg.use_bias, dtype, device),
        "wv": linear_init(gen, d_kv_src, cfg.n_kv_heads * hd, cfg.use_bias, dtype, device),
        "wo": linear_init(gen, cfg.n_heads * hd, d, cfg.use_bias, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=dtype, device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=dtype, device=device)}
    return p


def _project_qkv(p, x, kv_src, cfg, q_positions, kv_positions):
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]["w"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    k = (kv_src @ p["wk"]["w"].to(x.dtype)).reshape(B, kv_src.shape[1], cfg.n_kv_heads, hd)
    v = (kv_src @ p["wv"]["w"].to(x.dtype)).reshape(B, kv_src.shape[1], cfg.n_kv_heads, hd)
    if cfg.use_bias:
        q = q + p["wq"]["b"].reshape(cfg.n_heads, hd).to(x.dtype)
        k = k + p["wk"]["b"].reshape(cfg.n_kv_heads, hd).to(x.dtype)
        v = v + p["wv"]["b"].reshape(cfg.n_kv_heads, hd).to(x.dtype)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, cfg.norm_eps, False)
        k = apply_norm(p["k_norm"], k, cfg.norm_eps, False)
    if cfg.pos_type == "rope" and q_positions is not None:
        q = rope(q, q_positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q: (B,Sq,H,hd), k/v: (B,Sk,H,hd); mask: (Sq,Sk) bool or None."""
    scale = cfg.hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None], _MASKED)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _repeat_kv(k, n_heads):
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def multihead_attention(p, x, cfg, attn_type: str = "global", memory=None, positions=None):
    """Training/prefill attention. Returns (out, (k, v)) for cache fill.

    attn_type: "global" (causal), "local" (causal sliding window), "bidir".
    memory: (B, S_mem, d) for cross attention (bidir over memory).
    """
    B, S, d = x.shape
    kv_src = memory if memory is not None else x
    S_kv = kv_src.shape[1]
    q_pos = positions if positions is not None else torch.arange(S, device=x.device)[None, :]
    kv_pos = None if memory is not None else q_pos
    q, k, v = _project_qkv(p, x, kv_src, cfg, q_pos, kv_pos)
    kf = _repeat_kv(k, cfg.n_heads)
    vf = _repeat_kv(v, cfg.n_heads)

    if memory is not None or attn_type == "bidir":
        if S <= Q_CHUNK * 2 and S_kv <= 4096:
            out = _sdpa(q, kf, vf, None, cfg)
        else:
            out = torch.cat([_sdpa(q[:, i: i + Q_CHUNK], kf, vf, None, cfg)
                             for i in range(0, S, Q_CHUNK)], dim=1)
    else:
        out = _causal_chunked(q, kf, vf, cfg, local=(attn_type == "local"))

    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    y = out @ p["wo"]["w"].to(x.dtype)
    if cfg.use_bias:
        y = y + p["wo"]["b"].to(x.dtype)
    return y, (k, v)


def _causal_chunked(q, k, v, cfg, local: bool):
    """Causal (optionally sliding-window) attention with exact KV slices."""
    B, S, H, hd = q.shape
    C = min(Q_CHUNK, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{C}-query chunk")
    window = cfg.window
    outs = []
    for i in range(0, S, C):
        if local:
            k0 = max(0, i + C - (window + C))
            kw = i + C - k0
        else:
            k0 = 0
            kw = i + C
        qp = i + torch.arange(C, device=q.device)
        kp = k0 + torch.arange(kw, device=q.device)
        mask = kp[None, :] <= qp[:, None]
        if local:
            mask &= kp[None, :] > qp[:, None] - window
        outs.append(_sdpa(q[:, i: i + C], k[:, k0: k0 + kw], v[:, k0: k0 + kw], mask, cfg))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Decode path: single new token against a KV cache.
# ---------------------------------------------------------------------------

def make_cache(cfg, attn_type: str, batch: int, cache_len: int, dtype, device="cpu"):
    """Cache for one attention layer."""
    size = min(cfg.window, cache_len) if attn_type == "local" else cache_len
    return {
        "k": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        # absolute position per slot
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def fill_cache(cache, k, v, start: int = 0):
    """Prefill: write S tokens (positions start..start+S) into the cache.
    Returns a new cache; ``cache`` is not modified."""
    S = k.shape[1]
    size = cache["k"].shape[1]
    out = {name: t.clone() for name, t in cache.items()}
    if size >= S:
        # dynamic_update_slice clamps the start so that the update fits
        start = min(max(int(start), 0), size - S)
        out["k"][:, start: start + S] = k
        out["v"][:, start: start + S] = v
        out["pos"][start: start + S] = torch.arange(start, start + S, dtype=torch.int32,
                                                    device=k.device)
        return out
    # rolling (local) cache: keep the last `size` tokens
    tail_pos = torch.arange(S - size, S, dtype=torch.int32, device=k.device) + start
    slots = (tail_pos % size).long()
    out["k"][:, slots] = k[:, -size:]
    out["v"][:, slots] = v[:, -size:]
    out["pos"][slots] = tail_pos
    return out


def decode_attention(p, x, cfg, cache, pos: int, attn_type: str = "global",
                     memory_cache=None):
    """x: (B,1,d); pos: int — absolute position of the new token.

    Returns (out (B,1,d), updated cache); ``cache`` is not modified.
    """
    B = x.shape[0]
    hd = cfg.hd
    pos_bt = torch.full((B, 1), pos, device=x.device)
    q = (x @ p["wq"]["w"].to(x.dtype)).reshape(B, 1, cfg.n_heads, hd)
    if cfg.use_bias:
        q = q + p["wq"]["b"].reshape(cfg.n_heads, hd).to(x.dtype)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, cfg.norm_eps, False)
    if cfg.pos_type == "rope":
        q = rope(q, pos_bt, cfg.rope_theta)

    if memory_cache is not None:  # cross attention: static precomputed k/v
        kf = _repeat_kv(memory_cache["k"], cfg.n_heads)
        vf = _repeat_kv(memory_cache["v"], cfg.n_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kf) * hd ** -0.5
        scores = softcap(scores, cfg.attn_softcap)
        probs = torch.softmax(scores.float(), -1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
        y = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]["w"].to(x.dtype)
        if cfg.use_bias:
            y = y + p["wo"]["b"].to(x.dtype)
        return y, cache

    k_new = (x @ p["wk"]["w"].to(x.dtype)).reshape(B, 1, cfg.n_kv_heads, hd)
    v_new = (x @ p["wv"]["w"].to(x.dtype)).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.use_bias:
        k_new = k_new + p["wk"]["b"].reshape(cfg.n_kv_heads, hd).to(x.dtype)
        v_new = v_new + p["wv"]["b"].reshape(cfg.n_kv_heads, hd).to(x.dtype)
    if cfg.qk_norm:
        k_new = apply_norm(p["k_norm"], k_new, cfg.norm_eps, False)
    if cfg.pos_type == "rope":
        k_new = rope(k_new, pos_bt, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = pos % size
    if cfg.cache_update == "masked":
        # the reference's per-shard local update (a select over every slot)
        sel = torch.arange(size, device=x.device) == slot
        k_all = torch.where(sel[None, :, None, None], k_new.to(cache["k"].dtype), cache["k"])
        v_all = torch.where(sel[None, :, None, None], v_new.to(cache["v"].dtype), cache["v"])
        pos_all = torch.where(sel, torch.full_like(cache["pos"], pos), cache["pos"])
    else:  # "dus": dynamic_update_slice at the slot
        k_all, v_all, pos_all = cache["k"].clone(), cache["v"].clone(), cache["pos"].clone()
        k_all[:, slot] = k_new[:, 0]
        v_all[:, slot] = v_new[:, 0]
        pos_all[slot] = pos
    new_cache = {"k": k_all, "v": v_all, "pos": pos_all}

    ax = cfg.decode_cache_axes
    if ax:  # the reference pins the cache layout; placement only, no value
        ba = batch_axes(get_mesh())
        k_all = constrain(k_all, ba, ax, None, None)
        v_all = constrain(v_all, ba, ax, None, None)
    kf = _repeat_kv(k_all, cfg.n_heads)
    vf = _repeat_kv(v_all, cfg.n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf) * hd ** -0.5
    scores = softcap(scores, cfg.attn_softcap)
    valid = (pos_all >= 0) & (pos_all <= pos)
    if attn_type == "local":
        valid &= pos_all > pos - cfg.window
    scores = scores.masked_fill(~valid[None, None, None, :], _MASKED)
    probs = torch.softmax(scores.float(), -1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    y = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]["w"].to(x.dtype)
    if cfg.use_bias:
        y = y + p["wo"]["b"].to(x.dtype)
    return y, new_cache
