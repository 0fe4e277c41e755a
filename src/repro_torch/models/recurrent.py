"""Recurrent mixers: RG-LRU (Griffin/RecurrentGemma), mLSTM and sLSTM
(xLSTM) — the port of the JAX package's `models/recurrent.py`.

  * RG-LRU — diagonal linear recurrence; the reference's associative scan
    becomes a log-step (Hillis-Steele) scan over time: the same combine,
    applied in another order, so results agree within float rounding.
  * mLSTM  — matrix memory with exponential gating, chunkwise-parallel form
    (intra-chunk attention-like matrix + inter-chunk state carry, log-space
    stabilized): a Python loop over chunks.  A step form serves decode and
    as the equality oracle.
  * sLSTM  — hidden-to-hidden recurrence, inherently sequential: a Python
    loop over time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _init, apply_linear, gelu, linear_init

_LRU_C = 8.0  # Griffin's fixed constant on the recurrence gate


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rglru_init(gen, cfg, dtype=torch.float32, device="cpu"):
    d, r = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "wx": linear_init(gen, d, r, dtype=dtype, device=device),
        "wgate": linear_init(gen, d, r, dtype=dtype, device=device),
        "wa": linear_init(gen, r, r, dtype=dtype, device=device),
        "wi_gate": linear_init(gen, r, r, dtype=dtype, device=device),
        "wo_proj": linear_init(gen, r, d, dtype=dtype, device=device),
        "conv_w": _init(gen, (cfg.conv_width, r), scale=0.3, dtype=dtype, device=device),
        # Lambda param; a ~ exp(-8*softplus(lam)*sig)
        "lam": torch.full((r,), 0.65, dtype=dtype, device=device),
    }


def _causal_conv(u, w):
    """Depthwise causal conv over time, as shifts and adds. u: (B,S,r), w: (W,r)."""
    W = w.shape[0]
    out = u * w[W - 1].to(u.dtype)
    for j in range(1, W):
        shifted = F.pad(u[:, :-j], (0, 0, j, 0))
        out = out + shifted * w[W - 1 - j].to(u.dtype)
    return out


def _lru_scan(a, bx):
    """h_t = a_t * h_{t-1} + bx_t over axis 1, in log2(S) doubling steps."""
    S = a.shape[1]
    d = 1
    while d < S:
        b_new = bx[:, d:] + bx[:, :-d] * a[:, d:]
        a_new = a[:, :-d] * a[:, d:]
        bx = torch.cat([bx[:, :d], b_new], dim=1)
        a = torch.cat([a[:, :d], a_new], dim=1)
        d *= 2
    return bx


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_block(p, x, cfg):
    """Griffin recurrent block. x: (B,S,d) -> (y, final_state)."""
    gate = gelu(apply_linear(p["wgate"], x))
    u_pre = apply_linear(p["wx"], x)
    u = _causal_conv(u_pre, p["conv_w"])
    uf = u.float()
    ra = torch.sigmoid(uf @ p["wa"]["w"].float())
    log_a = -_LRU_C * _softplus(p["lam"].float()) * ra
    a = torch.exp(log_a)
    i = torch.sigmoid(uf @ p["wi_gate"]["w"].float())
    bx = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-9)) * (i * uf)
    h = _lru_scan(a, bx)
    W = cfg.conv_width
    conv_tail = F.pad(u_pre, (0, 0, W - 1, 0))[:, -(W - 1):]
    state = {"h": h[:, -1], "conv": conv_tail}
    y = apply_linear(p["wo_proj"], h.to(x.dtype) * gate)
    return y, state


def rglru_state_init(cfg, batch: int, dtype, device="cpu"):
    r = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype, device=device),
    }


def rglru_step(p, x, cfg, state):
    """x: (B,1,d) decode step. Returns (y (B,1,d), state)."""
    gate = gelu(apply_linear(p["wgate"], x))[:, 0]
    u = apply_linear(p["wx"], x)[:, 0]  # (B, r)
    hist = torch.cat([state["conv"], u[:, None]], dim=1)  # (B,W,r)
    w = p["conv_w"].to(u.dtype)
    u_c = (hist * w[None]).sum(1)
    uf = u_c.float()
    ra = torch.sigmoid(uf @ p["wa"]["w"].float())
    log_a = -_LRU_C * _softplus(p["lam"].float()) * ra
    a = torch.exp(log_a)
    i = torch.sigmoid(uf @ p["wi_gate"]["w"].float())
    h = a * state["h"] + torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-9)) * (i * uf)
    y = apply_linear(p["wo_proj"], (h.to(x.dtype) * gate)[:, None])
    return y, {"h": h, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating) — chunkwise parallel
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    di = cfg.d_inner or 2 * d
    H = cfg.n_heads
    return {
        "w_up": linear_init(gen, d, di, dtype=dtype, device=device),     # value path
        "w_z": linear_init(gen, d, di, dtype=dtype, device=device),      # output gate path
        "conv_w": _init(gen, (cfg.conv_width, di), scale=0.3, dtype=dtype, device=device),
        "wq": linear_init(gen, di, di, dtype=dtype, device=device),
        "wk": linear_init(gen, di, di, dtype=dtype, device=device),
        "wv": linear_init(gen, di, di, dtype=dtype, device=device),
        "w_if": linear_init(gen, di, 2 * H, dtype=dtype, device=device),  # i,f gate logits
        "w_down": linear_init(gen, di, d, dtype=dtype, device=device),
        "skip": torch.ones((di,), dtype=dtype, device=device),
    }


def _mlstm_chunk(q, k, v, i_g, f_g, chunk: int):
    """Chunkwise mLSTM. q,k,v: (B,S,H,p) f32; i_g,f_g: (B,S,H) f32 logits.

    Returns (h: (B,S,H,p), final (C~, n~, m)).  Stabilized in log space;
    the state carried across chunks is (C~ (B,H,p,p), n~ (B,H,p), m (B,H))
    with true C = C~ e^m.
    """
    B, S, H, p_dim = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{L}-step chunk")
    N = S // L
    fc_all = F.logsigmoid(f_g)
    t_idx = torch.arange(L, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    sc = p_dim ** -0.5

    Ct = torch.zeros((B, H, p_dim, p_dim), dtype=torch.float32, device=q.device)
    nt = torch.zeros((B, H, p_dim), dtype=torch.float32, device=q.device)
    mt = torch.full((B, H), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for c in range(N):
        sl = slice(c * L, (c + 1) * L)
        qq, kk, vv, ii, ff = q[:, sl], k[:, sl], v[:, sl], i_g[:, sl], fc_all[:, sl]
        Fc = torch.cumsum(ff, dim=1)    # (B,L,H) log decay from chunk start (incl t)
        # intra-chunk log weights: F_t - F_s + i_s for s <= t
        lw = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]  # (B,t,s,H)
        lw = lw.masked_fill(~causal[None, :, :, None], float("-inf"))
        a_t = Fc + mt[:, None, :]                        # initial-state branch
        b_t = lw.amax(dim=2)                             # (B,t,H)
        m_new = torch.maximum(a_t, b_t)
        m_new = torch.clamp(m_new, min=-1e30)            # guard -inf
        # intra contribution
        D = torch.exp(lw - m_new[:, :, None, :])         # (B,t,s,H)
        scores = torch.einsum("bthp,bshp->btsh", qq, kk) * sc
        num_intra = torch.einsum("btsh,bshp->bthp", scores * D, vv)
        den_intra = (scores * D).sum(dim=2)              # (B,t,H)
        # inter contribution (initial state)
        w_init = torch.exp(a_t - m_new)                  # (B,t,H)
        num_inter = torch.einsum("bthp,bhpr->bthr", qq * sc, Ct) * w_init[..., None]
        den_inter = torch.einsum("bthp,bhp->bth", qq * sc, nt) * w_init
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None])
        # chunk-end state update
        F_L = Fc[:, -1, :]                               # (B,H) total chunk decay
        m_out = torch.maximum(F_L + mt, (F_L[:, None, :] - Fc + ii).amax(dim=1))
        w_old = torch.exp(F_L + mt - m_out)              # (B,H)
        w_s = torch.exp(F_L[:, None, :] - Fc + ii - m_out[:, None, :])  # (B,s,H)
        Ct = Ct * w_old[..., None, None] + torch.einsum(
            "bshp,bshr->bhpr", kk * w_s[..., None], vv)
        nt = nt * w_old[..., None] + torch.einsum("bsh,bshp->bhp", w_s, kk)
        mt = m_out
    return torch.cat(hs, dim=1), (Ct, nt, mt)


def mlstm_step(q, k, v, i_g, f_g, state):
    """Single decode step. q,k,v: (B,H,p) f32; i_g,f_g: (B,H) logits."""
    C, n, m = state["C"], state["n"], state["m"]
    p_dim = q.shape[-1]
    lf = F.logsigmoid(f_g)
    m_new = torch.maximum(lf + m, i_g)
    w_old = torch.exp(lf + m - m_new)
    w_in = torch.exp(i_g - m_new)
    C_new = C * w_old[..., None, None] + torch.einsum(
        "bhp,bhr->bhpr", k * w_in[..., None], v)
    n_new = n * w_old[..., None] + k * w_in[..., None]
    num = torch.einsum("bhp,bhpr->bhr", q * (p_dim ** -0.5), C_new)
    den = torch.einsum("bhp,bhp->bh", q * (p_dim ** -0.5), n_new)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h, {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_sequential(q, k, v, i_g, f_g):
    """Step-by-step oracle for tests."""
    B, S, H, p_dim = q.shape
    state = {
        "C": torch.zeros((B, H, p_dim, p_dim), dtype=torch.float32, device=q.device),
        "n": torch.zeros((B, H, p_dim), dtype=torch.float32, device=q.device),
        "m": torch.full((B, H), -1e30, dtype=torch.float32, device=q.device),
    }
    hs = []
    for t in range(S):
        h, state = mlstm_step(q[:, t], k[:, t], v[:, t], i_g[:, t], f_g[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_block(p, x, cfg, chunk: int = 256):
    """xLSTM mLSTM block: up-proj, conv, matrix-memory mixer, gated down-proj.

    Returns (y, final_state) so prefill can seed the decode cache directly.
    """
    B, S, d = x.shape
    di = cfg.d_inner or 2 * d
    H = cfg.n_heads
    pd = di // H
    z = apply_linear(p["w_z"], x)
    u = apply_linear(p["w_up"], x)
    c = F.silu(_causal_conv(u, p["conv_w"]))
    q = apply_linear(p["wq"], c).reshape(B, S, H, pd).float()
    k = apply_linear(p["wk"], c).reshape(B, S, H, pd).float()
    v = apply_linear(p["wv"], u).reshape(B, S, H, pd).float()
    if_g = apply_linear(p["w_if"], u).float()
    i_g, f_g = if_g[..., :H], if_g[..., H:]
    h, (Cf, nf, mf) = _mlstm_chunk(q, k, v, i_g, f_g, chunk)
    h = h.to(x.dtype)
    W = cfg.conv_width
    conv_tail = F.pad(u, (0, 0, W - 1, 0))[:, -(W - 1):]
    state = {"C": Cf, "n": nf, "m": mf, "conv": conv_tail}
    h = h.reshape(B, S, di) + u * p["skip"].to(x.dtype)
    return apply_linear(p["w_down"], h * F.silu(z)), state


def mlstm_state_init(cfg, batch: int, dtype, device="cpu"):
    di = cfg.d_inner or 2 * cfg.d_model
    H = cfg.n_heads
    pd = di // H
    return {
        "C": torch.zeros((batch, H, pd, pd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, pd), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype, device=device),
    }


def mlstm_block_step(p, x, cfg, state):
    """Decode step. x: (B,1,d)."""
    B = x.shape[0]
    di = cfg.d_inner or 2 * cfg.d_model
    H = cfg.n_heads
    pd = di // H
    z = apply_linear(p["w_z"], x)[:, 0]
    u = apply_linear(p["w_up"], x)[:, 0]
    hist = torch.cat([state["conv"], u[:, None]], dim=1)
    w = p["conv_w"].to(u.dtype)
    c = F.silu((hist * w[None]).sum(1))
    q = apply_linear(p["wq"], c).reshape(B, H, pd).float()
    k = apply_linear(p["wk"], c).reshape(B, H, pd).float()
    v = apply_linear(p["wv"], u).reshape(B, H, pd).float()
    if_g = apply_linear(p["w_if"], u).float()
    i_g, f_g = if_g[..., :H], if_g[..., H:]
    h, new_inner = mlstm_step(q, k, v, i_g, f_g, state)
    h = h.reshape(B, di).to(x.dtype) + u * p["skip"].to(x.dtype)
    y = apply_linear(p["w_down"], (h * F.silu(z))[:, None])
    return y, {**new_inner, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, hidden-to-hidden recurrence: inherently sequential)
# ---------------------------------------------------------------------------

def slstm_init(gen, cfg, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    return {
        "w_zifo": linear_init(gen, d, 4 * d, dtype=dtype, device=device),
        "r_zifo": _init(gen, (4, H, hd, hd), scale=1.0 / hd ** 0.5, dtype=dtype, device=device),
        "b_zifo": torch.zeros((4, d), dtype=dtype, device=device),
        # post-mixer gated FFN (proj factor 4/3, xLSTM paper)
        "w_up_f": linear_init(gen, d, (4 * d) // 3, dtype=dtype, device=device),
        "w_gate_f": linear_init(gen, d, (4 * d) // 3, dtype=dtype, device=device),
        "w_down_f": linear_init(gen, (4 * d) // 3, d, dtype=dtype, device=device),
    }


def slstm_state_init(cfg, batch: int, dtype, device="cpu"):
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "n": torch.ones((batch, d), dtype=torch.float32, device=device),
        "m": torch.zeros((batch, d), dtype=torch.float32, device=device),
    }


def _slstm_cell(p, xt, state, H: int):
    """One sLSTM step. xt: (B, 4d) precomputed input projection (f32)."""
    B = xt.shape[0]
    d = xt.shape[1] // 4
    hd = d // H
    hh = state["h"].reshape(B, H, hd)
    rec = torch.einsum("bhi,ghij->gbhj", hh, p["r_zifo"].float()).reshape(4, B, d)
    pre = xt.reshape(B, 4, d).transpose(0, 1) + rec + p["b_zifo"].float()[:, None]
    z_t = torch.tanh(pre[0])
    i_log = pre[1]
    f_log = F.logsigmoid(pre[2])
    o_t = torch.sigmoid(pre[3])
    m_new = torch.maximum(f_log + state["m"], i_log)
    i_p = torch.exp(i_log - m_new)
    f_p = torch.exp(f_log + state["m"] - m_new)
    c_new = f_p * state["c"] + i_p * z_t
    n_new = f_p * state["n"] + i_p
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_ffn(p, y):
    return apply_linear(p["w_down_f"],
                        F.silu(apply_linear(p["w_gate_f"], y)) * apply_linear(p["w_up_f"], y))


def slstm_block(p, x, cfg):
    """x: (B,S,d) -> (y, final_state); a loop over time (inherent recurrence)."""
    B, S, d = x.shape
    xz = (x @ p["w_zifo"]["w"].to(x.dtype)).float()  # (B,S,4d)
    state = slstm_state_init(cfg, B, x.dtype, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, xz[:, t], state, cfg.n_heads)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return y + _slstm_ffn(p, y), state


def slstm_block_step(p, x, cfg, state):
    """Decode step. x: (B,1,d)."""
    xz = (x[:, 0] @ p["w_zifo"]["w"].to(x.dtype)).float()
    st = _slstm_cell(p, xz, state, cfg.n_heads)
    y = st["h"].to(x.dtype)[:, None]
    return y + _slstm_ffn(p, y), st
