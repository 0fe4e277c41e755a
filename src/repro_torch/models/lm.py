"""Model assembly: layer programs -> init / train loss / forward / prefill /
decode — the port of the JAX package's `models/lm.py`.

Parameters are the reference's tree: every leaf under
``segments/<i>/layers/<j>`` is STACKED on a leading ``repeats`` axis (the
reference builds it with `jax.vmap` and runs it with `lax.scan`), so that
checkpoints, offload blobs and sharding specs line up leaf for leaf.  The
port loops over that axis in Python and indexes the stacked leaves.  The
decode cache is stacked the same way.  Families:

  dense/moe/vlm : decoder-only causal LM (vlm prepends stub patch embeddings)
  encdec        : whisper — bidirectional encoder over stub frame embeddings,
                  causal decoder with per-layer cross attention
  hybrid/ssm    : recurrent mixers (RG-LRU, mLSTM, sLSTM) via recurrent.py

Every function computes on the device its parameters are on; there is no
``torch.compile`` and no CUDA graph.  `train_loss` is differentiable (the
gradient is autograd's); where ``cfg.remat`` is set its blocks run under
`torch.utils.checkpoint`, the reference's `jax.checkpoint`, which changes
what is kept for the backward pass and no value.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch._tree import flatten, unflatten
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment
from repro_torch.distributed.sharding import constrain_batch

from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from .layers import (
    _init,
    apply_mlp,
    apply_norm,
    cross_entropy_chunked,
    mlp_init,
    norm_init,
    sinusoidal_positions,
    softcap,
)

__all__ = ["init_params", "train_loss", "forward_logits", "init_cache", "prefill",
           "decode_step"]


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device):
    p = {}
    ln = cfg.layer_norm
    if spec.kind in ("attn", "moe"):
        p["ln1"] = norm_init(cfg.d_model, ln, dtype, device)
        p["attn"] = attn.attention_init(gen, cfg, dtype=dtype, device=device)
        if cfg.final_softcap is not None:  # gemma2 sandwich norms
            p["ln1_post"] = norm_init(cfg.d_model, ln, dtype, device)
        if spec.cross_attn:
            p["ln_cross"] = norm_init(cfg.d_model, ln, dtype, device)
            p["cross"] = attn.attention_init(gen, cfg, dtype=dtype, device=device)
        if spec.kind == "moe":
            p["ln2"] = norm_init(cfg.d_model, ln, dtype, device)
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device)
        elif spec.has_mlp and cfg.d_ff:
            p["ln2"] = norm_init(cfg.d_model, ln, dtype, device)
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.use_bias,
                                gated=not cfg.layer_norm, dtype=dtype, device=device)
            if cfg.final_softcap is not None:
                p["ln2_post"] = norm_init(cfg.d_model, ln, dtype, device)
    elif spec.kind == "rglru":
        p["ln1"] = norm_init(cfg.d_model, ln, dtype, device)
        p["mixer"] = rec.rglru_init(gen, cfg, dtype, device)
        if spec.has_mlp and cfg.d_ff:
            p["ln2"] = norm_init(cfg.d_model, ln, dtype, device)
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.use_bias,
                                gated=True, dtype=dtype, device=device)
    elif spec.kind == "mlstm":
        p["ln1"] = norm_init(cfg.d_model, ln, dtype, device)
        p["mixer"] = rec.mlstm_init(gen, cfg, dtype, device)
    elif spec.kind == "slstm":
        p["ln1"] = norm_init(cfg.d_model, ln, dtype, device)
        p["mixer"] = rec.slstm_init(gen, cfg, dtype, device)
    else:
        raise ValueError(spec.kind)
    return p


def _stack(trees):
    """Trees of equal structure -> one tree, leaves stacked on a new axis 0
    (what `jax.vmap` of an init gives)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    if first is None:
        return None
    return torch.stack(trees)


def _stacked_init(gen, unit, repeats, cfg, dtype, device):
    return _stack([{str(j): _layer_init(gen, spec, cfg, dtype, device)
                    for j, spec in enumerate(unit)} for _ in range(repeats)])


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype=None, device="cuda"):
    """The reference's parameter tree (structure, shapes, dtypes, init
    scales) drawn from ``generator`` (its device draws; leaves land on
    ``device``).  On ``device="meta"`` no generator is needed and the tree
    is the shape tree `jax.eval_shape` gives the reference."""
    dtype = _dtype(dtype or cfg.param_dtype)
    device = torch.device(device)
    if generator is None and device.type != "meta":
        raise ValueError("init_params needs a torch.Generator unless device='meta'")
    gen = generator
    params = {
        "embed": _init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02, dtype=dtype,
                       device=device),
        "final_norm": norm_init(cfg.d_model, cfg.layer_norm, dtype, device),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _init(gen, (cfg.d_model, cfg.vocab_size), scale=0.02,
                                  dtype=dtype, device=device)
    for seg in cfg.segments:
        params["segments"].append(
            {"layers": _stacked_init(gen, seg.unit, seg.repeats, cfg, dtype, device)})
    if cfg.family == "encdec":
        params["enc_segments"] = [{"layers": _stacked_init(
            gen, (LayerSpec(kind="attn", attn_type="bidir"),), cfg.n_enc_layers,
            cfg, dtype, device)}]
        params["enc_final_norm"] = norm_init(cfg.d_model, cfg.layer_norm, dtype, device)
    if cfg.family == "vlm":
        params["vision_adapter"] = _init(gen, (cfg.d_model, cfg.d_model), scale=0.02,
                                         dtype=dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# Forward blocks
# ---------------------------------------------------------------------------

def _apply_block(p, x, spec: LayerSpec, cfg: ModelConfig, memory, positions):
    """One layer forward (train/prefill). Returns (x, aux, cache_entries)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {}
    eps, ln = cfg.norm_eps, cfg.layer_norm
    if spec.kind in ("attn", "moe"):
        h = apply_norm(p["ln1"], x, eps, ln)
        y, (k, v) = attn.multihead_attention(p["attn"], h, cfg, spec.attn_type,
                                             positions=positions)
        if "ln1_post" in p:
            y = apply_norm(p["ln1_post"], y, eps, ln)
        x = x + y
        cache["k"], cache["v"] = k, v
        if spec.cross_attn and memory is not None:
            h = apply_norm(p["ln_cross"], x, eps, ln)
            y, (ck, cv) = attn.multihead_attention(p["cross"], h, cfg, "bidir",
                                                   memory=memory)
            x = x + y
            cache["cross_k"], cache["cross_v"] = ck, cv
        if spec.kind == "moe":
            h = apply_norm(p["ln2"], x, eps, ln)
            y, aux = moe_mod.moe_ffn(p["moe"], h, cfg)
            x = x + y
        elif "mlp" in p:
            h = apply_norm(p["ln2"], x, eps, ln)
            y = apply_mlp(p["mlp"], h)
            if "ln2_post" in p:
                y = apply_norm(p["ln2_post"], y, eps, ln)
            x = x + y
    elif spec.kind == "rglru":
        h = apply_norm(p["ln1"], x, eps, ln)
        y, cache = rec.rglru_block(p["mixer"], h, cfg)
        x = x + y
        if "mlp" in p:
            h = apply_norm(p["ln2"], x, eps, ln)
            x = x + apply_mlp(p["mlp"], h)
    elif spec.kind == "mlstm":
        h = apply_norm(p["ln1"], x, eps, ln)
        y, cache = rec.mlstm_block(p["mixer"], h, cfg)
        x = x + y
    elif spec.kind == "slstm":
        h = apply_norm(p["ln1"], x, eps, ln)
        y, cache = rec.slstm_block(p["mixer"], h, cfg)
        x = x + y
    return constrain_batch(x, cfg.seq_shard, cfg.pure_dp), aux, cache


def _layers(stacked, repeats: int) -> list:
    """Every repeat of a stacked tree (views, no copy).  One `unbind` per
    leaf: its gradient is one stack of the repeats' gradients, where
    indexing each repeat would add ``repeats`` full-size gradients."""
    leaves, treedef = flatten(stacked)
    cols = [t.unbind(0) for t in leaves]
    return [unflatten(treedef, [c[r] for c in cols]) for r in range(repeats)]


def _save_weight_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of 2-D matrix products (the
    weight products, `jax.checkpoint_policies.dots_with_no_batch_dims_saveable`)
    and recompute the rest, batched attention products included."""
    if op == torch.ops.aten.mm.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(p, x, spec, cfg, memory, positions):
    """`_apply_block` under `torch.utils.checkpoint`, returning only
    ``(x, aux)``: the block's (k, v) cache entries are not kept alive."""
    def block(p, x, memory, positions):
        x, aux, _ = _apply_block(p, x, spec, cfg, memory, positions)
        return x, aux

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_weight_products)
    return _ckpt.checkpoint(block, p, x, memory, positions, use_reentrant=False, **kw)


def _run_segments(params_segs, segments, x, cfg, memory, positions, collect_cache=False):
    """Run all segments, repeat by repeat; optionally collect prefill caches
    (leaves stacked on repeats, as the reference's scan outputs).  With
    ``cfg.remat`` and autograd recording (training), each block runs under
    `_remat_block`."""
    remat = cfg.remat and not collect_cache and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for seg_params, seg in zip(params_segs, segments):
        ys = []
        for layer_p in _layers(seg_params["layers"], seg.repeats):
            entries = {}
            for j, spec in enumerate(seg.unit):
                if remat:
                    x, a = _remat_block(layer_p[str(j)], x, spec, cfg, memory, positions)
                else:
                    x, a, entries[str(j)] = _apply_block(layer_p[str(j)], x, spec, cfg,
                                                         memory, positions)
                aux_total = aux_total + a
            if collect_cache:
                ys.append(entries)
        caches.append(_stack(ys) if collect_cache else None)
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def _take_rows(table, idx):
    """``jnp.take(table, idx, axis=0)``: negative ids count from the end, and
    ids outside [-V, V) give rows of NaN (`torch.embedding` would raise)."""
    V = table.shape[0]
    idx = idx.long()
    ok = (idx >= -V) & (idx < V)
    rows = table[torch.where(idx < 0, idx + V, idx).clamp(0, V - 1)]
    return torch.where(ok[..., None], rows, torch.full_like(rows, float("nan")))


def _embed_tokens(params, tokens, cfg):
    x = _take_rows(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    if cfg.pos_type == "sinusoidal":
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                     device=x.device).to(x.dtype)[None]
    return x


def _logits_fn(params, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]

    def fn(xc):
        logits = xc @ w.to(xc.dtype)
        return softcap(logits.float(), cfg.final_softcap)

    return fn


def _assemble_inputs(params, batch, cfg):
    """tokens (+ stub frontend embeddings) -> (x, labels, mask, memory)."""
    cdt = _dtype(cfg.compute_dtype)
    tokens = batch["tokens"]
    dev = params["embed"].device
    memory = None
    if cfg.family == "encdec":
        enc = batch["enc_embeds"].to(cdt)
        enc = enc + sinusoidal_positions(enc.shape[1], cfg.d_model, device=dev).to(cdt)[None]
        memory = enc
    x = _embed_tokens(params, tokens, cfg)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
    mask[:, -1] = 0.0
    if cfg.family == "vlm":
        vis = batch["vision_embeds"].to(cdt) @ params["vision_adapter"].to(cdt)
        x = torch.cat([vis, x], dim=1)
        V = vis.shape[1]
        labels = torch.cat([torch.zeros((x.shape[0], V), dtype=labels.dtype, device=dev),
                            labels], dim=1)
        mask = torch.cat([torch.zeros((x.shape[0], V), dtype=torch.float32, device=dev),
                          mask], dim=1)
    return constrain_batch(x, pure_dp=cfg.pure_dp), labels, mask, memory


def _run_encoder(params, memory, cfg):
    if memory is None:
        return None, torch.zeros((), dtype=torch.float32, device=params["embed"].device)
    seg = Segment((LayerSpec(kind="attn", attn_type="bidir"),), cfg.n_enc_layers)
    m, aux, _ = _run_segments(params["enc_segments"], [seg], memory, cfg, None, None)
    m = apply_norm(params["enc_final_norm"], m, cfg.norm_eps, cfg.layer_norm)
    return m, aux


# ---------------------------------------------------------------------------
# Train / forward
# ---------------------------------------------------------------------------

def train_loss(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy plus 0.01 x the MoE auxiliary losses,
    as a 0-d float32 tensor that autograd differentiates."""
    x, labels, mask, memory = _assemble_inputs(params, batch, cfg)
    memory, enc_aux = _run_encoder(params, memory, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux, _ = _run_segments(params["segments"], cfg.segments, x, cfg, memory, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.layer_norm)
    ce = cross_entropy_chunked(_logits_fn(params, cfg), x, labels, mask, cfg.vocab_size)
    return ce + 0.01 * (aux + enc_aux)


@torch.no_grad()
def forward_logits(params, batch, cfg: ModelConfig):
    """Full-sequence logits (small models / tests only)."""
    x, _, _, memory = _assemble_inputs(params, batch, cfg)
    memory, _ = _run_encoder(params, memory, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, _ = _run_segments(params["segments"], cfg.segments, x, cfg, memory, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.layer_norm)
    return _logits_fn(params, cfg)(x)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _empty_layer_cache(spec: LayerSpec, cfg, batch, cache_len, dtype, device):
    c = {}
    if spec.kind in ("attn", "moe"):
        c = attn.make_cache(cfg, spec.attn_type, batch, cache_len, dtype, device)
        if spec.cross_attn:
            shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
            c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    elif spec.kind == "rglru":
        c = rec.rglru_state_init(cfg, batch, dtype, device)
    elif spec.kind == "mlstm":
        c = rec.mlstm_state_init(cfg, batch, dtype, device)
    elif spec.kind == "slstm":
        c = rec.slstm_state_init(cfg, batch, dtype, device)
    return c


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, device="cuda"):
    """Empty decode cache mirroring the segment structure (stacked on repeats)."""
    dtype = _dtype(dtype or cfg.compute_dtype)
    caches = [_stack([{str(j): _empty_layer_cache(spec, cfg, batch, cache_len, dtype, device)
                       for j, spec in enumerate(seg.unit)} for _ in range(seg.repeats)])
              for seg in cfg.segments]
    return {"layers": caches, "enc_memory": None,
            "pos": torch.tensor(0, dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig, cache_len: int):
    """Run the prompt; returns (cache, last-token logits)."""
    x, _, _, memory = _assemble_inputs(params, batch, cfg)
    memory, _ = _run_encoder(params, memory, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    x, _, raw_caches = _run_segments(
        params["segments"], cfg.segments, x, cfg, memory, positions, collect_cache=True)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.layer_norm)
    logits = _logits_fn(params, cfg)(x[:, -1])
    # build decode caches from the collected K/V
    cache = init_cache(cfg, x.shape[0], cache_len, cfg.compute_dtype, x.device)
    for si, (seg, ys) in enumerate(zip(cfg.segments, raw_caches)):
        for j, spec in enumerate(seg.unit):
            entry = cache["layers"][si][str(j)]
            got = ys[str(j)]  # leaves stacked (repeats, B, S, ...)
            if spec.kind in ("attn", "moe"):
                filled = _stack([attn.fill_cache(
                    {"k": entry["k"][r], "v": entry["v"][r], "pos": entry["pos"][r]},
                    got["k"][r], got["v"][r], 0) for r in range(seg.repeats)])
                entry = {**entry, **filled}
                if spec.cross_attn:
                    entry["cross_k"] = got["cross_k"]
                    entry["cross_v"] = got["cross_v"]
            else:  # recurrent: the collected final state IS the decode state
                entry = got
            cache["layers"][si][str(j)] = entry
    cache["enc_memory"] = memory
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return cache, logits


def _decode_layer(pj, cj, xx, spec: LayerSpec, cfg, pos: int):
    """One layer of one decode step. Returns (x, the layer's new cache)."""
    eps, ln = cfg.norm_eps, cfg.layer_norm
    if spec.kind in ("attn", "moe"):
        h = apply_norm(pj["ln1"], xx, eps, ln)
        y, upd = attn.decode_attention(pj["attn"], h, cfg,
                                       {"k": cj["k"], "v": cj["v"], "pos": cj["pos"]},
                                       pos, spec.attn_type)
        if "ln1_post" in pj:
            y = apply_norm(pj["ln1_post"], y, eps, ln)
        xx = xx + y
        new_c = {**cj, **upd}
        if spec.cross_attn:
            h = apply_norm(pj["ln_cross"], xx, eps, ln)
            y, _ = attn.decode_attention(pj["cross"], h, cfg, None, pos, "bidir",
                                         memory_cache={"k": cj["cross_k"], "v": cj["cross_v"]})
            xx = xx + y
        if spec.kind == "moe":
            h = apply_norm(pj["ln2"], xx, eps, ln)
            y, _ = moe_mod.moe_ffn(pj["moe"], h, cfg)
            xx = xx + y
        elif "mlp" in pj:
            h = apply_norm(pj["ln2"], xx, eps, ln)
            y = apply_mlp(pj["mlp"], h)
            if "ln2_post" in pj:
                y = apply_norm(pj["ln2_post"], y, eps, ln)
            xx = xx + y
        return xx, new_c
    h = apply_norm(pj["ln1"], xx, eps, ln)
    if spec.kind == "rglru":
        y, st = rec.rglru_step(pj["mixer"], h, cfg, cj)
        xx = xx + y
        if "mlp" in pj:
            xx = xx + apply_mlp(pj["mlp"], apply_norm(pj["ln2"], xx, eps, ln))
    elif spec.kind == "mlstm":
        y, st = rec.mlstm_block_step(pj["mixer"], h, cfg, cj)
        xx = xx + y
    else:  # slstm
        y, st = rec.slstm_block_step(pj["mixer"], h, cfg, cj)
        xx = xx + y
    return xx, st


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B,) int; pos: int or 0-d tensor (one host
    read). -> (logits (B,V), new cache); ``cache`` is not modified."""
    pos = int(pos)
    cdt = _dtype(cfg.compute_dtype)
    x = _take_rows(params["embed"], tokens[:, None]).to(cdt)
    if cfg.pos_type == "sinusoidal":
        x = x + sinusoidal_positions(1, cfg.d_model, offset=pos,
                                     device=x.device).to(cdt)[None]
    memory = cache.get("enc_memory")

    new_layers = []
    for si, seg in enumerate(cfg.segments):
        ys = []
        for layer_p, layer_c in zip(_layers(params["segments"][si]["layers"], seg.repeats),
                                    _layers(cache["layers"][si], seg.repeats)):
            new_c = {}
            for j, spec in enumerate(seg.unit):
                x, new_c[str(j)] = _decode_layer(layer_p[str(j)], layer_c[str(j)], x,
                                                 spec, cfg, pos)
            ys.append(new_c)
        new_layers.append(_stack(ys))

    x = apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.layer_norm)
    logits = _logits_fn(params, cfg)(x[:, 0])
    new_cache = {"layers": new_layers, "enc_memory": memory,
                 "pos": torch.tensor(pos + 1, dtype=torch.int32, device=x.device)}
    return logits, new_cache
