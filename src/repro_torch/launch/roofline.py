"""Model counts for roofline analysis: the model-count half of the JAX
package's `launch/roofline.py` (pure Python).

MODEL_FLOPS (useful work): 6*N*D for training, 2*N*D for prefill/decode
(forward only), with N = non-embedding params (+ d*V logits matmul) and
N_active for MoE.  The ratio of measured step time to MODEL_FLOPS / peak is
the model FLOPs utilization (MFU).

The rates are one NVIDIA H100 SXM5 80 GB's, from NVIDIA's H100 data sheet
(https://www.nvidia.com/en-us/data-center/h100/), dense (no sparsity), at
the card's full 700 W power limit.  The dry-run half of the reference's
module (`analyze_cell` onwards) is not ported yet (ROADMAP A9c).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12   # bfloat16 tensor-core FLOP/s, dense, H100 SXM5 80 GB
HBM_BW = 3.35e12      # B/s of HBM3, H100 SXM5 80 GB
# NVLink 4: 900 GB/s per card, the sum over its 18 links of both directions.
LINK_BW = 900e9

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "layer_param_count", "model_param_count",
           "model_flops"]


def layer_param_count(spec, cfg) -> tuple[float, float]:
    """(total, active) params of one layer."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if spec.kind in ("attn", "moe"):
        attn = d * nq * hd * 2 + d * nkv * hd * 2
        if spec.cross_attn:
            attn *= 2
        if spec.kind == "moe":
            total = attn + d * cfg.n_experts + cfg.n_experts * 3 * d * f
            active = attn + d * cfg.n_experts + cfg.top_k * 3 * d * f
            return total, active
        mlp = (3 if not cfg.layer_norm else 2) * d * f if (spec.has_mlp and f) else 0
        n = attn + mlp
        return n, n
    if spec.kind == "rglru":
        r = cfg.lru_width or d
        n = 2 * d * r + 2 * r * r + r * d + (3 * d * f if f else 0)
        return n, n
    if spec.kind == "mlstm":
        di = cfg.d_inner or 2 * d
        n = 2 * d * di + 3 * di * di + di * 2 * cfg.n_heads + di * d
        return n, n
    if spec.kind == "slstm":
        n = 4 * d * d + 4 * d * (d // cfg.n_heads) + 3 * d * (4 * d // 3)
        return n, n
    raise ValueError(spec.kind)


def model_param_count(cfg) -> tuple[float, float]:
    """(N_total, N_active) excluding the embedding gather, including logits."""
    total = active = cfg.d_model * cfg.vocab_size  # logits matmul
    for seg in cfg.segments:
        for spec in seg.unit:
            t, a = layer_param_count(spec, cfg)
            total += t * seg.repeats
            active += a * seg.repeats
    if cfg.family == "encdec":
        t, _ = layer_param_count(
            type(cfg.segments[0].unit[0])(kind="attn", attn_type="bidir"), cfg
        )
        total += t * cfg.n_enc_layers
        active += t * cfg.n_enc_layers
    return total, active


def model_flops(cfg, shape, chips: int) -> float:
    """Useful FLOPs per step per device."""
    _, n_active = model_param_count(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch
        mult = 2.0
    return mult * n_active * tokens / chips
