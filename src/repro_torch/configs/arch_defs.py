"""The ten assigned architectures, exactly as specified (one factory each);
a copy of the JAX package's `configs/arch_defs.py`.

Sources are cited in the assignment; layer programs (segments) encode the
per-arch heterogeneity: gemma2 local/global alternation, recurrentgemma
2-recurrent:1-attention, xlstm mLSTM/sLSTM alternation, mixtral SWA+MoE.
Individual modules (`repro_torch.configs.<arch>`) re-export from here so
`--arch <id>` resolves via the registry.
"""
from __future__ import annotations

from .base import LayerSpec, ModelConfig, Segment, register

_ATTN = LayerSpec(kind="attn", attn_type="global")
_SWA = LayerSpec(kind="attn", attn_type="local")
_MOE_SWA = LayerSpec(kind="moe", attn_type="local")
_RGLRU = LayerSpec(kind="rglru")
_MLSTM = LayerSpec(kind="mlstm", has_mlp=False)
_SLSTM = LayerSpec(kind="slstm", has_mlp=False)


@register("whisper-small")
def whisper_small() -> ModelConfig:
    # [arXiv:2212.04356] enc-dec; conv frontend is a stub (input_specs provides
    # precomputed frame embeddings). Sinusoidal positions; LayerNorm + biases.
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        segments=(Segment((LayerSpec(kind="attn", attn_type="global", cross_attn=True),), 12),),
        n_enc_layers=12,
        enc_seq=1500,
        use_bias=True,
        layer_norm=True,
        pos_type="sinusoidal",
        tie_embeddings=True,
        fsdp=False,
    )


@register("internvl2-26b")
def internvl2_26b() -> ModelConfig:
    # [arXiv:2404.16821] InternViT frontend stubbed (256 patch embeddings
    # prepended); backbone is the InternLM2-20B-style decoder.
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        segments=(Segment((_ATTN,), 48),),
        vision_tokens=256,
        rope_theta=1e6,
        fsdp=True,
    )


@register("mixtral-8x7b")
def mixtral_8x7b() -> ModelConfig:
    # [arXiv:2401.04088] 8 experts, top-2, sliding-window attention.
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        segments=(Segment((_MOE_SWA,), 32),),
        n_experts=8,
        top_k=2,
        window=4096,
        rope_theta=1e6,
        fsdp=True,
        tie_embeddings=False,
    )


@register("mixtral-8x22b")
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        segments=(Segment((_MOE_SWA,), 56),),
        n_experts=8,
        top_k=2,
        window=4096,
        rope_theta=1e6,
        fsdp=True,
        tie_embeddings=False,
    )


@register("internlm2-1.8b")
def internlm2_1_8b() -> ModelConfig:
    # [arXiv:2403.17297] llama-like GQA.
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        segments=(Segment((_ATTN,), 24),),
        rope_theta=1e6,
        fsdp=True,
        tie_embeddings=False,
    )


@register("qwen3-1.7b")
def qwen3_1_7b() -> ModelConfig:
    # [hf:Qwen/Qwen3-*] qk_norm, GQA, head_dim 128.
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        vocab_size=151936,
        segments=(Segment((_ATTN,), 28),),
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        fsdp=True,
    )


@register("minicpm-2b")
def minicpm_2b() -> ModelConfig:
    # [arXiv:2404.06395] llama-like MHA (kv=36); trained with WSD schedule.
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        segments=(Segment((_ATTN,), 40),),
        fsdp=True,
    )


@register("gemma2-9b")
def gemma2_9b() -> ModelConfig:
    # [arXiv:2408.00118] alternating local(4096)/global, logit softcaps,
    # head_dim 256, sandwich norms.
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=256000,
        segments=(Segment((_SWA, _ATTN), 21),),
        head_dim=256,
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        fsdp=True,
    )


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    # [arXiv:2402.19427] Griffin: (RG-LRU, RG-LRU, local-attn) repeating;
    # 38 layers = 12 full triples + one trailing recurrent pair. MQA (kv=1).
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        segments=(
            Segment((_RGLRU, _RGLRU, _SWA), 12),
            Segment((_RGLRU, _RGLRU), 1),
        ),
        lru_width=4096,
        window=2048,
        fsdp=True,
    )


@register("xlstm-125m")
def xlstm_125m() -> ModelConfig:
    # [arXiv:2405.04517] alternating mLSTM/sLSTM blocks; no separate FFN
    # (d_ff=0): the blocks carry their own up/down projections.
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        segments=(Segment((_MLSTM, _SLSTM), 6),),
        d_inner=1536,
        fsdp=False,
    )
