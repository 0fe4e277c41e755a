"""Config system: model configs, layer programs, input shapes, registry.

A copy of the JAX package's `configs/base.py` (pure Python; the port keeps
its own so that it never imports `repro`).  Every assigned architecture is a
`ModelConfig` whose layer stack is a *program* of segments:
`Segment(unit=(LayerSpec,...), repeats=k)`.  Each segment's parameters are
stacked on a leading ``repeats`` axis, and the port's models loop over that
axis (the reference runs one `lax.scan` over it); heterogeneous stacks
(gemma2 local/global alternation, recurrentgemma 2:1 recurrent:attention,
xlstm mLSTM/sLSTM) are expressed as multi-layer units or multiple segments.
Fields that steer only the reference's compiler (``unroll_layers``,
``seq_shard``, ``decode_cache_axes``) are kept so that configs compare field
for field; they change no value.  ``remat`` and ``remat_policy`` choose what
training keeps for its backward pass (`torch.utils.checkpoint`), also
without changing a value.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str            # "attn" | "moe" | "rglru" | "mlstm" | "slstm"
    attn_type: str = "global"   # "global" | "local" (sliding window) | "bidir"
    has_mlp: bool = True        # attach an FFN (dense) after the mixer
    cross_attn: bool = False    # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class Segment:
    unit: tuple[LayerSpec, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: tuple[Segment, ...]
    head_dim: int | None = None
    window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    use_bias: bool = False         # whisper-style biases + LayerNorm
    layer_norm: bool = False       # LayerNorm instead of RMSNorm
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # hybrid / ssm
    lru_width: int = 0             # rglru recurrence width
    conv_width: int = 4
    d_inner: int = 0               # mlstm inner width (0 -> 2*d_model)
    # enc-dec / vlm frontends (stubs provide precomputed embeddings)
    n_enc_layers: int = 0
    enc_seq: int = 1500            # whisper encoder frames (stub)
    vision_tokens: int = 0         # internvl2 stub patch embeddings
    # positions: "rope" | "sinusoidal" (whisper; param-free)
    pos_type: str = "rope"
    # training
    fsdp: bool = False             # additionally shard big weights on "data"
    remat: bool = True
    # dry-run cost probes: fully unroll layer scans so XLA cost_analysis sees
    # every layer (while-loop bodies are otherwise counted once)
    unroll_layers: bool = False
    # Megatron-style sequence parallelism: shard the residual stream's seq
    # axis on "model" between blocks (norms/elementwise run on S/TP tokens;
    # GSPMD turns TP psums into bf16 all-gather + reduce-scatter pairs)
    seq_shard: bool = False
    # remat policy for the layer scan: "full" (recompute everything) or
    # "dots" (save matmul outputs, recompute elementwise only)
    remat_policy: str = "full"
    # decode KV-cache write: "dus" (dynamic_update_slice; GSPMD gathers a
    # seq-sharded cache at a traced index) or "masked" (iota==pos select;
    # stays local per shard — trades a full-cache HBM write for zero comm)
    cache_update: str = "dus"
    # map the "model" mesh axis to extra data parallelism (no TP): the right
    # posture for small models where TP activation psums dominate
    pure_dp: bool = False
    # mesh axes holding the decode KV-cache sequence dim; pins attention
    # intermediates to the cache layout so GSPMD never rematerializes the
    # cache (flash-decode partial-softmax combine instead)
    decode_cache_axes: tuple | None = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale_segments = []
        for seg in self.segments:
            scale_segments.append(Segment(unit=seg.unit, repeats=min(seg.repeats, 1)))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            window=32,
            segments=tuple(scale_segments),
            n_layers=sum(len(s.unit) * min(s.repeats, 1) for s in self.segments),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            lru_width=64 if self.lru_width else 0,
            d_inner=128 if self.family == "ssm" else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.n_enc_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            fsdp=False,
            capacity_factor=8.0,       # no token drops -> decode == train math
            compute_dtype="float32",   # exactness for equivalence tests
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs with sub-quadratic attention (or O(1) state) that run long_500k.
LONG_CONTEXT_ARCHS = {
    "mixtral-8x7b", "mixtral-8x22b", "gemma2-9b", "recurrentgemma-9b", "xlstm-125m",
}

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import the module to trigger registration
        import importlib

        importlib.import_module(
            f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}"
        )
    return _REGISTRY[name]()


def all_arch_names() -> list[str]:
    return [
        "whisper-small", "internvl2-26b", "mixtral-8x7b", "mixtral-8x22b",
        "internlm2-1.8b", "qwen3-1.7b", "minicpm-2b", "gemma2-9b",
        "recurrentgemma-9b", "xlstm-125m",
    ]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring the long_500k applicability rule."""
    out = []
    for arch in all_arch_names():
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out
