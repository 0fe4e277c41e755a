"""Batch construction: (shape, dtype) specs and real seeded batches — the
port of the JAX package's `launch/inputs.py`.

Modality frontends are STUBS: `input_specs` provides precomputed frame
embeddings (whisper) / patch embeddings (internvl2) next to the token
stream.  For the VLM the vision tokens occupy the first `vision_tokens`
positions of the sequence, so tokens shrink accordingly and the total
backbone length equals the shape's seq_len.  `make_batch` draws from the
same `np.random.default_rng(seed)` stream as the reference, so tokens and
stub embeddings are the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def batch_dims(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    text_len = shape.seq_len - (cfg.vision_tokens or 0)
    return {"batch": shape.global_batch, "seq": text_len}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``(shape, dtype)`` of every model input of this (arch, shape) cell."""
    B = shape.global_batch
    cdt = getattr(torch, cfg.compute_dtype)
    if shape.mode == "decode":
        return {"tokens": ((B,), torch.int32)}
    d = batch_dims(cfg, shape)
    specs = {"tokens": ((B, d["seq"]), torch.int32)}
    if cfg.family == "encdec":
        specs["enc_embeds"] = ((B, cfg.enc_seq, cfg.d_model), cdt)
    if cfg.family == "vlm":
        specs["vision_embeds"] = ((B, cfg.vision_tokens, cfg.d_model), cdt)
    return specs


def _floats(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    # float64 -> float32 first, as the reference's arrays are canonicalized
    # (no x64), then to the compute dtype.
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    """Real (small) seeded batch on ``device``."""
    rng = np.random.default_rng(seed)
    cdt = getattr(torch, cfg.compute_dtype)
    text_len = seq - (cfg.vision_tokens or 0)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, text_len)).astype(np.int32)).to(device)}
    if cfg.family == "encdec":
        out["enc_embeds"] = _floats(rng.normal(0, 1, (batch, cfg.enc_seq, cfg.d_model)),
                                    cdt, device)
    if cfg.family == "vlm":
        out["vision_embeds"] = _floats(
            rng.normal(0, 1, (batch, cfg.vision_tokens, cfg.d_model)), cdt, device)
    return out
