"""`repro_torch` — the PyTorch/CUDA port of the LZ4 accelerator reproduction.

A second package beside the JAX reference (`repro`), for an NVIDIA H100:
plain tensor code is PyTorch, and every kernel the reference wrote in Pallas
for a TPU is a hand-written CUDA kernel here (`csrc/*.cu`, built at first use
by `kernels/_build.py`).  The package imports `torch`, `numpy` and the
standard library only — never `jax`, never anything of `repro`.

Ported so far: the write path, `core.engine.LZ4Engine.compress` -> frame,
through the fused datapath (the default) or the staged one
(``candidate_impl="sort"|"sortkey"|"scatter"``); the read path,
`core.decode_engine.LZ4DecodeEngine` (frame -> bytes on the host or a uint8
tensor on the card, `FrameReader` for random access); and the NumPy golden
models and host oracles (`core.reference`, `core.schemes`, `core.encoder`,
`core.cycle_model`).

    from repro_torch import LZ4Engine, LZ4DecodeEngine
    frame = LZ4Engine().compress(data)              # on the card
    frame = LZ4Engine(device="cpu").compress(data)  # kernels' plain versions
    dev = LZ4DecodeEngine(plan_on_device=True).decode_to_device(frame)

Entry points run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import shutil

import torch

from .core.decode_engine import (  # noqa: F401
    DecodeStats,
    FrameReader,
    LZ4DecodeEngine,
    default_decode_engine,
)
from .core.engine import EngineStats, LZ4Engine, default_engine  # noqa: F401
from .core.frame import (  # noqa: F401
    FrameFormatError,
    decode_frame,
    decode_frame_serial,
    encode_frame,
    frame_info,
)

__all__ = [
    "LZ4Engine", "EngineStats", "default_engine", "LZ4DecodeEngine",
    "DecodeStats", "FrameReader", "default_decode_engine", "FrameFormatError",
    "decode_frame", "decode_frame_serial", "encode_frame", "frame_info",
    "probe",
]


def probe() -> dict:
    """What this process can run: torch build, CUDA device, compiler.

    Never raises for a missing device or compiler — it reports them.
    """
    from .kernels import _build

    cuda = torch.cuda.is_available()
    info = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": None,
        "compute_capability": None,
        "nvcc_on_path": shutil.which("nvcc") is not None,
        "nvcc": _build.find_nvcc(),
    }
    if cuda:
        info["device_name"] = torch.cuda.get_device_name(0)
        info["compute_capability"] = list(torch.cuda.get_device_capability(0))
    return info
