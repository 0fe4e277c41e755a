"""Single-match window select: hand-written CUDA kernel + wrapper.

No TPU kernel stands behind this one: it is the graph stage
`_select_sequential` of the JAX package (src/repro/core/jax_compressor.py,
a `lax.scan` over the windows), which eager PyTorch could only run as a
Python loop of W steps per micro-batch.  The kernel source, its design and
what bounds it on the card are described at the top of
`csrc/window_select.cu`; the plain PyTorch version (that Python loop) is
`ref.window_select_ref`, re-exported here as `window_select_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import window_select_ref as window_select_plain

__all__ = ["window_select", "window_select_plain", "launches",
           "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = _build.load("window_select")
    fn = lib.window_select_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def window_select(valid: torch.Tensor, lengths: torch.Tensor, pws: int):
    """Earliest eligible match per window, free pointer carried in order.

    valid   : (M, P) bool or uint8 — position carries a usable match
    lengths : (M, P) int32 — match length per position
    pws     : window size; P % pws == 0

    Returns ``(emit (M, W) bool, pos (M, W) int32, length (M, W) int32)``
    with W = P // pws, equal to `window_select_plain`.
    """
    if valid.dim() != 2 or valid.shape != lengths.shape:
        raise ValueError(f"expected valid and lengths of one shape (M, P), got "
                         f"{tuple(valid.shape)} and {tuple(lengths.shape)}")
    if valid.dtype not in (torch.bool, torch.uint8) or lengths.dtype != torch.int32:
        raise TypeError(f"expected bool/uint8 valid and int32 lengths, got "
                        f"{valid.dtype} and {lengths.dtype}")
    M, P = valid.shape
    if pws < 1 or P % pws:
        raise ValueError(f"pws={pws} must divide P={P}")
    if valid.device != lengths.device:
        raise ValueError("valid and lengths must live on the same device")
    dev = valid.device
    if dev.type == "cpu":
        return window_select_plain(valid, lengths, pws)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    if pws & (pws - 1) or pws > 2048:
        raise ValueError(f"the CUDA kernel takes a power-of-two pws <= 2048, "
                         f"got {pws}")
    if not (valid.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("valid and lengths must be contiguous")
    W = P // pws
    emit = torch.empty((M, W), dtype=torch.bool, device=dev)
    pos = torch.empty((M, W), dtype=torch.int32, device=dev)
    length = torch.empty((M, W), dtype=torch.int32, device=dev)
    if M == 0 or W == 0:
        return emit, pos, length
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(valid.data_ptr(), lengths.data_ptr(), emit.data_ptr(),
                 pos.data_ptr(), length.data_ptr(), M, P, pws,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "window_select")
    launches += 1
    return emit, pos, length
