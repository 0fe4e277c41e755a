"""CRC-32 of rows of bytes: hand-written CUDA kernel + wrapper.

No TPU kernel stands behind this one: it is the graph stage `crc32_bytes` of
the JAX package (src/repro/kernels/ops.py, a `lax.scan` of slice-by-8
steps), which eager PyTorch could only run as a Python loop.  The kernel
source, its design and what bounds it on the card are described at the top
of `csrc/crc32.cu`; the plain PyTorch version (chunk registers and a
level-by-level combine, vectorized over rows and chunks) is `ref.crc32_ref`,
re-exported here as `crc32_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import crc32_ref as crc32_plain

__all__ = ["crc32", "crc32_plain", "launches", "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()

_SPAN = 65536  # bytes per CTA (csrc/crc32.cu)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = _build.load("crc32")
    fn = lib.crc32_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def crc32(data: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """CRC-32 (== ``binascii.crc32``) of ``data[m, :n[m]]`` for every row.

    data : (M, K) uint8;  n : (M,) int32 with 0 <= n <= K.
    Returns (M,) int64 holding the unsigned CRC, equal to `crc32_plain`.
    """
    if data.dim() != 2 or n.shape != (data.shape[0],):
        raise ValueError(f"expected data (M, K) and n (M,), got "
                         f"{tuple(data.shape)} and {tuple(n.shape)}")
    if data.dtype != torch.uint8 or n.dtype != torch.int32:
        raise TypeError(f"expected uint8 data and int32 n, got {data.dtype} "
                        f"and {n.dtype}")
    dev = data.device
    if n.device != dev:
        raise ValueError("data and n must live on the same device")
    if dev.type == "cpu":
        return crc32_plain(data, n)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    M, K = data.shape
    if M > 65535:
        raise ValueError(f"the CUDA kernel takes at most 65535 rows, got {M}")
    if not (data.is_contiguous() and n.is_contiguous()):
        raise ValueError("data and n must be contiguous")
    out = torch.empty((M,), dtype=torch.int64, device=dev)
    if M == 0:
        return out
    G = max(1, -(-K // _SPAN))
    part_r = torch.empty((M * G,), dtype=torch.int32, device=dev)
    part_len = torch.empty((M * G,), dtype=torch.int64, device=dev)
    ticket = torch.zeros((M,), dtype=torch.int32, device=dev)
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(data.data_ptr(), n.data_ptr(), out.data_ptr(),
                 part_r.data_ptr(), part_len.data_ptr(), ticket.data_ptr(),
                 M, K, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "crc32")
    launches += 1
    return out
