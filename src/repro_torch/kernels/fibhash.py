"""Word + Fibonacci hash per position: hand-written CUDA kernel + wrapper.

Replaces the TPU kernel `fibhash_pallas` / `_fibhash_kernel`
(src/repro/kernels/fibhash.py).  The kernel source, its design and what
bounds it on the card are described at the top of `csrc/fibhash.cu`; the
plain PyTorch version is `ref.fibhash_ref` over the row's four shifted byte
views, wrapped here as `fibhash_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import fibhash_ref

__all__ = ["fibhash", "fibhash_plain", "launches", "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def fibhash_plain(blocks_u8: torch.Tensor, positions: int, hash_bits: int):
    """Plain version of `fibhash`: `ref.fibhash_ref` on shifted row views."""
    P = positions
    return fibhash_ref(blocks_u8[:, :P], blocks_u8[:, 1: P + 1],
                       blocks_u8[:, 2: P + 2], blocks_u8[:, 3: P + 3],
                       hash_bits)


def _lib():
    lib = _build.load("fibhash")
    fn = lib.fibhash_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fibhash(blocks_u8: torch.Tensor, positions: int, hash_bits: int = 8):
    """Little-endian word and Fibonacci hash at positions 0..P-1 of each row.

    blocks_u8 : (M, B) uint8, contiguous
    positions : position count P, 0 <= P <= B - 3 (each word reads p..p+3)
    hash_bits : 1..32

    Returns ``(words, hashes)``, both (M, P) int32: the word as the bit
    pattern of its uint32 value, the hash in [0, 2^hash_bits) — elementwise
    equal to `fibhash_plain`.
    """
    if blocks_u8.dim() != 2:
        raise ValueError(f"expected blocks (M, B), got {tuple(blocks_u8.shape)}")
    if blocks_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 blocks, got {blocks_u8.dtype}")
    M, B = blocks_u8.shape
    P = positions
    if not 0 <= P <= B - 3:
        raise ValueError(f"need 0 <= positions <= B - 3; got positions={P}, B={B}")
    if not 1 <= hash_bits <= 32:
        raise ValueError(f"need 1 <= hash_bits <= 32, got {hash_bits}")
    dev = blocks_u8.device
    if dev.type == "cpu":
        return fibhash_plain(blocks_u8, P, hash_bits)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    if not blocks_u8.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if M > 65535:
        raise ValueError(f"the CUDA kernel takes M <= 65535 rows, got {M}")
    words = torch.empty((M, P), dtype=torch.int32, device=dev)
    hashes = torch.empty((M, P), dtype=torch.int32, device=dev)
    if M == 0 or P == 0:
        return words, hashes
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(blocks_u8.data_ptr(), words.data_ptr(), hashes.data_ptr(),
                 M, B, P, hash_bits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "fibhash")
    launches += 1
    return words, hashes
