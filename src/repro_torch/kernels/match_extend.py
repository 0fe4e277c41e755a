"""Bounded match extension (S2): hand-written CUDA kernel + wrapper.

Replaces the TPU kernel `match_extend_pallas` / `_match_extend_kernel`
(src/repro/kernels/match_extend.py).  The kernel source, its design and
what bounds it on the card are described at the top of
`csrc/match_extend.cu`; the plain PyTorch version is `ref.match_extend_ref`,
re-exported here as `match_extend_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.lz4_types import MIN_MATCH

from . import _build
from .ref import match_extend_ref as match_extend_plain

__all__ = ["match_extend", "match_extend_plain", "launches", "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = _build.load("match_extend")
    fn = lib.match_extend_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def match_extend(blocks_u8: torch.Tensor, cand: torch.Tensor,
                 valid: torch.Tensor, ns: torch.Tensor, max_match: int = 36):
    """Full bounded match length per position.

    blocks_u8 : (M, B) uint8, contiguous, B >= 1
    cand      : (M, P) int32 candidate per position (any value where ~valid:
                every read is clamped to the row, as in the plain version)
    valid     : (M, P) bool or uint8 — 4-byte match already confirmed at p
    ns        : (M,) int32 true block lengths
    max_match : the match-length cap, >= 4

    Returns (M, P) int32: 0 where ~valid, else 4 + the extension, capped by
    max_match and by the end-of-block rule (match end <= n - 5) — elementwise
    equal to `match_extend_plain`.
    """
    if (blocks_u8.dim() != 2 or cand.dim() != 2 or valid.shape != cand.shape
            or ns.dim() != 1 or not (blocks_u8.shape[0] == cand.shape[0]
                                     == ns.shape[0])):
        raise ValueError(
            f"expected blocks (M, B), cand and valid (M, P), ns (M,); got "
            f"{tuple(blocks_u8.shape)}, {tuple(cand.shape)}, "
            f"{tuple(valid.shape)}, {tuple(ns.shape)}")
    if (blocks_u8.dtype != torch.uint8 or cand.dtype != torch.int32
            or valid.dtype not in (torch.bool, torch.uint8)
            or ns.dtype != torch.int32):
        raise TypeError(
            f"expected uint8 blocks, int32 cand, bool/uint8 valid, int32 ns; "
            f"got {blocks_u8.dtype}, {cand.dtype}, {valid.dtype}, {ns.dtype}")
    M, B = blocks_u8.shape
    P = cand.shape[1]
    if B < 1 or max_match < MIN_MATCH:
        raise ValueError(f"need B >= 1 and max_match >= {MIN_MATCH}; got "
                         f"B={B}, max_match={max_match}")
    dev = blocks_u8.device
    if not (cand.device == valid.device == ns.device == dev):
        raise ValueError("blocks, cand, valid and ns must live on one device")
    if dev.type == "cpu":
        return match_extend_plain(blocks_u8, cand, valid.to(torch.bool), ns,
                                  max_match)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    if not all(t.is_contiguous() for t in (blocks_u8, cand, valid, ns)):
        raise ValueError("blocks, cand, valid and ns must be contiguous")
    if M > 65535:
        raise ValueError(f"the CUDA kernel takes M <= 65535 rows, got {M}")
    out = torch.empty((M, P), dtype=torch.int32, device=dev)
    if M == 0 or P == 0:
        return out
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(blocks_u8.data_ptr(), cand.data_ptr(), valid.data_ptr(),
                 ns.data_ptr(), out.data_ptr(), M, B, P, max_match,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "match_extend")
    launches += 1
    return out
