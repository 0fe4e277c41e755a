"""Pointer-doubling block decode: hand-written CUDA kernel + wrapper.

Replaces the Pallas kernel `decode_wave_pallas`
(src/repro/kernels/decode_wave.py): `rounds` rounds of ``ptr = ptr[ptr]``
over a block's per-output-byte source map, then ``out[k] =
block[lit_blk[ptr[k]]]``, zero at or past `total`.  The kernel source, its
design and what bounds it on the card are described at the top of
`csrc/decode_wave.cu`; the plain PyTorch version is `ref.decode_gather_ref`,
re-exported here as `decode_wave_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import KernelRefusal
from .ref import decode_gather_ref as decode_wave_plain

__all__ = ["decode_wave", "decode_wave_plain", "launches", "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()
launches_by_device: dict[int, int] = {}  # the same, per CUDA device index

MAX_K = 65536  # the cluster kernel's uint16 table; wider K takes the wide kernel


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_device.clear()


def _lib():
    lib = _build.load("decode_wave")
    fn = lib.decode_wave_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_wave(blocks: torch.Tensor, lit_blk: torch.Tensor,
                ptr: torch.Tensor, total: torch.Tensor, rounds: int):
    """Resolve + materialize a micro-batch of decoded blocks.

    blocks  : (M, B) uint8 compressed payloads
    lit_blk : (M, K) int32 literal source index per output byte (a value out
              of [-B, B) reads byte 0; in [-B, -1] it wraps, as `jnp.take`)
    ptr     : (M, K) int32 immediate source position per output byte, in
              [0, K) (clipped again by both versions)
    total   : (M,) int32 decoded sizes; positions >= total emit 0
    rounds  : pointer-doubling rounds (>= 0)

    Returns (M, K) uint8, equal to `decode_wave_plain`.
    """
    if blocks.dim() != 2 or lit_blk.dim() != 2 or lit_blk.shape != ptr.shape \
            or total.shape != (blocks.shape[0],) \
            or lit_blk.shape[0] != blocks.shape[0]:
        raise KernelRefusal(
            f"expected blocks (M, B), lit_blk and ptr (M, K), total (M,); got "
            f"{tuple(blocks.shape)}, {tuple(lit_blk.shape)}, "
            f"{tuple(ptr.shape)}, {tuple(total.shape)}")
    if blocks.dtype != torch.uint8 or lit_blk.dtype != torch.int32 \
            or ptr.dtype != torch.int32 or total.dtype != torch.int32:
        raise TypeError(f"expected uint8 blocks and int32 lit_blk/ptr/total, "
                        f"got {blocks.dtype}, {lit_blk.dtype}, {ptr.dtype}, "
                        f"{total.dtype}")
    if rounds < 0:
        raise KernelRefusal(f"rounds must be >= 0, got {rounds}")
    dev = blocks.device
    if not (lit_blk.device == ptr.device == total.device == dev):
        raise KernelRefusal("blocks, lit_blk, ptr and total must live on one device")
    if dev.type == "cpu":
        return decode_wave_plain(blocks, lit_blk, ptr, total, rounds)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    M, B = blocks.shape
    K = ptr.shape[1]
    if not all(t.is_contiguous() for t in (blocks, lit_blk, ptr, total)):
        raise KernelRefusal("blocks, lit_blk, ptr and total must be contiguous")
    out = torch.empty((M, K), dtype=torch.uint8, device=dev)
    if M == 0 or K == 0:
        return out
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        # K > MAX_K: the wide kernel's two int32 copies of the table
        scratch = torch.empty((2, M, K), dtype=torch.int32, device=dev) \
            if K > MAX_K else None
        err = fn(blocks.data_ptr(), lit_blk.data_ptr(), ptr.data_ptr(),
                 total.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), M, B, K,
                 rounds, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "decode_wave")
    launches += 1
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
    return out
