"""Speculative LZ4 header parse: hand-written CUDA kernel + wrapper.

Replaces the Pallas kernel `plan_spec_pallas`
(src/repro/kernels/plan_speculative.py): a candidate sequence header at
every byte offset of a compressed block, and the chain of headers reachable
from offset 0.  The kernel source, its design and what bounds it on the card
are described at the top of `csrc/plan_speculative.cu`; the plain PyTorch
version is `ref.plan_fields_ref`, re-exported here as
`plan_speculative_plain`.  Validation and compaction of the chain into plan
columns are `ops.plan_speculative`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import plan_fields_ref as plan_speculative_plain

__all__ = ["plan_speculative", "plan_speculative_plain", "launches",
           "reset_launches", "FIELDS"]

launches = 0  # kernel launches since import / the last reset_launches()

FIELDS = ("is_start", "lit_start", "lit_len", "ls_end", "off", "mlen", "flags")


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = _build.load("plan_speculative")
    fn = lib.plan_speculative_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def plan_speculative(blocks: torch.Tensor, n: torch.Tensor):
    """Candidate header at every offset + chain select, for M blocks.

    blocks : (M, B) uint8 payloads; B must be strictly greater than every
             n (the run table is read at index n)
    n      : (M,) int32 payload lengths, 0 <= n < B

    Returns the seven (M, B) int32 tensors of `FIELDS`, equal to
    `plan_speculative_plain`.
    """
    if blocks.dim() != 2 or n.shape != (blocks.shape[0],):
        raise ValueError(f"expected blocks (M, B) and n (M,), got "
                         f"{tuple(blocks.shape)} and {tuple(n.shape)}")
    if blocks.dtype != torch.uint8 or n.dtype != torch.int32:
        raise TypeError(f"expected uint8 blocks and int32 n, got "
                        f"{blocks.dtype} and {n.dtype}")
    dev = blocks.device
    if n.device != dev:
        raise ValueError("blocks and n must live on the same device")
    if dev.type == "cpu":
        return plan_speculative_plain(blocks, n)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    M, B = blocks.shape
    W = (B + 31) // 32
    if B < 1 or ((B + 15) // 16) * 16 + 8 * W + 4096 > _build.SMEM_PER_CTA:
        raise ValueError(f"the CUDA kernel takes 1 <= B <= about 180,000, got {B}")
    if not (blocks.is_contiguous() and n.is_contiguous()):
        raise ValueError("blocks and n must be contiguous")
    outs = [torch.empty((M, B), dtype=torch.int32, device=dev) for _ in FIELDS]
    if M == 0:
        return tuple(outs)
    scratch = torch.empty((3, M, B), dtype=torch.int32, device=dev)
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(blocks.data_ptr(), n.data_ptr(),
                 *(o.data_ptr() for o in outs),
                 scratch[0].data_ptr(), scratch[1].data_ptr(),
                 scratch[2].data_ptr(), M, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "plan_speculative")
    launches += 1
    return tuple(outs)
