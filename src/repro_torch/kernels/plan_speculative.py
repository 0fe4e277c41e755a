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
import functools

import torch

from . import _build
from ._build import KernelRefusal
from .ref import plan_fields_ref as plan_speculative_plain

__all__ = ["plan_speculative", "plan_speculative_plain", "launches",
           "reset_launches", "max_b", "scratch_bytes", "FIELDS"]

launches = 0  # kernel launches since import / the last reset_launches()
launches_by_device: dict[int, int] = {}  # the same, per CUDA device index

# The largest B for which the shared-memory kernel's chain select (every
# offset reachable from 0) equals the plain version's 16 doubling rounds:
# each hop advances at least 3 bytes, so B < 3 * 2^16.  Its shared memory
# caps B lower, near 94,000: `max_b()`.  Wider rows take the wide kernel,
# which runs the 16 rounds themselves, in device memory.
MAX_B = 196607

FIELDS = ("is_start", "lit_start", "lit_len", "ls_end", "off", "mlen", "flags")


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_device.clear()


def _lib():
    lib = _build.load("plan_speculative")
    fn = lib.plan_speculative_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def max_b() -> int:
    """The largest B the shared-memory kernel takes: MAX_B, or less where
    its shared memory runs out (about 94,000); wider rows take the wide
    kernel.  Builds the kernel on first use."""
    fn = _build.load("plan_speculative").plan_speculative_max_b
    fn.argtypes, fn.restype = [], ctypes.c_int
    return int(fn())


def scratch_bytes(M: int, B: int) -> int:
    """Device scratch a launch over (M, B) needs: 0 up to `max_b()`, else
    the wide kernel's per-offset tables."""
    fn = _build.load("plan_speculative").plan_speculative_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return int(fn(M, B))


def plan_speculative(blocks: torch.Tensor, n: torch.Tensor):
    """Candidate header at every offset + chain select, for M blocks.

    blocks : (M, B) uint8 payloads; B must be strictly greater than every
             n (the run table is read at index n); on the card, rows wider
             than `max_b()` take the wide kernel (scratch in device memory)
    n      : (M,) int32 payload lengths, 0 <= n < B

    Returns the seven (M, B) int32 tensors of `FIELDS`, equal to
    `plan_speculative_plain`.
    """
    if blocks.dim() != 2 or n.shape != (blocks.shape[0],):
        raise KernelRefusal(f"expected blocks (M, B) and n (M,), got "
                            f"{tuple(blocks.shape)} and {tuple(n.shape)}")
    if blocks.dtype != torch.uint8 or n.dtype != torch.int32:
        raise TypeError(f"expected uint8 blocks and int32 n, got "
                        f"{blocks.dtype} and {n.dtype}")
    dev = blocks.device
    if n.device != dev:
        raise KernelRefusal("blocks and n must live on the same device")
    if dev.type == "cpu":
        return plan_speculative_plain(blocks, n)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    M, B = blocks.shape
    if B < 1:
        raise KernelRefusal(f"the CUDA kernel takes B >= 1, got {B}")
    if not (blocks.is_contiguous() and n.is_contiguous()):
        raise KernelRefusal("blocks and n must be contiguous")
    outs = [torch.empty((M, B), dtype=torch.int32, device=dev) for _ in FIELDS]
    if M == 0:
        return tuple(outs)
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        nbytes = scratch_bytes(M, B)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev) if nbytes else None
        err = fn(blocks.data_ptr(), n.data_ptr(),
                 *(o.data_ptr() for o in outs),
                 None if scratch is None else scratch.data_ptr(), M, B,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "plan_speculative")
    launches += 1
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
    return tuple(outs)
