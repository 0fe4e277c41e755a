"""Fused compression datapath: hand-written CUDA kernel + wrapper.

Replaces the TPU kernel `fused_compress_pallas` / `_fused_kernel`
(src/repro/kernels/fused_compress.py).  The kernel source, its design and
what bounds it on the card are described at the top of
`csrc/fused_compress.cu`; the plain PyTorch version is `ref.fused_ref`,
re-exported here as `fused_compress_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.lz4_types import MIN_MATCH

from . import _build
from .ref import fused_ref as fused_compress_plain

__all__ = ["fused_compress", "fused_compress_plain", "launches",
           "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()

# Dynamic shared memory one CTA may ask for on sm_90 (227 KB).
_SMEM_LIMIT = 232448
CLUSTER = 4            # CTAs per block (csrc `CLUSTER`), where P allows it
_MAX_SEGMENTS = 32     # one warp per segment, 1024 threads per CTA
_GLOBAL_SEGMENTS = 8   # segments when the tables live in device memory


class Plan(NamedTuple):
    cluster: int           # CTAs per block
    nseg: int              # segments (warps that walk) per CTA
    tab_off: int           # shared-memory offset of the tables
    lc_off: int            # ... of the segment-local candidates (uint16)
    smem_bytes: int        # dynamic shared memory per CTA
    tables_in_shared: bool
    wide: bool             # uint32 segment-local candidates (P > 65536)


def reset_launches() -> None:
    global launches
    launches = 0


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _divisor_at_most(units: int, cap: int) -> int:
    return next(d for d in range(min(units, cap), 0, -1) if units % d == 0)


def _plan(B: int, P: int, hash_bits: int, pws: int, cluster: int | None = None) -> Plan:
    """The launch plan of one call; mirrors the kernel's layout.

    Each CTA of a cluster owns P / cluster positions, a whole number of
    units of max(32, pws) positions (the cluster shrinks by halves until it
    is); its warps walk `nseg` segments, a divisor of its units, at most 32.
    Shared memory holds the row's first P + 8 bytes (and up to 15 of
    misalignment, rounded up to 16 bytes), then the nseg + 1 uint32 tables
    (the segment tables and the CTA's summary), then the segment-local
    candidates (uint16; for P > 65536 they live in the `cand` output).  Tables that do
    not fit with one segment move to a device-memory scratch.
    """
    unit = max(32, pws)
    units = P // unit
    C = cluster or CLUSTER
    while C > 1 and units % C:
        C //= 2
    span_units = units // C
    wide = P > 65536
    block_bytes = P + 32
    lc_bytes = 0 if wide else _round16((P // C) * 2)
    tables = lambda s: _round16((s + 1) * (4 << hash_bits))  # noqa: E731
    nseg = _divisor_at_most(span_units, _MAX_SEGMENTS)
    while nseg > 1 and block_bytes + tables(nseg) + lc_bytes > _SMEM_LIMIT:
        nseg = _divisor_at_most(span_units, nseg - 1)
    if block_bytes + tables(nseg) + lc_bytes <= _SMEM_LIMIT:
        tab_bytes = tables(nseg)
    else:
        nseg = _divisor_at_most(span_units, _GLOBAL_SEGMENTS)
        tab_bytes = 0
    return Plan(C, nseg, block_bytes, block_bytes + tab_bytes,
                block_bytes + tab_bytes + lc_bytes, tab_bytes > 0, wide)


def _lib():
    lib = _build.load("fused_compress")
    fn = lib.fused_compress_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_compress(blocks_u8: torch.Tensor, ns: torch.Tensor, positions: int,
                   hash_bits: int = 8, pws: int = 8, max_match: int = 36):
    """Candidates + bounded match lengths for every position of every block.

    blocks_u8 : (M, B) uint8, contiguous; bytes at index >= ns[m] are ignored
    ns        : (M,) int32 true block lengths, 0 <= n <= positions
    positions : position count P; B >= P + max_match

    Returns ``(cand, lengths)``, both (M, P) int32: candidate position (-1
    where none/invalid) and full match length (0 where no valid match, else
    in [MIN_MATCH, max_match]) — elementwise equal to `fused_compress_plain`.
    """
    if blocks_u8.dim() != 2 or ns.dim() != 1 or ns.shape[0] != blocks_u8.shape[0]:
        raise ValueError(f"expected blocks (M, B) and ns (M,), got "
                         f"{tuple(blocks_u8.shape)} and {tuple(ns.shape)}")
    if blocks_u8.dtype != torch.uint8 or ns.dtype != torch.int32:
        raise TypeError(f"expected uint8 blocks and int32 ns, got "
                        f"{blocks_u8.dtype} and {ns.dtype}")
    M, B = blocks_u8.shape
    P = positions
    if not (MIN_MATCH <= max_match and B >= P + max(max_match, MIN_MATCH)):
        raise ValueError(f"need 4 <= max_match and B >= P + max_match; got "
                         f"B={B}, P={P}, max_match={max_match}")
    if pws < 1 or P % pws:
        raise ValueError(f"pws={pws} must divide P={P}")
    if ns.device != blocks_u8.device:
        raise ValueError("blocks and ns must live on the same device")
    if blocks_u8.device.type == "cpu":
        return fused_compress_plain(blocks_u8, ns, P, hash_bits, pws, max_match)
    if blocks_u8.device.type != "cuda":
        raise RuntimeError(f"unsupported device {blocks_u8.device}")

    if not (1 <= hash_bits <= 16):
        raise ValueError(f"the CUDA kernel takes 1 <= hash_bits <= 16, got {hash_bits}")
    if pws & (pws - 1) or pws > 2048 or P % 2048:
        raise ValueError(f"the CUDA kernel takes a power-of-two pws <= 2048 "
                         f"and P % 2048 == 0, got pws={pws}, P={P}")
    if not (blocks_u8.is_contiguous() and ns.is_contiguous()):
        raise ValueError("blocks and ns must be contiguous")
    dev = blocks_u8.device
    cand = torch.empty((M, P), dtype=torch.int32, device=dev)
    lengths = torch.empty((M, P), dtype=torch.int32, device=dev)
    if M == 0 or P == 0:
        return cand, lengths
    plan = _plan(B, P, hash_bits, pws)
    if plan.smem_bytes > _SMEM_LIMIT:
        raise ValueError(f"the CUDA kernel stages P + 32 bytes of a row in "
                         f"shared memory; P={P} is too large")
    scratch = None if plan.tables_in_shared else torch.empty(
        (M, plan.cluster, plan.nseg + 1, 1 << hash_bits),
        dtype=torch.int32, device=dev)
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(blocks_u8.data_ptr(), ns.data_ptr(), cand.data_ptr(),
                 lengths.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 M, B, P, hash_bits, pws, max_match, plan.cluster, plan.nseg,
                 plan.tab_off, plan.lc_off, plan.smem_bytes, int(plan.wide),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "fused_compress")
    launches += 1
    return cand, lengths
