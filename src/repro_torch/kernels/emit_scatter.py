"""Device-side LZ4 byte emission: hand-written CUDA kernel + wrapper.

Replaces the TPU kernel `emit_scatter_pallas` / `_emit_scatter_kernel`
(src/repro/kernels/emit_scatter.py).  The kernel source, its design and what
bounds it on the card are described at the top of `csrc/emit_scatter.cu`;
the plain PyTorch version is `ref.emit_bytes_ref`, re-exported here as
`emit_scatter_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import KernelRefusal
from .ref import N_FIELDS
from .ref import emit_bytes_ref as emit_scatter_plain

__all__ = ["emit_scatter", "emit_scatter_plain", "launches", "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()
launches_by_device: dict[int, int] = {}  # the same, per CUDA device index


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_device.clear()


def _lib():
    lib = _build.load("emit_scatter")
    fn = lib.emit_scatter_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def emit_scatter(blocks_u8: torch.Tensor, seg: torch.Tensor,
                 fields: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Materialize the compressed bytes of every block of a micro-batch.

    blocks_u8 : (M, B) uint8 input blocks
    seg       : (M, K) int32 covering-sequence index per output byte
    fields    : (M, N_FIELDS, S) int32 per-sequence layout rows (ref.F_*)
    total     : (M,) int32 exact compressed sizes; bytes at >= total are 0

    Returns (M, K) uint8, equal to `emit_scatter_plain`.
    """
    if blocks_u8.dim() != 2 or seg.dim() != 2 or fields.dim() != 3 \
            or total.dim() != 1:
        raise KernelRefusal("expected blocks (M, B), seg (M, K), fields "
                            "(M, 8, S), total (M,)")
    M, B = blocks_u8.shape
    K = seg.shape[1]
    S = fields.shape[2]
    if seg.shape[0] != M or fields.shape[:2] != (M, N_FIELDS) \
            or total.shape[0] != M:
        raise KernelRefusal(f"batch/field mismatch: blocks {tuple(blocks_u8.shape)}, "
                            f"seg {tuple(seg.shape)}, fields {tuple(fields.shape)}, "
                            f"total {tuple(total.shape)}")
    if blocks_u8.dtype != torch.uint8 or any(
            t.dtype != torch.int32 for t in (seg, fields, total)):
        raise TypeError("expected uint8 blocks and int32 seg/fields/total")
    dev = blocks_u8.device
    if any(t.device != dev for t in (seg, fields, total)):
        raise KernelRefusal("all inputs must live on the same device")
    if dev.type == "cpu":
        return emit_scatter_plain(blocks_u8, seg, fields, total)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    if not all(t.is_contiguous() for t in (blocks_u8, seg, fields, total)):
        raise KernelRefusal("all inputs must be contiguous")
    if seg.data_ptr() % 16:
        raise KernelRefusal("seg must be 16-byte aligned")
    out = torch.empty((M, K), dtype=torch.uint8, device=dev)
    if M == 0 or K == 0:
        return out
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        err = fn(blocks_u8.data_ptr(), seg.data_ptr(), fields.data_ptr(),
                 total.data_ptr(), out.data_ptr(), M, B, K, S,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "emit_scatter")
    launches += 1
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
    return out
