"""Chain validation and decode layout: hand-written CUDA kernel + wrapper.

No TPU kernel stands behind this one: it replaces the stock graph stages
that follow the header kernel in the JAX package's `kernels/ops.py`
(`plan_speculative`'s checks, cumsum and compaction into plan columns, and
`_decode_layout`'s span maps and gathers), which the port ran as a chain of
about a hundred stock torch ops a dispatch.  From the seven header fields
of `plan_speculative` it writes each row's status, its decode total and
`decode_wave`'s two inputs.  The kernel source, its design and what bounds
it on the card are described at the top of `csrc/plan_layout.cu`; the
plain PyTorch version is `ref.plan_layout_ref`, re-exported here as
`plan_layout_plain`.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import KernelRefusal
from .ref import SPEC_STATUS
from .ref import plan_layout_ref as plan_layout_plain

__all__ = ["plan_layout", "plan_layout_plain", "launches", "reset_launches"]

launches = 0  # kernel launches since import / the last reset_launches()
launches_by_device: dict[int, int] = {}  # the same, per CUDA device index


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_device.clear()


def _lib():
    lib = _build.load("plan_layout")
    fn = lib.plan_layout_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def plan_layout(is_start, lit_start, lit_len, ls_end, off, mlen, flags,
                n, max_out, max_lit: int, max_match: int, out_cap: int):
    """Status, decode total and `decode_wave`'s inputs for M blocks.

    is_start .. flags : the seven (M, B) int32 rows of `plan_speculative`
    n, max_out        : (M,) int32 payload lengths and decoded-size limits
    max_lit, max_match, out_cap : the plan caps (`DevicePlanCaps`)

    Returns ``(status, total, lit_blk, ptr)``: (M, SPEC_STATUS) int32,
    (M,) int32 and two (M, out_cap) int32, equal to `plan_layout_plain`.
    """
    fields = (is_start, lit_start, lit_len, ls_end, off, mlen, flags)
    if any(f.dim() != 2 or f.shape != is_start.shape for f in fields) \
            or n.shape != (is_start.shape[0],) or max_out.shape != n.shape:
        raise KernelRefusal(
            f"expected seven (M, B) fields and n, max_out (M,); got "
            f"{[tuple(f.shape) for f in fields]}, {tuple(n.shape)}, "
            f"{tuple(max_out.shape)}")
    if any(t.dtype != torch.int32 for t in (*fields, n, max_out)):
        raise TypeError(f"expected int32 fields, n and max_out, got "
                        f"{[t.dtype for t in (*fields, n, max_out)]}")
    if out_cap < 1 or max_lit < 0 or max_match < 0 or is_start.shape[1] < 1:
        raise KernelRefusal(f"expected B >= 1, out_cap >= 1 and caps >= 0, got "
                            f"B={is_start.shape[1]}, out_cap={out_cap}, "
                            f"max_lit={max_lit}, max_match={max_match}")
    dev = is_start.device
    if any(t.device != dev for t in (*fields, n, max_out)):
        raise KernelRefusal("the fields, n and max_out must live on one device")
    if not all(t.is_contiguous() for t in (*fields, n, max_out)):
        raise KernelRefusal("the fields, n and max_out must be contiguous")
    if dev.type == "cpu":
        return plan_layout_plain(*fields, n, max_out, max_lit, max_match, out_cap)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    M, B = is_start.shape
    status = torch.empty((M, SPEC_STATUS), dtype=torch.int32, device=dev)
    total = torch.empty((M,), dtype=torch.int32, device=dev)
    lit_blk = torch.empty((M, out_cap), dtype=torch.int32, device=dev)
    ptr = torch.empty((M, out_cap), dtype=torch.int32, device=dev)
    if M == 0:
        return status, total, lit_blk, ptr
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        # each row's chain nodes: (offset, running sum), then (prev_total,
        # lit_len, lit_start, off)
        scratch = torch.empty((M, B, 4), dtype=torch.int32, device=dev)
        err = fn(*(f.data_ptr() for f in fields), n.data_ptr(),
                 max_out.data_ptr(), status.data_ptr(), total.data_ptr(),
                 lit_blk.data_ptr(), ptr.data_ptr(), scratch.data_ptr(),
                 M, B, out_cap, max_lit, max_match,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "plan_layout")
    launches += 1
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
    return status, total, lit_blk, ptr
