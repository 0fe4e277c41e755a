"""CRC-32 of rows of bytes: hand-written CUDA kernel + wrapper.

No TPU kernel stands behind this one: it is the graph stage `crc32_bytes` of
the JAX package (src/repro/kernels/ops.py, a `lax.scan` of slice-by-8
steps), which eager PyTorch could only run as a Python loop.  The kernel
source, its design and what bounds it on the card are described at the top
of `csrc/crc32.cu`; the plain PyTorch version (chunk registers and a
level-by-level combine, vectorized over rows and chunks) is `ref.crc32_ref`,
re-exported here as `crc32_plain`.

The kernel reads its tables from one buffer that this module builds with
NumPy (`kernel_tables`) and keeps on each device: the sixteen stride-folded
byte tables, the byte table and x^(-128 t) for each thread t.  The CTAs of a
row combine through a per-device, per-stream buffer of 2 M words that the
kernel leaves at zero; it is made (zeroed) only when a launch has more rows
than the buffer holds, never per call.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version only for CPU tensors.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ._build import KernelRefusal
from .ref import CRC_POLY, _multmodp, crc_byte_table, crc_x2n_table
from .ref import crc32_ref as crc32_plain

__all__ = ["crc32", "crc32_plain", "launches", "reset_launches",
           "kernel_tables"]

launches = 0  # kernel launches since import / the last reset_launches()
launches_by_device: dict[int, int] = {}  # the same, per CUDA device index

# The table layout (csrc/crc32.cu; the tests hold these to the source).
THREADS = 256
PIECE = 16
STRIDE = THREADS * PIECE

_tables: dict[torch.device, torch.Tensor] = {}
_acc: dict[tuple[torch.device, int], torch.Tensor] = {}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_device.clear()


def _lib():
    lib = _build.load("crc32")
    fn = lib.crc32_launch
    if not fn.argtypes:
        words = lib.crc32_table_words
        words.argtypes, words.restype = [], ctypes.c_int
        if words() != kernel_tables().size:
            raise RuntimeError(f"crc32: the kernel reads {words()} table words, "
                               f"kernel_tables() has {kernel_tables().size}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _mul(a: int, b: int) -> int:
    """a(x) * b(x) modulo the polynomial, reflected (x^0 is bit 31)."""
    return int(_multmodp(a, np.array([b], np.uint64))[0])


def _x_inverse() -> int:
    """x^-1 modulo the polynomial, reflected.  With P = x^32 + p(x) and
    p(0) = 1, x * (P - 1) / x = P - 1 = 1 modulo P; in the reflected form
    (P - 1) / x is the polynomial's low word shifted up by one bit."""
    return ((CRC_POLY << 1) & 0xFFFFFFFF) | 1


@functools.lru_cache(maxsize=1)
def kernel_tables() -> np.ndarray:
    """The kernel's constants as one uint32 array (csrc `TABLE_WORDS`):

    [0, 4096)     T_j[b] = CRC0(byte b at position j, then STRIDE - 1 - j
                  zero bytes), j < 16, b < 256 (row j at j * 256)
    [4096, 4352)  the byte table T0[b] = CRC0(b): v * x^8 = (v >> 8) ^ T0[v & 0xff]
    [4352, 4608)  x^(-128 t) for t < THREADS: moves a register back 16 t bytes
    """
    t0 = crc_byte_table().astype(np.uint64)
    x2n = crc_x2n_table()

    def x8(nbytes: int) -> int:  # x^(8 nbytes)
        p, k, n = 1 << 31, 3, nbytes
        while n:
            if n & 1:
                p = _mul(x2n[k & 31], p)
            n >>= 1
            k += 1
        return p

    slices = np.stack([_multmodp(x8(STRIDE - 1 - j), t0) for j in range(PIECE)])
    step = 1 << 31
    inv1 = _x_inverse()
    for _ in range(8 * PIECE):      # x^(-128)
        step = _mul(inv1, step)
    inv = [1 << 31]
    for _ in range(THREADS - 1):
        inv.append(_mul(step, inv[-1]))
    out = np.concatenate([slices.reshape(-1).astype(np.uint64), t0,
                          np.array(inv, np.uint64)])
    return out.astype(np.uint32)


def _device_tables(dev: torch.device) -> torch.Tensor:
    t = _tables.get(dev)
    if t is None:
        t = torch.from_numpy(kernel_tables().view(np.int32)).to(dev)
        _tables[dev] = t
    return t


def _acc_buffer(dev: torch.device, M: int) -> torch.Tensor:
    """The combine buffer of the current stream: 2 M int32, zero between
    launches (the kernel zeroes what it used)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _acc.get(key)
    if buf is None or buf.numel() < 2 * M:
        buf = torch.zeros((2 * max(M, 64),), dtype=torch.int32, device=dev)
        _acc[key] = buf
    return buf


def crc32(data: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """CRC-32 (== ``binascii.crc32``) of ``data[m, :n[m]]`` for every row.

    data : (M, K) uint8;  n : (M,) int32 with 0 <= n <= K.
    Returns (M,) int64 holding the unsigned CRC, equal to `crc32_plain`.
    """
    if data.dim() != 2 or n.shape != (data.shape[0],):
        raise KernelRefusal(f"expected data (M, K) and n (M,), got "
                            f"{tuple(data.shape)} and {tuple(n.shape)}")
    if data.dtype != torch.uint8 or n.dtype != torch.int32:
        raise TypeError(f"expected uint8 data and int32 n, got {data.dtype} "
                        f"and {n.dtype}")
    dev = data.device
    if n.device != dev:
        raise KernelRefusal("data and n must live on the same device")
    if dev.type == "cpu":
        return crc32_plain(data, n)
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}")

    M, K = data.shape
    if M > 65535:
        raise KernelRefusal(f"the CUDA kernel takes at most 65535 rows, got {M}")
    if not (data.is_contiguous() and n.is_contiguous()):
        raise KernelRefusal("data and n must be contiguous")
    out = torch.empty((M,), dtype=torch.int64, device=dev)
    if M == 0:
        return out
    fn = _lib()
    global launches
    with torch.cuda.device(dev):
        tables = _device_tables(dev)
        err = fn(data.data_ptr(), n.data_ptr(), out.data_ptr(),
                 tables.data_ptr(), _acc_buffer(dev, M).data_ptr(), M, K,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "crc32")
    launches += 1
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
    return out
