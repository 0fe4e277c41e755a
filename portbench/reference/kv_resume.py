"""Plain reference of parking a KV cache and resuming it: one frame per leaf,
written and read with the NumPy compressor and decoder of `lz4_paper.py`
and zlib's CRC-32.

A tree is nested ``dict`` / ``list`` / ``tuple`` (``None`` an empty
subtree) whose leaves are `Leaf`s: a leaf's bytes, its dtype's name
(``"bfloat16"``, ``"int32"``, ...) and its shape.  Dict keys are visited in
sorted order.  A parked cache ("blob") is ``[treedef, blobs]``: the tree
with each leaf replaced by a placeholder, and per leaf, in tree order, a
dict of its ``shape``, ``dtype`` and ``frame``.  A leaf of 1024 bytes or
more is cut into 64 KiB blocks, each compressed by the paper's scheme and
stored raw where its LZ4 bytes are not shorter; a smaller one is one raw
block.  The frame is version 3: header, content size, a table of each
block's size, stored size with the raw flag, and CRC-32.

`resume` reads any such blob, the program's (`serving.offload_cache`)
included: a placeholder is anything but a dict, list, tuple or ``None``.
It holds each frame to its table and each block to its CRC-32, and raises
ValueError where one disagrees.

Imports numpy, zlib and the standard library only.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import lz4_paper as ref

SMALL_LEAF = 1024            # a leaf shorter than this is one raw block
PLACEHOLDER = "*"


class Leaf:
    """A leaf as bytes: ``data`` (bytes-like), ``dtype`` (its name) and
    ``shape``."""

    __slots__ = ("data", "dtype", "shape")

    def __init__(self, data, dtype: str, shape):
        self.data, self.dtype, self.shape = data, dtype, tuple(shape)


def flatten(tree) -> list:
    """The leaves of ``tree`` in tree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [] if tree is None else [tree]


def _treedef(tree):
    if isinstance(tree, dict):
        return {k: _treedef(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_treedef(v) for v in tree)
    return None if tree is None else PLACEHOLDER


def _build(treedef, leaves):
    if isinstance(treedef, dict):
        return {k: _build(treedef[k], leaves) for k in sorted(treedef)}
    if isinstance(treedef, (list, tuple)):
        return type(treedef)(_build(v, leaves) for v in treedef)
    return None if treedef is None else next(leaves)


# -- park ----------------------------------------------------------------------

def write_frame(data: bytes, hash_bits: int, pws: int, max_match: int) -> bytes:
    """The version 3 frame of ``data``."""
    if len(data) >= SMALL_LEAF:
        blocks = [data[i: i + ref.BLOCK] for i in range(0, len(data), ref.BLOCK)]
        stored = [ref.compress_block(b, hash_bits, pws, max_match) for b in blocks]
    else:
        blocks = [data] if data else []
        stored = [(True, data)] if data else []
    table = b"".join(
        struct.pack("<III", len(b), len(p) | (ref.RAW_FLAG if raw else 0), zlib.crc32(b))
        for b, (raw, p) in zip(blocks, stored))
    return b"".join([ref.MAGIC, struct.pack("<BIQ", 3, len(blocks), len(data)),
                     table, *(p for _, p in stored)])


def park(tree, hash_bits: int = 8, pws: int = 8, max_match: int = 36) -> list:
    """The blob of a tree of `Leaf`s."""
    blobs = [{"shape": leaf.shape, "dtype": leaf.dtype,
              "frame": write_frame(bytes(leaf.data), hash_bits, pws, max_match)}
             for leaf in flatten(tree)]
    return [_treedef(tree), blobs]


# -- resume --------------------------------------------------------------------

def read_frame(frame: bytes) -> np.ndarray:
    """The content of a version 2 or 3 frame as a uint8 array: raw blocks
    copied, coded blocks decoded, every block held to its CRC-32."""
    info = ref.read_frame(frame)
    if info["end"] != len(frame):
        raise ValueError(f"the table ends the frame at {info['end']}, not {len(frame)}")
    usize = info["usize"]
    total = int(usize.sum())
    if info["content_size"] not in (None, total):
        raise ValueError(f"content size {info['content_size']}, blocks {total}")
    base = np.cumsum(usize) - usize
    out = np.empty(total, np.uint8)
    buf = np.frombuffer(frame, np.uint8)
    raw = info["raw"]
    for i in np.flatnonzero(raw):
        at, n = int(info["offsets"][i]), int(info["csize"][i])
        if n != usize[i]:
            raise ValueError(f"block {i}: raw payload of {n} bytes for {usize[i]}")
        out[base[i]: base[i] + n] = buf[at: at + n]
    coded = np.flatnonzero(~raw)
    if coded.size:
        lo = info["offsets"][coded]
        got, ok = ref.decode_blocks(buf, lo, lo + info["csize"][coded], usize[coded])
        if not ok.all():
            raise ValueError(f"block {int(coded[~ok][0])} does not decode")
        at = 0
        for i in coded:
            out[base[i]: base[i] + usize[i]] = got[at: at + usize[i]]
            at += int(usize[i])
    view = memoryview(out)
    for i in range(info["count"]):
        if zlib.crc32(view[base[i]: base[i] + usize[i]]) != info["crc"][i]:
            raise ValueError(f"block {i}: CRC-32 mismatch")
    return out


def resume(blob) -> object:
    """The tree of `Leaf`s a blob parks; each leaf's ``data`` a uint8 array
    whose size its dtype and shape give."""
    treedef, blobs = blob
    leaves = []
    for b in blobs:
        data = read_frame(b["frame"])
        shape = tuple(int(d) for d in b["shape"])
        itemsize = 2 if b["dtype"] == "bfloat16" else np.dtype(b["dtype"]).itemsize
        want = itemsize * int(np.prod(shape, dtype=np.int64))
        if data.size != want:
            raise ValueError(f"{data.size} bytes for {b['dtype']} {shape}")
        leaves.append(Leaf(data, b["dtype"], shape))
    return _build(treedef, iter(leaves))
