"""Vectorized HOST-side LZ4 block emission: per-window match records -> bytes.

This is the engine's ``device_emit=False`` path and the bit-identity ORACLE
for the device-resident emitter (`kernels.ops.emit_bytes`, the engine's
default), which computes the same bytes on the device so they never
round-trip through host NumPy at all (docs/architecture.md §write path).

Historically this module replaced `encode_block`'s Python loops — one
iteration per sequence plus one per length-extension byte, ~55 ms per
compressible 64 KB block — with NumPy prefix sums, GPULZ-style
(arXiv 2304.07342): the byte offset of every token, literal run, offset field
and extension-byte run is a cumulative sum over per-sequence sizes, so the
whole block materializes with a handful of fancy-indexed assignments (~3 ms).

The oracle chain is therefore:  `encode_block` (Python loops, most obviously
correct)  ==  `emit_block` (this module)  ==  device emit (on the card).
tests/test_torch_emit.py asserts the second equality, tests/test_torch_engine.py
the engine-level frame equality of ``device_emit=True|False``.
"""
from __future__ import annotations

import numpy as np

from .lz4_types import MIN_MATCH

__all__ = ["emit_block", "emit_block_from_records"]


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``[s, s+1, ..., s+c-1]`` for each (start, count) pair.

    The standard vectorized-ragged-range trick: one arange over the total
    length, rebased per segment via repeat of the segment starts.
    """
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    ends = np.cumsum(counts)
    rebase = np.repeat(starts.astype(np.int64) - (ends - counts), counts)
    return np.arange(total, dtype=np.int64) + rebase


def _ext_counts(values: np.ndarray) -> np.ndarray:
    """Length-extension byte count for token-nibble values >= 15."""
    return np.where(values < 15, 0, 1 + (values - 15) // 255).astype(np.int64)


def _fill_ext(out: np.ndarray, starts: np.ndarray, counts: np.ndarray,
              values: np.ndarray) -> None:
    """Write extension-byte runs: (count-1) bytes of 255, then (v-15) % 255."""
    sel = counts > 0
    if not sel.any():
        return
    s, c, v = starts[sel], counts[sel], values[sel]
    out[_ranges(s, c)] = 255
    out[s + c - 1] = (v - 15) % 255


def emit_block(data, emit, pos, length, offset, n: int) -> bytes:
    """Emit the LZ4 block for one set of per-window match records.

    data   : bytes or uint8 array holding at least the first `n` input bytes
    emit   : (W,) bool   — window emits a match
    pos    : (W,) int    — match start position (valid where emit)
    length : (W,) int    — match length (valid where emit)
    offset : (W,) int    — match back-offset (valid where emit)
    n      : true block length
    """
    buf = np.frombuffer(data, np.uint8, count=n) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.asarray(data, np.uint8)[:n]
    emit = np.asarray(emit, bool)
    w = np.nonzero(emit)[0]
    mpos = np.asarray(pos, np.int64)[w]
    mlen = np.asarray(length, np.int64)[w]
    moff = np.asarray(offset, np.int64)[w]

    # Anchors: each match's literals start where the previous match ended.
    ends = mpos + mlen
    anchors = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
    lit = mpos - anchors
    ml = mlen - MIN_MATCH
    final_anchor = int(ends[-1]) if len(w) else 0
    final_lit = n - final_anchor

    lit_ext = _ext_counts(lit)
    match_ext = _ext_counts(ml)
    seq_sizes = 1 + lit_ext + lit + 2 + match_ext
    starts = np.concatenate([np.zeros(1, np.int64), np.cumsum(seq_sizes)])
    final_start = int(starts[-1])
    starts = starts[:-1]
    final_ext = int(_ext_counts(np.asarray([final_lit]))[0])
    total = final_start + 1 + final_ext + final_lit

    out = np.empty(total, np.uint8)
    # Tokens.
    out[starts] = (np.minimum(lit, 15) << 4) | np.minimum(ml, 15)
    # Literal-length extension bytes.
    _fill_ext(out, starts + 1, lit_ext, lit)
    # Literal runs (gather from input, scatter to output).
    lit_dst = starts + 1 + lit_ext
    out[_ranges(lit_dst, lit)] = buf[_ranges(anchors, lit)]
    # 16-bit little-endian offsets.
    off_at = lit_dst + lit
    out[off_at] = moff & 0xFF
    out[off_at + 1] = moff >> 8
    # Match-length extension bytes.
    _fill_ext(out, off_at + 2, match_ext, ml)
    # Final literals-only sequence.
    out[final_start] = min(final_lit, 15) << 4
    _fill_ext(out, np.asarray([final_start + 1]), np.asarray([final_ext]),
              np.asarray([final_lit]))
    out[final_start + 1 + final_ext:] = buf[final_anchor:n]
    return out.tobytes()


def emit_block_from_records(data, rec, n: int) -> bytes:
    """Convenience wrapper taking a BlockRecords (device or host arrays)."""
    return emit_block(
        data, np.asarray(rec.emit), np.asarray(rec.pos),
        np.asarray(rec.length), np.asarray(rec.offset), n,
    )
