"""Independent LZ4 block decoder, written against the public block-format spec.

Used as the round-trip oracle: every compressor in this repo must produce
blocks this decoder restores bit-exactly.  Deliberately shares no code with
the encoder.

Two implementations with identical semantics:

  decode_block           — fast path: literals and non-overlapping matches
                           copy as whole slices; overlapping matches
                           (offset < match_len) replicate their offset-wide
                           pattern in chunks instead of byte-by-byte.
  decode_block_bytewise  — the original byte-at-a-time reference, kept as the
                           oracle (tests assert equality on overlapping-match
                           blocks, where chunking is easiest to get wrong).
"""
from __future__ import annotations

from repro_torch.resilience.errors import FrameError


class LZ4FormatError(FrameError, ValueError):
    """Malformed LZ4 block (parse/truncation/size errors).

    ValueError for backwards compatibility; `FrameError` for the unified
    corruption hierarchy (structured ``block_index``/``cause`` attributes
    — see repro_torch/resilience/errors.py)."""


def decode_block(block: bytes, max_out: int | None = None) -> bytes:
    out = bytearray()
    i = 0
    n = len(block)
    while True:
        if i >= n:
            raise LZ4FormatError("truncated block: missing token")
        token = block[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise LZ4FormatError("truncated literal length")
                b = block[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise LZ4FormatError("truncated literals")
        # Cap BEFORE appending: a lying length field must not be able to
        # allocate past max_out (checking after the copy lets a crafted
        # block overshoot by an arbitrary run, and a final literals-only
        # sequence used to skip the check entirely).
        if max_out is not None and len(out) + lit_len > max_out:
            raise LZ4FormatError("output exceeds limit")
        out += block[i : i + lit_len]
        i += lit_len
        if i == n:
            break  # final literals-only sequence
        if i + 2 > n:
            raise LZ4FormatError("truncated offset")
        offset = block[i] | (block[i + 1] << 8)
        i += 2
        if offset == 0:
            raise LZ4FormatError("zero offset")
        if offset > len(out):
            raise LZ4FormatError("offset beyond output")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise LZ4FormatError("truncated match length")
                b = block[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        if max_out is not None and len(out) + match_len > max_out:
            raise LZ4FormatError("output exceeds limit")
        src = len(out) - offset
        if offset >= match_len:
            # Non-overlapping: one chunked copy.
            out += out[src : src + match_len]
        else:
            # Overlapping: the copy replicates the trailing `offset`-byte
            # pattern cyclically; tiling it is equivalent to the byte loop.
            pattern = bytes(out[src:])
            reps = -(-match_len // offset)
            out += (pattern * reps)[:match_len]
    return bytes(out)


def decode_block_bytewise(block: bytes, max_out: int | None = None) -> bytes:
    """Byte-at-a-time reference decoder (oracle for the chunked fast path)."""
    out = bytearray()
    i = 0
    n = len(block)
    while True:
        if i >= n:
            raise LZ4FormatError("truncated block: missing token")
        token = block[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise LZ4FormatError("truncated literal length")
                b = block[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise LZ4FormatError("truncated literals")
        if max_out is not None and len(out) + lit_len > max_out:
            raise LZ4FormatError("output exceeds limit")
        out += block[i : i + lit_len]
        i += lit_len
        if i == n:
            break  # final literals-only sequence
        if i + 2 > n:
            raise LZ4FormatError("truncated offset")
        offset = block[i] | (block[i + 1] << 8)
        i += 2
        if offset == 0:
            raise LZ4FormatError("zero offset")
        if offset > len(out):
            raise LZ4FormatError("offset beyond output")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise LZ4FormatError("truncated match length")
                b = block[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        if max_out is not None and len(out) + match_len > max_out:
            raise LZ4FormatError("output exceeds limit")
        # Byte-by-byte copy: overlapping matches (offset < match_len) replicate.
        src = len(out) - offset
        for j in range(match_len):
            out.append(out[src + j])
    return bytes(out)
