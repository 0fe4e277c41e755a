"""Exact LZ4 block-format encoder (sequence plan -> bytes)."""
from __future__ import annotations

import numpy as np

from .lz4_types import MIN_MATCH, Sequence, plan_coverage


def encode_block(data: bytes | np.ndarray, sequences: list[Sequence]) -> bytes:
    """Emit the LZ4 block for a sequence plan produced by any scheme."""
    buf = bytes(data) if not isinstance(data, bytes) else data
    if plan_coverage(sequences) != len(buf):
        raise ValueError("plan does not cover the block exactly")
    out = bytearray()
    for i, seq in enumerate(sequences):
        is_last = i == len(sequences) - 1
        if is_last and seq.match_len:
            raise ValueError("last sequence must be literals-only")
        if not is_last and not seq.match_len:
            raise ValueError("interior sequence missing a match")
        lit = seq.lit_len
        ml = seq.match_len - MIN_MATCH if seq.match_len else 0
        token = (min(lit, 15) << 4) | min(ml, 15)
        out.append(token)
        if lit >= 15:
            rem = lit - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out += buf[seq.lit_start : seq.lit_start + seq.lit_len]
        if seq.match_len:
            out.append(seq.offset & 0xFF)
            out.append((seq.offset >> 8) & 0xFF)
            if ml >= 15:
                rem = ml - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)
    return bytes(out)
