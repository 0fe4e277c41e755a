"""Greedy software LZ4 — the "GitHub [15]" baseline of the paper (Tables I/III).

This is the multi-match, unbounded-extension compressor: it scans byte by byte,
emits every non-overlapping match it finds, and extends matches as far as the
data allows.  ``max_match`` caps the match length (paper Table II rows).

Implementation notes
--------------------
* Hash insertion is *dense* (every position, including inside matches), matching
  the paper's hardware which updates PWS table records every cycle.  With dense
  insertion, the table lookup for position ``p`` is exactly "the latest previous
  position with the same hash value", which we precompute vectorized (numpy)
  instead of simulating the table sequentially.  This keeps the golden model
  fast enough to sweep hash-table sizes over a ~MB corpus.
* All LZ4 end-of-block rules are enforced (see lz4_types).
"""
from __future__ import annotations

import numpy as np

from .lz4_types import (
    HASH_PRIME,
    LAST_LITERALS,
    MAX_BLOCK,
    MF_LIMIT,
    MIN_MATCH,
    Sequence,
)


def le32_words(data: np.ndarray) -> np.ndarray:
    """Little-endian uint32 word starting at each position (len-3 entries)."""
    d = data.astype(np.uint32)
    n = len(d)
    if n < 4:
        return np.zeros(0, dtype=np.uint32)
    return d[: n - 3] | (d[1 : n - 2] << 8) | (d[2 : n - 1] << 16) | (d[3:] << 24)


def fib_hash(words: np.ndarray, hash_bits: int) -> np.ndarray:
    """Fibonacci hash: (w * 2654435761) >> (32 - hash_bits)."""
    h = (words * np.uint32(HASH_PRIME)) & np.uint32(0xFFFFFFFF)
    return (h >> np.uint32(32 - hash_bits)).astype(np.int64)


def prev_same_hash(hashes: np.ndarray) -> np.ndarray:
    """For each position p: the largest q < p with hashes[q] == hashes[p], else -1.

    Vectorized predecessor query: stable argsort by hash groups equal hashes into
    runs ordered by position; the predecessor is simply the previous element of
    the run.
    """
    n = len(hashes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(hashes, kind="stable")  # stable => ascending position in runs
    h_sorted = hashes[order]
    prev = np.full(n, -1, dtype=np.int64)
    same = h_sorted[1:] == h_sorted[:-1]
    prev[1:][same] = order[:-1][same]
    out = np.full(n, -1, dtype=np.int64)
    out[order] = prev
    return out


def match_length(data: np.ndarray, p: int, q: int, limit: int) -> int:
    """Length of the common prefix of data[p:] and data[q:], capped at `limit`."""
    a = data[p : p + limit]
    b = data[q : q + limit]
    m = min(len(a), len(b))
    neq = np.nonzero(a[:m] != b[:m])[0]
    return int(neq[0]) if len(neq) else m


def compress_greedy(
    data: bytes | np.ndarray,
    hash_bits: int = 12,
    max_match: int | None = None,
) -> list[Sequence]:
    """Greedy LZ4 sequence plan (multi-match, optionally length-capped).

    Returns the sequence plan; use encoder.encode_block for exact bytes or
    lz4_types.plan_size for the exact compressed size.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(buf)
    if n > MAX_BLOCK:
        raise ValueError(f"block too large: {n} > {MAX_BLOCK}")
    sequences: list[Sequence] = []
    if n == 0:
        return [Sequence(0, 0)]
    words = le32_words(buf)
    hashes = fib_hash(words, hash_bits)
    cand = prev_same_hash(hashes)
    words_l = words  # uint32 view for O(1) word compare

    anchor = 0
    ip = 0
    limit_ip = n - MF_LIMIT  # last allowed match start (inclusive)
    while ip <= limit_ip and ip < len(words):
        q = cand[ip]
        if q >= 0 and words_l[q] == words_l[ip]:
            cap = n - LAST_LITERALS - ip
            if max_match is not None:
                cap = min(cap, max_match)
            if cap >= MIN_MATCH:
                mlen = MIN_MATCH + match_length(buf, ip + MIN_MATCH, int(q) + MIN_MATCH, cap - MIN_MATCH)
                sequences.append(Sequence(anchor, ip - anchor, mlen, ip - int(q)))
                ip += mlen
                anchor = ip
                continue
        ip += 1
    sequences.append(Sequence(anchor, n - anchor))
    return sequences


def compression_ratio(original_size: int, compressed_size: int) -> float:
    return original_size / compressed_size
