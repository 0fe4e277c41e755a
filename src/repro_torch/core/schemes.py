"""Numpy golden models of the paper's windowed hardware compressor.

Hardware semantics modeled (paper Sections II-B, III, IV):

* The block is processed in parallelization windows of PWS bytes, one window
  per clock cycle.
* Every cycle, ALL PWS positions are hashed and written into the hash table
  (LVT multi-port, last writer in window order wins).  Reads performed in the
  same cycle see the table state from *previous* cycles only (multi-port reads
  happen before the write phase).  Consequently the candidate for position p is

      cand(p) = max{ q : hash(q) == hash(p), window(q) < window(p) }

  which depends only on the byte stream — never on match decisions — and is
  precomputed vectorized here (and by the batched engine's candidate stages,
  `compressor.py`).
* The table stores the candidate's 4-byte string next to its pointer, so match
  validation is a word compare (no second buffer read).
* Single-match scheme (paper III-A): each window emits at most the EARLIEST
  valid match at a position not yet covered by a previous match (free pointer);
  the search always resumes at the next window boundary.
* Bounded extension (paper III-B): match length capped at `max_match`
  (None = unbounded, for the Table I row that isolates the single-match effect).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .lz4_types import (
    DEFAULT_MAX_MATCH,
    DEFAULT_PWS,
    LAST_LITERALS,
    MAX_BLOCK,
    MF_LIMIT,
    MIN_MATCH,
    Sequence,
)
from .reference import fib_hash, le32_words, match_length


@dataclasses.dataclass(frozen=True)
class WindowedResult:
    sequences: list[Sequence]
    # Per-window records, for the cycle model and for JAX-engine equality tests:
    emit: np.ndarray       # bool (W,) — window emitted a match
    pos: np.ndarray        # int  (W,) — match start position (or -1)
    length: np.ndarray     # int  (W,) — match length (or 0)
    offset: np.ndarray     # int  (W,) — match offset (or 0)


def window_candidates(hashes: np.ndarray, pws: int) -> np.ndarray:
    """cand(p) = max{q : hash(q)==hash(p), q//pws < p//pws}, else -1. Vectorized."""
    n = len(hashes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    win = np.arange(n, dtype=np.int64) // pws
    order = np.lexsort((np.arange(n), hashes))  # by hash, then position
    h_s = hashes[order]
    w_s = win[order]
    p_s = order
    # Group = (hash, window) run.  The candidate for every element of a group is
    # the position just before the group head, provided it belongs to the same
    # hash run (then it automatically has a strictly smaller window index).
    head = np.ones(n, dtype=bool)
    head[1:] = (h_s[1:] != h_s[:-1]) | (w_s[1:] != w_s[:-1])
    head_idx = np.nonzero(head)[0]
    group_id = np.cumsum(head) - 1
    head_cand = np.full(len(head_idx), -1, dtype=np.int64)
    valid_head = head_idx > 0
    hi = head_idx[valid_head]
    same_hash = h_s[hi - 1] == h_s[hi]
    head_cand[valid_head] = np.where(same_hash, p_s[hi - 1], -1)
    cand_s = head_cand[group_id]
    out = np.empty(n, dtype=np.int64)
    out[order] = cand_s
    return out


def compress_windowed(
    data: bytes | np.ndarray,
    hash_bits: int = 12,
    pws: int = DEFAULT_PWS,
    max_match: int | None = DEFAULT_MAX_MATCH,
) -> WindowedResult:
    """The paper's single-match-per-window compressor (golden numpy model).

    max_match=None  -> Table I "only a single match" scheme (S1 alone)
    max_match=L     -> combined scheme (S1 + S2), paper default L=36
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(buf)
    if n > MAX_BLOCK:
        raise ValueError(f"block too large: {n} > {MAX_BLOCK}")
    n_windows = (n + pws - 1) // pws
    emit = np.zeros(n_windows, dtype=bool)
    pos = np.full(n_windows, -1, dtype=np.int64)
    length = np.zeros(n_windows, dtype=np.int64)
    offset = np.zeros(n_windows, dtype=np.int64)
    if n == 0:
        return WindowedResult([Sequence(0, 0)], emit, pos, length, offset)

    words = le32_words(buf)
    hashes = fib_hash(words, hash_bits)
    cand = window_candidates(hashes, pws)
    # Positions where a 4-byte match exists and a match may legally start:
    nw = len(words)
    valid4 = np.zeros(n, dtype=bool)
    has_cand = cand >= 0
    idx = np.nonzero(has_cand)[0]
    valid4[idx] = words[idx] == words[cand[idx]]
    limit_ip = n - MF_LIMIT
    valid4[max(0, limit_ip + 1):] = False

    fp = 0
    for w in range(n_windows):
        ws = w * pws
        we = min(ws + pws, n)
        start = max(ws, fp)
        if start >= we:
            continue
        hits = np.nonzero(valid4[start:we])[0]
        if len(hits) == 0:
            continue
        p = start + int(hits[0])
        q = int(cand[p])
        cap = n - LAST_LITERALS - p
        if max_match is not None:
            cap = min(cap, max_match)
        if cap < MIN_MATCH:
            continue
        mlen = MIN_MATCH + match_length(buf, p + MIN_MATCH, q + MIN_MATCH, cap - MIN_MATCH)
        emit[w] = True
        pos[w] = p
        length[w] = mlen
        offset[w] = p - q
        fp = p + mlen

    sequences = plan_from_matches(n, emit, pos, length, offset)
    return WindowedResult(sequences, emit, pos, length, offset)


def plan_from_matches(
    n: int,
    emit: np.ndarray,
    pos: np.ndarray,
    length: np.ndarray,
    offset: np.ndarray,
) -> list[Sequence]:
    """Build the sequence plan (literal runs between matches) from match records."""
    sequences: list[Sequence] = []
    anchor = 0
    for w in np.nonzero(emit)[0]:
        p, l, o = int(pos[w]), int(length[w]), int(offset[w])
        sequences.append(Sequence(anchor, p - anchor, l, o))
        anchor = p + l
    sequences.append(Sequence(anchor, n - anchor))
    return sequences


# ---------------------------------------------------------------------------
# Multi-match windowed model (Beneš [10]-style), used by the cycle model to
# reproduce the parallelism-loss analysis in paper Section III-A.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiMatchResult:
    sequences: list[Sequence]
    matches_per_window: np.ndarray   # int (W,)
    extension_reads: np.ndarray      # int (W,) — extra candidate reads (feedback loop trips)


def compress_windowed_multi(
    data: bytes | np.ndarray,
    hash_bits: int = 12,
    pws: int = DEFAULT_PWS,
) -> MultiMatchResult:
    """Windowed compressor that recovers ALL non-overlapping matches (FIFO scheme).

    Same LVT table semantics as compress_windowed, but within a window the
    search continues after each match (this is what costs the extra cycles).
    Extension is unbounded; each additional PWS-byte comparison beyond the
    first is counted as one feedback-loop trip.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(buf)
    if n > MAX_BLOCK:
        raise ValueError(f"block too large: {n} > {MAX_BLOCK}")
    n_windows = (n + pws - 1) // pws
    matches_per_window = np.zeros(n_windows, dtype=np.int64)
    extension_reads = np.zeros(n_windows, dtype=np.int64)
    if n == 0:
        return MultiMatchResult([Sequence(0, 0)], matches_per_window, extension_reads)

    words = le32_words(buf)
    hashes = fib_hash(words, hash_bits)
    cand = window_candidates(hashes, pws)
    valid4 = np.zeros(n, dtype=bool)
    has_cand = cand >= 0
    idx = np.nonzero(has_cand)[0]
    valid4[idx] = words[idx] == words[cand[idx]]
    limit_ip = n - MF_LIMIT
    valid4[max(0, limit_ip + 1):] = False

    sequences: list[Sequence] = []
    anchor = 0
    fp = 0
    for w in range(n_windows):
        ws = w * pws
        we = min(ws + pws, n)
        p = max(ws, fp)
        while p < we:
            if not valid4[p]:
                p += 1
                continue
            q = int(cand[p])
            cap = n - LAST_LITERALS - p
            if cap < MIN_MATCH:
                break
            mlen = MIN_MATCH + match_length(buf, p + MIN_MATCH, q + MIN_MATCH, cap - MIN_MATCH)
            sequences.append(Sequence(anchor, p - anchor, mlen, p - q))
            matches_per_window[w] += 1
            # Feedback-loop trips: ceil((mlen - MIN_MATCH) / pws) candidate reads.
            extension_reads[w] += -(-(mlen - MIN_MATCH) // pws)
            anchor = p + mlen
            fp = p + mlen
            p = p + mlen
        fp = max(fp, we)

    sequences.append(Sequence(anchor, n - anchor))
    return MultiMatchResult(sequences, matches_per_window, extension_reads)
