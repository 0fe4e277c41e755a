"""LZ4 block-format constants and the compression-plan data model.

The LZ4 block format (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md):

  sequence := token | [lit-len ext bytes] | literals | offset(2B LE) | [match-len ext bytes]

  token high nibble = literal length (15 => extension bytes follow, each 255 until < 255)
  token low  nibble = match length - 4 (15 => extension bytes)

End-of-block rules used by the official compressor (and enforced here):
  * the last sequence is literals-only (no offset/matchlen fields),
  * the last 5 bytes are always literals (a match must end <= len-5),
  * a match must NOT start within the last 12 bytes (MF_LIMIT).
"""
from __future__ import annotations

import dataclasses

MIN_MATCH = 4                 # minimum encodable match length
MF_LIMIT = 12                 # no match may start within the last MF_LIMIT bytes
LAST_LITERALS = 5             # a match must end at least LAST_LITERALS before block end
MAX_OFFSET = 65535            # 16-bit offset field
HASH_PRIME = 2654435761       # Fibonacci hashing constant (paper Section II-B)
MAX_BLOCK = 65536             # LZ4 window / paper's input-buffer size (64 KB)

# Paper's hardware parameters (Section III/IV).
DEFAULT_PWS = 8               # parallelization window size in bytes
DEFAULT_MAX_MATCH = 36        # paper's chosen maximum match length limit
DEFAULT_HASH_BITS = 8         # 256 entries, as in [9][10] and the paper's architecture


@dataclasses.dataclass(frozen=True)
class Sequence:
    """One LZ4 sequence: `lit_len` literals starting at `lit_start`, then a match.

    ``match_len == 0`` marks the final literals-only sequence.
    """

    lit_start: int
    lit_len: int
    match_len: int = 0
    offset: int = 0

    def __post_init__(self):
        if self.match_len:
            if self.match_len < MIN_MATCH:
                raise ValueError(f"match_len {self.match_len} < {MIN_MATCH}")
            if not (1 <= self.offset <= MAX_OFFSET):
                raise ValueError(f"offset {self.offset} out of range")


def pad_pow2_count(count: int, cap: int) -> int:
    """Micro-batch row count for `count` items: the full `cap` when the
    batch is full, else the next power of two — so the number of compiled
    batch shapes stays bounded by log2(cap) + 1.  Shared by the compress
    and decode engines so their compile-shape bucketing cannot diverge."""
    if count >= cap:
        return cap
    return min(cap, 1 << (count - 1).bit_length()) if count > 1 else 1


def lit_ext_bytes(lit_len: int) -> int:
    """Number of literal-length extension bytes."""
    if lit_len < 15:
        return 0
    return 1 + (lit_len - 15) // 255


def match_ext_bytes(match_len: int) -> int:
    """Number of match-length extension bytes (match_len is the full length >= 4)."""
    m = match_len - MIN_MATCH
    if m < 15:
        return 0
    return 1 + (m - 15) // 255


def sequence_size(seq: Sequence) -> int:
    """Exact encoded size of one sequence in bytes."""
    size = 1 + lit_ext_bytes(seq.lit_len) + seq.lit_len
    if seq.match_len:
        size += 2 + match_ext_bytes(seq.match_len)
    return size


def plan_size(sequences: list[Sequence]) -> int:
    """Exact compressed-block size for a sequence plan."""
    return sum(sequence_size(s) for s in sequences)


def plan_coverage(sequences: list[Sequence]) -> int:
    """Total input bytes covered by a plan (must equal block length)."""
    return sum(s.lit_len + s.match_len for s in sequences)
