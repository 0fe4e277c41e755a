"""Shared helpers for the tests of the PyTorch port (`tests/test_torch_*.py`).

Seeded numpy inputs that go through BOTH packages, the adversarial block
corpus (a copy of the corpora the reference's own kernel tests use, merged),
the LZ4 block corpus of the read-path tests (`block_corpus`, valid streams at
the length-field boundaries; `lying_corpus`, one malformed stream per planner
check), and the one-thread setting that keeps parallel test workers from starting a
full torch thread pool each.  This file holds no tests.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.corpus import adversarial_blocks
from repro_torch.core.emitter import emit_block
from repro_torch.core.lz4_types import Sequence

torch.set_num_threads(1)

MAX_BLOCK = 65536
PAD = 71
TILE = 2048  # the reference kernels' tile; matches are placed to straddle it

# The (hash_bits, max_match, pws) corners swept at kernel level.
PARAM_SWEEP = [(6, 12, 8), (10, 68, 4), (8, 36, 16), (12, 36, 8)]


def rng(seed: int = 20260729) -> np.random.Generator:
    return np.random.default_rng(seed)


def adversarial_corpus() -> dict[str, bytes]:
    """The port's adversarial block corpus (`corpus.adversarial_blocks`): a
    merged copy of the corpora the reference's own kernel tests use."""
    return adversarial_blocks()


def pad_stack(blocks: list[bytes], garbage_seed: int | None = None):
    """(M, MAX_BLOCK + PAD) uint8 stack + (M,) int32 lengths.

    With ``garbage_seed`` the region past each block's length is filled with
    seeded noise instead of zeros — callers may pass garbage there and the
    results must not change.
    """
    m = len(blocks)
    if garbage_seed is None:
        stack = np.zeros((m, MAX_BLOCK + PAD), np.uint8)
    else:
        stack = rng(garbage_seed).integers(0, 256, (m, MAX_BLOCK + PAD), np.uint8)
    ns = np.zeros((m,), np.int32)
    for j, b in enumerate(blocks):
        stack[j, : len(b)] = np.frombuffer(b, np.uint8)
        ns[j] = len(b)
    return stack, ns


def multiblock_corpus() -> bytes:
    """Engine-level input: compressible text, a noise block stored raw, an
    RLE block, and a ragged tail (5 blocks, the last one short)."""
    r = rng(20260730)
    return ((b"engine level corpus " * 7000)[: 2 * MAX_BLOCK]
            + r.integers(0, 256, MAX_BLOCK, np.uint8).tobytes()
            + b"\x00" * (MAX_BLOCK + 17)
            + bytes(r.integers(0, 6, 3000, np.uint8)))


def encode(data: bytes, seqs) -> bytes:
    """LZ4 block of `data` from (lit_start, lit_len, match_len, offset)
    sequences, through the port's emitter."""
    emit = [s.match_len > 0 for s in seqs[:-1]]
    pos = [s.lit_start + s.lit_len for s in seqs[:-1]]
    return emit_block(data, emit, pos, [s.match_len for s in seqs[:-1]],
                      [s.offset for s in seqs[:-1]], len(data))


@functools.lru_cache(maxsize=1)
def block_corpus() -> dict[str, bytes]:
    """Valid LZ4 blocks: literals-only encodings of the adversarial corpus,
    compressor output for a few of them, RLE chains at the length-field
    boundaries, and a long literal final after matches."""
    from repro_torch import LZ4Engine

    out = {}
    adv = adversarial_corpus()
    for name in ("text", "rle_runs", "short_13", "empty"):
        out[f"lit_{name}"] = emit_block(adv[name], [], [], [], [], len(adv[name]))
    eng = LZ4Engine(device="cpu")
    joined = b"".join(adv[k] for k in ("text", "rle_runs", "tile_straddle",
                                        "top_bit_words", "low_entropy"))
    blocks = eng.compress_to_blocks(joined[: 2 * MAX_BLOCK] + b"\x00" * MAX_BLOCK)
    out["cmp_text"], out["cmp_mixed"], out["zeros"] = blocks
    for ml in (4, 18, 19, 20, 273, 274, 529):
        data = b"z" * (1 + ml)
        out[f"rle_{ml}"] = encode(data, [Sequence(0, 1, ml, 1), Sequence(1 + ml, 0)])
    r = rng(5)
    data = b"ab" * 40 + r.integers(0, 256, 300, np.uint8).tobytes()
    out["final_ext"] = encode(data, [Sequence(0, 2, 78, 2), Sequence(80, 300)])
    return out


# Names of `block_corpus()`, listed so that parametrize needs no compression
# at collection time.
BLOCK_NAMES = ["lit_text", "lit_rle_runs", "lit_short_13", "lit_empty",
               "cmp_text", "cmp_mixed", "zeros", "rle_4", "rle_18", "rle_19",
               "rle_20", "rle_273", "rle_274", "rle_529", "final_ext"]


def lying_corpus() -> dict[str, tuple[bytes, int]]:
    """Malformed streams -> (block, max_out), each aimed at one check of the
    planners (the reference's tests/test_plan_speculative.py set)."""
    fin = b"\x10B"
    return {
        "zero_offset": (b"\x10A\x00\x00" + fin, MAX_BLOCK),
        "offset_beyond": (b"\x10A\x05\x00" + fin, MAX_BLOCK),
        "missing_final": (b"\x10A\x01\x00", MAX_BLOCK),
        "lit_past_end": (b"\xf0" + b"\xff" * 3, MAX_BLOCK),
        "out_limit_lit": (b"\x40ABCD", 3),
        "out_limit_match": (b"\x1fA\x01\x00\x20" + fin, 10),
        "empty": (b"", MAX_BLOCK),
    }
