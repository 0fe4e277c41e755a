"""Shared helpers for the tests of the PyTorch port (`tests/test_torch_*.py`).

Seeded numpy inputs that go through BOTH packages, the adversarial block
corpus (a copy of the corpora the reference's own kernel tests use, merged),
and the one-thread setting that keeps parallel test workers from starting a
full torch thread pool each.  This file holds no tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.corpus import adversarial_blocks

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
