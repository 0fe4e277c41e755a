"""The benchmark's one generator of objects: bytes made from a run's seed and
the parameters of a traffic file.

An object is the frozen corpus (`corpus.py`) tiled to ``object_bytes``.
Then, from the seed, one byte in ``replace_every`` is replaced by a random
byte (so no two seeds give the same hash-table contents), and exactly one
block in ``noise_block_every`` (none where it is 0) is overwritten with
random bytes, which the compressor stores raw.  Every seed gives the same
sizes and the same numbers of replaced bytes and noise blocks; only where
they fall, and their values, change.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench import corpus

BLOCK = 65536


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed``, any whole number (negative or past 64 bits
    too), and a stream number that keeps its uses apart."""
    return np.random.default_rng([seed % (1 << 64), stream])


def build(seed: int, traffic: dict, cache_dir: Path,
          object_bytes: int | None = None) -> bytes:
    """The object of one run.  ``object_bytes`` overrides the traffic's size
    (the CPU tests make small ones)."""
    nbytes = int(object_bytes or traffic["object_bytes"])
    rng = rng_of(seed)
    base = np.frombuffer(corpus.corpus(cache_dir), dtype=np.uint8)
    out = np.tile(base, -(-nbytes // len(base)))[:nbytes].copy()
    every = int(traffic.get("replace_every", 0))
    if every:
        hits = rng.integers(0, nbytes, nbytes // every)
        out[hits] = rng.integers(0, 256, hits.size, dtype=np.uint8)
    every = int(traffic.get("noise_block_every", 0))
    nblocks = -(-nbytes // BLOCK)
    if every:
        for b in np.sort(rng.permutation(nblocks)[: nblocks // every]):
            lo, hi = b * BLOCK, min((b + 1) * BLOCK, nbytes)
            out[lo:hi] = rng.integers(0, 256, hi - lo, dtype=np.uint8)
    return out.tobytes()
