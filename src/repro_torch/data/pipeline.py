"""Deterministic, host-sharded token pipeline with LZ4-compressed shards.

The port of the JAX package's `data/pipeline.py`: the same synthetic stream,
shard files and batches for the same seed.  The synthetic stream mixes
zipf-distributed tokens with repeated n-grams so the LZ4 stage achieves a
real (>1) compression ratio — the shard files on disk are frames written by
an `LZ4Engine` (the card's by default) and are decoded on load through an
`LZ4DecodeEngine` (the card's device executor by default).  With
``cache_shards=False`` the pipeline never materializes a whole shard: each
batch row is fetched with `FrameReader.read_range`, decoding only the 64 KB
blocks covering that row's token slice (the frame block table is the seek
index).

Restart-friendliness: batches are a pure function of (step, host_id), so a
resumed job consumes exactly the batches it would have seen.  Batches are
``np.ndarray`` (int32), as in the reference.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.decode_engine import FrameReader, default_decode_engine
from repro_torch.core.engine import default_engine
from repro_torch.core.frame import frame_info

__all__ = ["synth_tokens", "ShardedTokenPipeline"]


def synth_tokens(seed: int, n: int, vocab: int) -> np.ndarray:
    """Zipf tokens with injected n-gram repeats (LZ4-compressible)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, min(vocab, 4096) + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(len(ranks), size=n, p=probs).astype(np.int32)
    # repeat phrases: copy earlier spans forward
    n_rep = n // 64
    for _ in range(n_rep):
        src = rng.integers(0, max(n - 64, 1))
        dst = rng.integers(0, max(n - 32, 1))
        ln = rng.integers(8, 32)
        toks[dst: dst + ln] = toks[src: src + ln]
    return toks % vocab


class ShardedTokenPipeline:
    """Writes LZ4'd token shards at init; serves deterministic (B,S) batches.

    ``engine`` / ``decode_engine``: the `LZ4Engine` that writes missing
    shards and the `LZ4DecodeEngine` that reads them (defaults: the card's;
    pass ``device="cpu"`` engines to run the kernels' plain versions).
    """

    def __init__(self, data_dir: str, vocab: int, *, n_shards: int = 4,
                 shard_tokens: int = 65536 // 2, host_id: int = 0, n_hosts: int = 1,
                 seed: int = 0, cache_shards: bool = True, decode_engine=None,
                 engine=None):
        self.vocab = vocab
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.data_dir = data_dir
        self.cache_shards = cache_shards
        self._engine = decode_engine or default_decode_engine()
        os.makedirs(data_dir, exist_ok=True)
        self.shards = []
        for s in range(n_shards):
            path = os.path.join(data_dir, f"shard_{s:04d}.lz4")
            if not os.path.exists(path):
                toks = synth_tokens(seed * 1000 + s, shard_tokens, vocab)
                raw = toks.astype(np.int32).tobytes()
                # Shard files are self-describing frames: no hand-rolled
                # block-count/length prefixes.
                with open(path, "wb") as f:
                    f.write((engine or default_engine()).compress(raw))
            self.shards.append(path)
        self._cache: dict[int, np.ndarray] = {}
        self._readers: dict[int, FrameReader] = {}

    def _load_shard(self, s: int) -> np.ndarray:
        if s not in self._cache:
            with open(self.shards[s], "rb") as f:
                raw = self._engine.decode(f.read())
            self._cache[s] = np.frombuffer(raw, np.int32)
        return self._cache[s]

    def _reader(self, s: int) -> FrameReader:
        """Seekable reader over shard s (frame stays compressed in memory)."""
        if s not in self._readers:
            with open(self.shards[s], "rb") as f:
                self._readers[s] = FrameReader(f.read(), engine=self._engine)
        return self._readers[s]

    def _shard_tokens(self, s: int) -> int:
        return self._reader(s).usize // 4 if not self.cache_shards \
            else len(self._load_shard(s))

    def _row(self, s: int, start: int, seq: int) -> np.ndarray:
        if self.cache_shards:
            return self._load_shard(s)[start: start + seq]
        # Random access: decode only the blocks covering this row's slice.
        return np.frombuffer(self._reader(s).read_range(start * 4, seq * 4),
                             np.int32)

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        """Deterministic (batch, seq) int32 tokens for this host at `step`."""
        out = np.empty((batch, seq), np.int32)
        for i in range(batch):
            gidx = (step * batch * self.n_hosts) + self.host_id * batch + i
            s = gidx % len(self.shards)
            n_per = self._shard_tokens(s) - seq
            start = (gidx * 7919) % max(n_per, 1)
            out[i] = self._row(s, start, seq)
        return out

    def compression_ratio(self) -> float:
        raw = comp = 0
        for path in self.shards:
            with open(path, "rb") as f:
                frame = f.read()
            # The block table alone gives the uncompressed size: no decode.
            raw += sum(b["usize"] for b in frame_info(frame)["blocks"])
            comp += len(frame)
        return raw / comp
