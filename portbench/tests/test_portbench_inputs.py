"""The frozen corpus and the object generator on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import corpus, harness, objects  # noqa: E402

CACHE = harness.CACHE / "cache"
TRAFFIC = harness.load_json(ROOT / "traffic" / "compress.bulk.json")
SIZE = 96 * 65536 + 1000


def test_frozen_corpus_is_the_programs_corpus():
    from repro_torch.core.corpus import corpus_files

    assert corpus.corpus(CACHE) == b"".join(corpus_files().values())


def test_corpus_cache_is_read_back(tmp_path):
    first = corpus.corpus(tmp_path)
    assert len(list(tmp_path.iterdir())) == 2
    assert corpus.corpus(tmp_path) == first


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7, 2**40 + 3, -5])
def test_same_seed_same_bytes(seed):
    a = objects.build(seed, TRAFFIC, CACHE, SIZE)
    assert len(a) == SIZE
    assert a == objects.build(seed, TRAFFIC, CACHE, SIZE)


def test_seeds_differ_in_bytes_not_in_sizes():
    size = 96 * 65536
    base = np.frombuffer(corpus.corpus(CACHE), np.uint8)
    tiled = np.tile(base, -(-size // len(base)))[:size]
    outs = set()
    for seed in (11, 12, 2**31 + 1):
        o = np.frombuffer(objects.build(seed, TRAFFIC, CACHE, size), np.uint8)
        outs.add(o.tobytes())
        diff = (o != tiled).reshape(-1, 65536)
        noise = diff.mean(axis=1) > 0.5
        assert int(noise.sum()) == 96 // TRAFFIC["noise_block_every"]
        assert int(diff[~noise].sum()) <= size // TRAFFIC["replace_every"]
    assert len(outs) == 3


def test_decode_traffic_has_no_noise_blocks():
    t = harness.load_json(ROOT / "traffic" / "decode.bulk64.json")
    base = np.frombuffer(corpus.corpus(CACHE), np.uint8)
    o = np.frombuffer(objects.build(3, t, CACHE, 64 * 65536), np.uint8)
    changed = np.count_nonzero(o != np.tile(base, 4)[: len(o)])
    assert changed <= len(o) // t["replace_every"]
