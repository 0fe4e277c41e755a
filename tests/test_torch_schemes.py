"""The port's NumPy golden models and host oracles against their JAX-package
twins: `core/reference.py` (greedy software LZ4), `core/schemes.py` (the
windowed S1 / S1+S2 golden model and the multi-match model), `core/encoder.py`
(the loop-based block encoder) and `core/cycle_model.py` (the paper's FPGA
cycle model), on the adversarial corpus, the 14-file corpus and the kernel
sweep's `PARAM_SWEEP` corners.  Outputs are integers, plans and bytes:
tolerance zero.  The staged compress path's records are also held against
the port's own golden model, as the JAX package's tests hold its engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cycle_model as jcycle
from repro.core import encoder as jencoder
from repro.core import reference as jreference
from repro.core import schemes as jschemes
from repro_torch import core as tcore
from repro_torch.core import cycle_model as tcycle
from repro_torch.core import encoder as tencoder
from repro_torch.core import reference as treference
from repro_torch.core import schemes as tschemes
from repro_torch.core.compressor import compress_blocks_records
from repro_torch.core.corpus import corpus_files
from repro_torch.core.decoder import decode_block
from repro_torch.core.lz4_types import Sequence, plan_size

from test_torch_util import PARAM_SWEEP, adversarial_corpus, pad_stack

NAMES = list(adversarial_corpus().keys())
FILES = ["paper1", "progc", "obj1", "pic"]


def _data(name: str) -> bytes:
    if name in FILES:
        return corpus_files()[name][:16384]
    return adversarial_corpus()[name]


def _same_result(a, b) -> None:
    """Two dataclass results (either package) hold equal fields."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, f.name)
        else:
            assert [dataclasses.astuple(s) for s in x] == [dataclasses.astuple(s) for s in y], f.name


@pytest.mark.parametrize("name", NAMES + FILES)
def test_reference_primitives_and_greedy_equal_jax(name):
    data = _data(name)
    buf = np.frombuffer(data, np.uint8)
    w, jw = treference.le32_words(buf), jreference.le32_words(buf)
    assert w.dtype == jw.dtype
    np.testing.assert_array_equal(w, jw)
    for hb in (8, 12, 16):
        h = treference.fib_hash(w, hb)
        np.testing.assert_array_equal(h, jreference.fib_hash(jw, hb))
        np.testing.assert_array_equal(treference.prev_same_hash(h),
                                      jreference.prev_same_hash(h))
    for hb, mm in ((12, None), (8, 36), (12, 68)):
        plan = treference.compress_greedy(data, hash_bits=hb, max_match=mm)
        jplan = jreference.compress_greedy(data, hash_bits=hb, max_match=mm)
        assert [dataclasses.astuple(s) for s in plan] == [dataclasses.astuple(s) for s in jplan]
        block = tencoder.encode_block(data, plan)
        assert block == jencoder.encode_block(data, jplan)
        assert decode_block(block) == data and len(block) == plan_size(plan)
    assert treference.compression_ratio(1000, 400) == \
        jreference.compression_ratio(1000, 400)


@pytest.mark.parametrize("name", NAMES + FILES)
@pytest.mark.parametrize("hash_bits,max_match,pws",
                         PARAM_SWEEP + [(12, None, 8)])
def test_windowed_golden_model_equals_jax(name, hash_bits, max_match, pws):
    data = _data(name)
    res = tschemes.compress_windowed(data, hash_bits=hash_bits, pws=pws,
                                     max_match=max_match)
    jres = jschemes.compress_windowed(data, hash_bits=hash_bits, pws=pws,
                                      max_match=max_match)
    _same_result(res, jres)
    plan = tschemes.plan_from_matches(len(data), res.emit, res.pos,
                                      res.length, res.offset)
    assert plan == res.sequences
    assert tencoder.encode_block(data, plan) == \
        jencoder.encode_block(data, jres.sequences)
    h = treference.fib_hash(treference.le32_words(np.frombuffer(data, np.uint8)),
                            hash_bits)
    np.testing.assert_array_equal(tschemes.window_candidates(h, pws),
                                  jschemes.window_candidates(h, pws))


@pytest.mark.parametrize("name", ["text", "rle_runs", "low_entropy",
                                  "structured", "incompressible_short",
                                  "empty", "short_13", "paper1", "pic"])
@pytest.mark.parametrize("pws", [4, 8, 16])
def test_multi_match_model_and_cycle_model_equal_jax(name, pws):
    data = _data(name)
    res = tschemes.compress_windowed_multi(data, hash_bits=12, pws=pws)
    jres = jschemes.compress_windowed_multi(data, hash_bits=12, pws=pws)
    _same_result(res, jres)
    n = len(data)
    assert tcycle.ours_cycles(n, pws) == jcycle.ours_cycles(n, pws)
    assert tcycle.baseline_cycles(res, n, pws) == jcycle.baseline_cycles(jres, n, pws)
    for ours, theirs in ((tcycle.ours_throughput(max(n, 1), pws),
                          jcycle.ours_throughput(max(n, 1), pws)),
                         (tcycle.baseline_throughput(res, max(n, 1), pws),
                          jcycle.baseline_throughput(jres, max(n, 1), pws))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tcycle.peak_gbps(pws) == jcycle.peak_gbps(pws)
    assert (tcycle.PIPELINE_DEPTH, tcycle.FREQ_OURS_MHZ, tcycle.FREQ_BENES_MHZ) == \
        (jcycle.PIPELINE_DEPTH, jcycle.FREQ_OURS_MHZ, jcycle.FREQ_BENES_MHZ)


@pytest.mark.parametrize("bad", [
    [Sequence(0, 3)],                                   # does not cover
    [Sequence(0, 2, 4, 1), Sequence(6, 0, 4, 1)],       # last has a match
    [Sequence(0, 3), Sequence(3, 7)],                   # interior lacks one
], ids=["coverage", "last_match", "interior"])
def test_encoder_refuses_bad_plans_like_jax(bad):
    data = b"abcabcabca"
    with pytest.raises(ValueError) as ours:
        tencoder.encode_block(data, bad)
    with pytest.raises(ValueError) as theirs:
        jencoder.encode_block(data, bad)
    assert str(ours.value) == str(theirs.value)


def test_core_exports_the_host_models():
    assert tcore.compress_greedy is treference.compress_greedy
    assert tcore.compression_ratio is treference.compression_ratio
    assert tcore.compress_windowed is tschemes.compress_windowed
    assert tcore.compress_windowed_multi is tschemes.compress_windowed_multi
    assert tcore.encode_block is tencoder.encode_block


@pytest.mark.parametrize("impl", ["sort", "sortkey", "scatter", "fused"])
@pytest.mark.parametrize("hash_bits,max_match,pws", [(8, 36, 8), (6, 12, 8)])
def test_engine_records_equal_golden_model(impl, hash_bits, max_match, pws):
    """The port's batched records (every candidate stage) == the port's
    golden model, window by window, as test_lz4_jax holds the reference."""
    names = ["text", "rle_runs", "tile_straddle", "short_13", "empty",
             "low_entropy"]
    blocks = [_data(k) for k in names]
    stack, ns = pad_stack(blocks, garbage_seed=11)
    rec = compress_blocks_records(
        torch.from_numpy(stack), torch.from_numpy(ns), hash_bits=hash_bits,
        max_match=max_match, pws=pws, candidate_impl=impl)
    for j, data in enumerate(blocks):
        golden = tschemes.compress_windowed(data, hash_bits=hash_bits, pws=pws,
                                            max_match=max_match)
        W = len(golden.emit)
        emit = rec.emit[j].numpy()
        np.testing.assert_array_equal(emit[:W], golden.emit, names[j])
        assert not emit[W:].any()
        for k in ("pos", "length", "offset"):
            np.testing.assert_array_equal(
                getattr(rec, k)[j].numpy()[:W][emit[:W]],
                getattr(golden, k)[golden.emit], (names[j], k))
        assert int(rec.size[j]) == plan_size(golden.sequences)
