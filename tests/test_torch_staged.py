"""The staged compress path (``candidate_impl="sort"|"sortkey"|"scatter"``)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through `repro.kernels.ops.hash_positions` /
`match_lengths` (the jnp twins and the Pallas kernels in interpret mode),
the three JAX candidate stages, the JAX `compress_block_records` and the JAX
engine, and through their counterparts in the port on CPU tensors (where the
`fibhash` and `match_extend` wrappers run their plain versions).  Every
output is an integer or a byte: tolerance zero.

The candidate arrays are compared over ALL P positions, including those that
cannot hold a match (p > n - 4), where the three JAX stages disagree with
each other (the int32 key ``h * P + p`` wraps at hash_bits 16): the port is
held against each stage on its own.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LZ4Engine as JaxEngine
from repro.core import jax_compressor as jc
from repro.kernels import ops as jops
from repro_torch import LZ4Engine, compat, decode_frame_serial
from repro_torch.core import compressor as tc
from repro_torch.kernels import _build
from repro_torch.kernels import fibhash as tfib
from repro_torch.kernels import match_extend as text
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_util import MAX_BLOCK, adversarial_corpus, multiblock_corpus, pad_stack

STAGED = ["sort", "sortkey", "scatter"]
JAX_CANDIDATES = {"sort": jc._candidates, "sortkey": jc._candidates_sortkey,
                  "scatter": jc._candidates_scatter}
NAMES = list(adversarial_corpus().keys())
CAND_NAMES = ["text", "rle_runs", "top_bit_words", "short_13", "one_byte",
              "empty", "all_zero_block", "tile_straddle"]
MICRO_BATCH = 4


def _masked(blocks: list[bytes], garbage_seed=None):
    """(M, B) uint8 stack zeroed past n (what the staged path hashes) and ns."""
    stack, ns = pad_stack(blocks, garbage_seed=garbage_seed)
    idx = np.arange(stack.shape[1])[None, :]
    return np.where(idx < ns[:, None], stack, 0).astype(np.uint8), ns


# -- hash_positions ----------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["twin", "pallas"])
@pytest.mark.parametrize("n", [2048, 4096, 65536, 3000, 5555])
@pytest.mark.parametrize("bits", [6, 8, 12, 13, 16])
def test_hash_positions_equal_reference(n, bits, use_pallas):
    rng = np.random.default_rng(n * 31 + bits)
    block = rng.integers(0, 256, n + 3, dtype=np.int32)
    block[3::7] |= 0x80                      # words with the top bit set
    w_ref, h_ref = jops.hash_positions(jnp.asarray(block), hash_bits=bits,
                                       use_pallas=use_pallas)
    w, h = tops.hash_positions(torch.from_numpy(block.astype(np.uint8))[None],
                               hash_bits=bits)
    assert w.shape == h.shape == (1, n) and w.dtype == h.dtype == torch.int32
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(h[0].numpy(), np.asarray(h_ref))
    assert (w[0].numpy() < 0).any()          # the uint32 bit pattern, as int32


def test_hash_positions_take_a_prefix_without_copying():
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, 256, (3, 5000), np.uint8))
    w_all, h_all = tops.hash_positions(rows, 8)
    w, h = tops.hash_positions(rows, 8, positions=4096)
    assert w_all.shape == (3, 4997)
    assert torch.equal(w, w_all[:, :4096]) and torch.equal(h, h_all[:, :4096])


# -- match_lengths -----------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["twin", "pallas"])
@pytest.mark.parametrize("n", [1024, 2048, 65536, 2500])
@pytest.mark.parametrize("max_match", [12, 20, 36, 68])
def test_match_lengths_equal_reference(n, max_match, use_pallas):
    rng = np.random.default_rng(n * 7 + max_match)
    block = rng.integers(0, 4, n + max_match, dtype=np.int32)
    cand = rng.integers(0, np.maximum(1, n - 64), n, dtype=np.int32)
    valid = rng.random(n) < 0.5
    ref = np.asarray(jops.match_lengths(
        jnp.asarray(block), jnp.asarray(cand), jnp.asarray(valid), n,
        max_match=max_match, use_pallas=use_pallas))
    got = tops.match_lengths(
        torch.from_numpy(block.astype(np.uint8))[None],
        torch.from_numpy(cand)[None], torch.from_numpy(valid)[None],
        torch.tensor([n], dtype=torch.int32), max_match=max_match)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), ref)


@pytest.mark.parametrize("max_match", [12, 36, 68])
def test_match_lengths_ignore_garbage_candidates_where_not_valid(max_match):
    """cand where ~valid is garbage (negative, past the row): the result
    there is 0 and the rest is unchanged — and equal to the reference's."""
    rng = np.random.default_rng(max_match)
    n = 4096
    block = rng.integers(0, 3, n + max_match, dtype=np.int32)
    cand = rng.integers(0, n - 64, n, dtype=np.int32)
    valid = rng.random(n) < 0.5
    bad = cand.copy()
    bad[~valid] = rng.choice([-1, -(1 << 31), n + max_match, 1 << 30,
                              (1 << 31) - 1], (~valid).sum())
    ref = np.asarray(jops.match_lengths(jnp.asarray(block), jnp.asarray(bad),
                                        jnp.asarray(valid), n,
                                        max_match=max_match))
    args = [torch.from_numpy(block.astype(np.uint8))[None], None,
            torch.from_numpy(valid)[None], torch.tensor([n], dtype=torch.int32)]
    outs = []
    for c in (cand, bad):
        args[1] = torch.from_numpy(c)[None]
        outs.append(tops.match_lengths(*args, max_match=max_match)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], ref)
    assert (outs[1][~valid] == 0).all()


def test_match_lengths_against_python_oracle():
    """The bounded prefix semantics against a dead-simple Python loop."""
    rng = np.random.default_rng(0)
    n, max_match = 2048, 36
    block = rng.integers(0, 3, n + max_match, dtype=np.uint8)
    cand = rng.integers(0, n - 64, n, dtype=np.int32)
    out = tops.match_lengths(torch.from_numpy(block)[None],
                             torch.from_numpy(cand)[None],
                             torch.ones((1, n), dtype=torch.bool),
                             torch.tensor([n], dtype=torch.int32),
                             max_match=max_match)[0].numpy()
    for p in rng.integers(0, n, 200):
        q = cand[p]
        cap = max(min(max_match - 4, n - 5 - (p + 4)), 0)
        e = 0
        while e < cap and block[p + 4 + e] == block[q + 4 + e]:
            e += 1
        assert out[p] == 4 + e, (p, q, out[p], 4 + e)


def test_match_lengths_end_of_block_cap():
    """All-zero rows: every extension runs to its cap (max_match and the
    last-five-literals rule)."""
    n = 2048
    out = tops.match_lengths(torch.zeros((2, n + 36), dtype=torch.uint8),
                             torch.zeros((2, n), dtype=torch.int32),
                             torch.ones((2, n), dtype=torch.bool),
                             torch.tensor([n, 100], dtype=torch.int32),
                             max_match=36).numpy()
    p = np.arange(n)
    np.testing.assert_array_equal(out[0], 4 + np.clip(n - 5 - (p + 4), 0, 32))
    np.testing.assert_array_equal(out[1], 4 + np.clip(100 - 5 - (p + 4), 0, 32))


# -- the three candidate stages ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _hashes(hash_bits: int):
    masked, ns = _masked([adversarial_corpus()[k] for k in CAND_NAMES],
                         garbage_seed=5)
    _, h = tops.hash_positions(torch.from_numpy(masked), hash_bits,
                               positions=MAX_BLOCK)
    return h, ns


@pytest.mark.parametrize("impl", ["sort", "sortkey"])
@pytest.mark.parametrize("hash_bits", [8, 16])
def test_sort_candidates_equal_reference_at_every_position(impl, hash_bits):
    h, ns = _hashes(hash_bits)
    cand = tc._CANDIDATE_FNS[impl](h, torch.from_numpy(ns), hash_bits, 8)
    assert cand.dtype == torch.int32 and cand.shape == h.shape
    for j, name in enumerate(CAND_NAMES):
        ref = JAX_CANDIDATES[impl](jnp.asarray(h[j].numpy()), jnp.int32(int(ns[j])),
                                   hash_bits, 8)
        np.testing.assert_array_equal(cand[j].numpy(), np.asarray(ref), name)


@pytest.mark.parametrize("hash_bits,positions", [(8, MAX_BLOCK), (16, 2048)])
def test_scatter_candidates_equal_reference_at_every_position(hash_bits, positions):
    """At hash_bits 16 the scatter grid is (P / pws) x 2^16 int32 — 2 GiB per
    row at P = 65536 in either package — so that case runs over the first
    2048 positions (the stage takes any P); its arithmetic has no int32 key
    to wrap."""
    h, ns = _hashes(hash_bits)
    h = h[:, :positions].contiguous()
    ns = np.minimum(ns, positions)
    cand = tc._CANDIDATE_FNS["scatter"](h, torch.from_numpy(ns), hash_bits, 8)
    for j, name in enumerate(CAND_NAMES):
        ref = jc._candidates_scatter(jnp.asarray(h[j].numpy()),
                                     jnp.int32(int(ns[j])), hash_bits, 8)
        np.testing.assert_array_equal(cand[j].numpy(), np.asarray(ref), name)


def test_sortkey_sentinel_wraps_like_the_reference():
    """At hash_bits 16 the sentinel bucket's key 2^16 * 2^16 + p wraps to p
    (int32), so `key >> 16` reads it as hash 0 — the port keeps that."""
    h, ns = _hashes(16)
    key = tc._sorted_key(h, torch.from_numpy(ns), 16)[1]
    p = torch.arange(MAX_BLOCK, dtype=torch.int32)
    dead = p[None, :] > torch.from_numpy(ns)[:, None] - 4
    assert torch.equal(key[dead], p.expand_as(key)[dead])
    assert (key < 0).any()                   # hashes >= 2^15 wrap negative


# -- records, frames ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_records(impl: str):
    stack, ns = pad_stack([adversarial_corpus()[k] for k in NAMES], garbage_seed=9)
    rec = tc.compress_blocks_records(torch.from_numpy(stack), torch.from_numpy(ns),
                                     candidate_impl=impl)
    return stack, ns, compat.records_to_numpy(rec)


@pytest.mark.parametrize("impl", STAGED)
def test_records_equal_reference_on_the_adversarial_corpus(impl):
    stack, ns, got = _port_records(impl)
    for j, name in enumerate(NAMES):
        ref = jc.compress_block_records(jnp.asarray(stack[j]), jnp.int32(int(ns[j])),
                                        candidate_impl=impl)
        for k, v in got.items():
            np.testing.assert_array_equal(v[j], np.asarray(getattr(ref, k)), (name, k))
    # ... and the fused datapath's records, field by field
    fused = compat.records_to_numpy(tc.compress_blocks_records(
        torch.from_numpy(stack), torch.from_numpy(ns), candidate_impl="fused"))
    for k, v in got.items():
        np.testing.assert_array_equal(v, fused[k], k)


@pytest.mark.parametrize("impl", STAGED)
def test_records_equal_the_pallas_kernels_in_interpret_mode(impl):
    """One block through `use_pallas=True`: the reference's fibhash and
    match_extend Pallas kernels (interpret mode) produce the records."""
    stack, ns, got = _port_records(impl)
    j = NAMES.index("text")
    ref = jc.compress_block_records(jnp.asarray(stack[j]), jnp.int32(int(ns[j])),
                                    candidate_impl=impl, use_pallas=True)
    for k, v in got.items():
        np.testing.assert_array_equal(v[j], np.asarray(getattr(ref, k)), k)


@functools.lru_cache(maxsize=None)
def _fused_frame(scan_impl: str):
    return LZ4Engine(device="cpu", micro_batch=MICRO_BATCH,
                     scan_impl=scan_impl).compress(multiblock_corpus())


@pytest.mark.parametrize("impl", STAGED)
def test_engine_frames_equal_reference_and_fused(impl):
    data = multiblock_corpus()
    ref = JaxEngine(micro_batch=MICRO_BATCH, candidate_impl=impl)
    ref_frame = ref.compress(data)
    eng = LZ4Engine(device="cpu", micro_batch=MICRO_BATCH, candidate_impl=impl)
    frame = eng.compress(data)
    assert frame == ref_frame == _fused_frame("sequential")
    assert eng.stats.candidate_impl == ref.stats.candidate_impl == impl
    for f in ("blocks", "dispatches", "raw_blocks", "bytes_out", "host_bytes"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert decode_frame_serial(frame) == data


@pytest.mark.parametrize("impl", STAGED)
def test_engine_staged_frames_with_associative_scan_and_host_emit(impl):
    data = multiblock_corpus()
    for kw in (dict(scan_impl="associative"), dict(device_emit=False)):
        eng = LZ4Engine(device="cpu", micro_batch=MICRO_BATCH,
                        candidate_impl=impl, **kw)
        assert eng.compress(data) == _fused_frame(kw.get("scan_impl", "sequential"))


# -- wrappers ----------------------------------------------------------------

def test_fibhash_wrapper_checks_and_counts_no_cpu_launch():
    rows = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 100), np.uint8))
    before = tfib.launches
    w, h = tfib.fibhash(rows, 97, 8)
    assert tfib.launches == before           # the CPU path launches nothing
    assert tfib.fibhash_plain(rows, 97, 8)[0].equal(w)
    with pytest.raises(TypeError):
        tfib.fibhash(rows.to(torch.int32), 97)
    with pytest.raises(ValueError):
        tfib.fibhash(rows[0], 97)
    with pytest.raises(ValueError):
        tfib.fibhash(rows, 98)               # a word needs p + 3 < B
    for bits in (0, 33):
        with pytest.raises(ValueError):
            tfib.fibhash(rows, 97, bits)
    assert "fibhash" in _build.KERNEL_SOURCES


def test_match_extend_wrapper_checks_and_counts_no_cpu_launch():
    blocks = torch.zeros((2, 200), dtype=torch.uint8)
    cand = torch.zeros((2, 128), dtype=torch.int32)
    valid = torch.ones((2, 128), dtype=torch.uint8)
    ns = torch.tensor([150, 20], dtype=torch.int32)
    before = text.launches
    out = text.match_extend(blocks, cand, valid, ns, 36)
    assert text.launches == before           # the CPU path launches nothing
    assert text.match_extend_plain is tref.match_extend_ref
    assert out.equal(text.match_extend(blocks, cand, valid.to(torch.bool), ns, 36))
    with pytest.raises(TypeError):
        text.match_extend(blocks, cand.to(torch.int64), valid, ns)
    with pytest.raises(TypeError):
        text.match_extend(blocks, cand, valid.to(torch.int32), ns)
    with pytest.raises(TypeError):
        text.match_extend(blocks.to(torch.int32), cand, valid, ns)
    with pytest.raises(ValueError):
        text.match_extend(blocks, cand, valid[:, :64], ns)
    with pytest.raises(ValueError):
        text.match_extend(blocks, cand, valid, ns[:1])
    with pytest.raises(ValueError):
        text.match_extend(blocks, cand, valid, ns, max_match=3)
    with pytest.raises(ValueError):
        text.match_extend(blocks[:, :0], cand, valid, ns)
    assert "match_extend" in _build.KERNEL_SOURCES
