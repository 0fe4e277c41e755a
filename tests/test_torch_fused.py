"""The port's fused datapath against the reference's, elementwise.

The same seeded blocks go through `repro.kernels.ref.fused_ref` (jnp), the
Pallas kernel `fused_compress_pallas` in interpret mode, and the port's
`fused_match_candidates` on CPU tensors (which runs the plain PyTorch
version of the CUDA kernel).  All outputs are integers: tolerance zero.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fused_compress as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_util import MAX_BLOCK, PARAM_SWEEP, adversarial_corpus, pad_stack

NAMES = list(adversarial_corpus().keys())
PALLAS_NAMES = ["text", "all_zero_block", "structured", "tile_straddle",
                "incompressible_short", "rle_runs", "empty", "top_bit_words",
                "short_12"]
SWEEP_NAMES = ["text", "low_entropy", "all_zero_short", "tile_straddle",
               "top_bit_words"]


def _jax_fused(data: bytes, use_pallas=False, **kw):
    stack, ns = pad_stack([data])
    blk = jnp.asarray(stack[0], jnp.int32)
    c, l = jops.fused_match_candidates(blk, jnp.int32(int(ns[0])),
                                       positions=MAX_BLOCK,
                                       use_pallas=use_pallas, **kw)
    return np.asarray(c), np.asarray(l)


@functools.lru_cache(maxsize=None)
def _torch_fused_all(names: tuple, garbage: bool = False, **kw):
    """ONE batched call over all named blocks (the port has no vmap)."""
    corpus = adversarial_corpus()
    stack, ns = pad_stack([corpus[k] for k in names],
                          garbage_seed=7 if garbage else None)
    c, l = tops.fused_match_candidates(
        torch.from_numpy(stack), torch.from_numpy(ns), positions=MAX_BLOCK, **kw)
    assert c.dtype == torch.int32 and l.dtype == torch.int32
    return {k: (c[j].numpy(), l[j].numpy()) for j, k in enumerate(names)}


@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_reference_twin(name):
    c_ref, l_ref = _jax_fused(adversarial_corpus()[name])
    c, l = _torch_fused_all(tuple(NAMES))[name]
    np.testing.assert_array_equal(c, c_ref, name)
    np.testing.assert_array_equal(l, l_ref, name)


@pytest.mark.parametrize("name", PALLAS_NAMES)
def test_fused_equals_pallas_interpret(name):
    c_ref, l_ref = _jax_fused(adversarial_corpus()[name], use_pallas=True)
    c, l = _torch_fused_all(tuple(NAMES))[name]
    np.testing.assert_array_equal(c, c_ref, name)
    np.testing.assert_array_equal(l, l_ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_fused_ignores_bytes_past_n(name):
    """Garbage past the true length must not change a single output."""
    clean = _torch_fused_all(tuple(NAMES))[name]
    dirty = _torch_fused_all(tuple(NAMES), garbage=True)[name]
    np.testing.assert_array_equal(clean[0], dirty[0], name)
    np.testing.assert_array_equal(clean[1], dirty[1], name)


@pytest.mark.parametrize("hash_bits,max_match,pws", PARAM_SWEEP)
def test_fused_param_sweep(hash_bits, max_match, pws):
    kw = dict(hash_bits=hash_bits, max_match=max_match, pws=pws)
    # hash_bits = 12 materializes a 128 MB grid per block in the plain
    # version: one block is enough there.
    names = SWEEP_NAMES[:1] if hash_bits >= 12 else SWEEP_NAMES
    got = _torch_fused_all(tuple(names), **kw)
    for name in names:
        c_ref, l_ref = _jax_fused(adversarial_corpus()[name], **kw)
        np.testing.assert_array_equal(got[name][0], c_ref, (name, kw))
        np.testing.assert_array_equal(got[name][1], l_ref, (name, kw))


def test_fused_sweep_corner_equals_pallas():
    kw = dict(hash_bits=10, max_match=68, pws=4)
    c_ref, l_ref = _jax_fused(adversarial_corpus()["text"], use_pallas=True, **kw)
    c, l = _torch_fused_all(tuple(SWEEP_NAMES), **kw)["text"]
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_array_equal(l, l_ref)


def test_fibhash_matches_reference_on_top_bit_words():
    from repro.kernels import ref as jref

    r = np.random.default_rng(5)
    b = r.integers(0, 256, (4, 4096), np.uint8)
    b[3, ::2] |= 0x80
    for hb in (6, 8, 12, 16):
        w_ref, h_ref = jref.fibhash_ref(*(jnp.asarray(x, jnp.int32) for x in b), hb)
        w, h = tref.fibhash_ref(*(torch.from_numpy(x) for x in b), hb)
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
        np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))


def test_fused_structure_and_chunked_batch():
    got = _torch_fused_all(tuple(NAMES))
    for name, (cand, lengths) in got.items():
        assert ((lengths == 0) | (lengths >= 4)).all(), name
        live = lengths > 0
        assert (cand[live] >= 0).all()
        assert (cand[live] // 8 < np.nonzero(live)[0] // 8).all(), name
    # A grid budget of one block forces the row-chunked path: same answer.
    names = ("text", "structured", "short_13")
    stack, ns = pad_stack([adversarial_corpus()[k] for k in names])
    old = tref._GRID_ELEMS
    tref._GRID_ELEMS = 1
    try:
        c, l = tref.fused_ref(torch.from_numpy(stack), torch.from_numpy(ns),
                              MAX_BLOCK, 8, 8, 36)
    finally:
        tref._GRID_ELEMS = old
    for j, k in enumerate(names):
        np.testing.assert_array_equal(c[j].numpy(), got[k][0])
        np.testing.assert_array_equal(l[j].numpy(), got[k][1])


def test_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    stack, ns = pad_stack([b"abcd" * 10])
    blocks, nst = torch.from_numpy(stack), torch.from_numpy(ns)
    before = tfused.launches
    tfused.fused_compress(blocks, nst, MAX_BLOCK)
    assert tfused.launches == before          # the CPU path launches nothing
    assert tfused.fused_compress_plain is tref.fused_ref
    with pytest.raises(TypeError):
        tfused.fused_compress(blocks.to(torch.int32), nst, MAX_BLOCK)
    with pytest.raises(TypeError):
        tfused.fused_compress(blocks, nst.to(torch.int64), MAX_BLOCK)
    with pytest.raises(ValueError):
        tfused.fused_compress(blocks[0], nst, MAX_BLOCK)
    with pytest.raises(ValueError):
        tfused.fused_compress(blocks, nst, MAX_BLOCK, max_match=100)
    with pytest.raises(ValueError):
        tfused.fused_compress(blocks, nst, MAX_BLOCK, pws=7)


def test_launch_plan_fits_shared_memory():
    B = MAX_BLOCK + 71
    for hb, pws in [(8, 8), (6, 8), (10, 4), (12, 8), (8, 16), (13, 8),
                    (16, 8), (8, 2048), (8, 64)]:
        plan = tfused._plan(B, MAX_BLOCK, hb, pws)
        assert 1 <= plan.cluster <= 8 and 1 <= plan.nseg <= 32
        # each CTA's range and each segment are whole windows
        assert (MAX_BLOCK // plan.cluster) % (plan.nseg * max(32, pws)) == 0
        assert plan.tab_off >= MAX_BLOCK + 32 and plan.tab_off % 16 == 0
        assert plan.lc_off % 16 == 0 and plan.smem_bytes <= tfused._SMEM_LIMIT
        assert plan.tables_in_shared == (plan.lc_off > plan.tab_off)
        assert not plan.wide
    assert tfused._plan(B, MAX_BLOCK, 8, 8)[:2] == (tfused.CLUSTER, 32)
    assert tfused._plan(B, MAX_BLOCK, 16, 8).tables_in_shared is False
