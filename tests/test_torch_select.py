"""The port's window select (both forms) and `_plan_size` against the
reference's, on seeded `valid` / `lengths` including all-false and all-true
windows.  Integers: tolerance zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_compressor as jc
from repro_torch.core import compressor as tc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import window_select as tsel

from test_torch_util import rng

P = 4096  # small position count: the select stages are shape-generic


def _case(kind: str, seed: int, max_match: int):
    r = rng(seed)
    lengths = r.integers(4, max_match + 1, P).astype(np.int32)
    if kind == "sparse":
        valid = r.random(P) < 0.05
    elif kind == "dense":
        valid = r.random(P) < 0.7
    elif kind == "all_false":
        valid = np.zeros(P, bool)
    elif kind == "all_true":
        valid = np.ones(P, bool)
    elif kind == "mixed_windows":
        # Runs of all-false and all-true windows side by side.
        valid = np.repeat(r.random(P // 32) < 0.5, 32)
    else:
        raise ValueError(kind)
    # As in the compressor: an invalid position has length 0.
    lengths = np.where(valid, lengths, 0).astype(np.int32)
    if kind == "mixed_windows":
        # ... except that the raw length at a window base is what an empty
        # window reports, so make some of those non-zero too.
        lengths[::64] = 9
    return valid, lengths


KINDS = ["sparse", "dense", "all_false", "all_true", "mixed_windows"]
CONFIGS = [(8, 36), (4, 68), (16, 36), (32, 20)]


def _torch_select(fn, valid, lengths, *a):
    e, p, l = fn(torch.from_numpy(valid), torch.from_numpy(lengths), *a)
    assert e.dtype == torch.bool and p.dtype == l.dtype == torch.int32
    return e.numpy(), p.numpy(), l.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pws,max_match", CONFIGS)
def test_select_forms_equal_reference(kind, pws, max_match):
    valid, lengths = _case(kind, pws * 100 + max_match, max_match)
    ref = [np.asarray(x) for x in jc._select_sequential(
        jnp.asarray(valid), jnp.asarray(lengths), pws)]
    ref_a = [np.asarray(x) for x in jc._select_associative(
        jnp.asarray(valid), jnp.asarray(lengths), pws, max_match)]
    # Batch of two (the second row reversed) through each form.
    v2 = np.stack([valid, valid[::-1].copy()])
    l2 = np.stack([lengths, lengths[::-1].copy()])
    seq = _torch_select(tc._select_sequential, v2, l2, pws)
    asc = _torch_select(tc._select_associative, v2, l2, pws, max_match)
    for got in (seq, asc):
        for g, r, ra in zip(got, ref, ref_a):
            np.testing.assert_array_equal(g[0], r)
            np.testing.assert_array_equal(g[0], ra)
    for s, a in zip(seq, asc):
        np.testing.assert_array_equal(s, a)   # row 1 too: the forms agree


@pytest.mark.parametrize("kind", KINDS)
def test_plan_size_equals_reference(kind):
    valid, lengths = _case(kind, 77, 36)
    emit, pos, length = (np.array(x) for x in jc._select_sequential(
        jnp.asarray(valid), jnp.asarray(lengths), 8))
    emit = emit & (length > 0)
    for n in (P, P - 3):
        ref = int(jc._plan_size(jnp.asarray(emit), jnp.asarray(pos),
                                jnp.asarray(length), jnp.int32(n)))
        got = tc._plan_size(torch.from_numpy(emit)[None],
                            torch.from_numpy(pos)[None],
                            torch.from_numpy(length)[None],
                            torch.tensor([n], dtype=torch.int32))
        assert got.dtype == torch.int32 and int(got[0]) == ref


def test_wrapper_checks():
    valid, lengths = _case("dense", 1, 36)
    v, l = torch.from_numpy(valid)[None], torch.from_numpy(lengths)[None]
    before = tsel.launches
    a = tsel.window_select(v, l, 8)
    b = tsel.window_select(v.to(torch.uint8), l, 8)     # uint8 validity too
    assert tsel.launches == before           # the CPU path launches nothing
    assert tsel.window_select_plain is tref.window_select_ref
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        tsel.window_select(v, l.to(torch.int64), 8)
    with pytest.raises(TypeError):
        tsel.window_select(v.to(torch.int32), l, 8)
    with pytest.raises(ValueError):
        tsel.window_select(v, l, 7)
    with pytest.raises(ValueError):
        tsel.window_select(v[0], l[0], 8)
