"""The port's copy of the NumPy decode planner against the reference's:
plans, `execute_plan`, `execute_device_plan`, `to_device_plan` (waves and
overflow) and the planners' rejections, on the adversarial corpus, on
compressor output and on seeded random plans.  Arrays and bytes: equality.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import decode_plan as jplan
from repro.core.decoder import LZ4FormatError as JaxFormatError
from repro_torch.core import decode_plan as tplan
from repro_torch.core.decoder import LZ4FormatError
from repro_torch.core.lz4_types import Sequence

from test_torch_util import (
    BLOCK_NAMES,
    MAX_BLOCK,
    block_corpus,
    encode,
    lying_corpus,
    rng,
)

PLAN_FIELDS = ("lit_src", "lit_dst", "lit_len", "match_dst", "match_src",
               "match_len")


def random_plan_blocks(count: int = 20):
    """Seeded random token streams (overlapping matches, chains)."""
    r = rng(20260801)
    for _ in range(count):
        src = r.integers(0, 256, 4096, np.uint8).tobytes()
        data = bytearray()
        seqs = []
        cursor = 0
        for _ in range(int(r.integers(1, 40))):
            lit = int(r.integers(0, 30))
            lit_start = len(data)
            data += src[cursor:cursor + lit]
            cursor += lit
            if not data:
                continue
            offset = int(r.integers(1, min(len(data), 65535) + 1))
            mlen = int(r.integers(4, 60))
            if lit_start == 0 and lit == 0:
                continue
            seqs.append(Sequence(lit_start, lit, mlen, offset))
            s = len(data) - offset
            for j in range(mlen):
                data.append(data[s + j])
        seqs.append(Sequence(len(data), 0))
        yield bytes(data), encode(bytes(data), seqs)


def assert_plans_equal(a, b, label):
    assert a.usize == b.usize, label
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


def assert_device_plans_equal(a, b, label):
    for f in dataclasses.fields(b):
        if f.name == "caps":
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, (label, f.name)
            np.testing.assert_array_equal(va, vb, err_msg=f"{label} {f.name}")
        else:
            assert va == vb, (label, f.name)


@pytest.mark.parametrize("name", BLOCK_NAMES)
def test_plans_and_execution_equal_reference(name):
    blk = block_corpus()[name]
    for planner in ("plan_block", "plan_block_fast"):
        tp = getattr(tplan, planner)(blk)
        jp = getattr(jplan, planner)(blk)
        assert_plans_equal(tp, jp, (name, planner))
    out = tplan.execute_plan(blk, tp).tobytes()
    assert out == jplan.execute_plan(blk, jp).tobytes()
    assert tplan.execute_device_plan(blk, tp).tobytes() == out
    assert tplan.decode_block_planned(blk) == jplan.decode_block_planned(blk) == out
    assert tplan.decode_block_planned(blk, fast=False) == out
    for waves in (True, False):
        assert_device_plans_equal(tplan.to_device_plan(tp, compute_waves=waves),
                                  jplan.to_device_plan(jp, compute_waves=waves),
                                  (name, waves))


def test_block_names_cover_the_corpus():
    assert sorted(BLOCK_NAMES) == sorted(block_corpus())


def test_random_plans_equal_reference():
    for data, blk in random_plan_blocks():
        tp = tplan.plan_block_fast(blk)
        assert_plans_equal(tp, jplan.plan_block_fast(blk), "random")
        assert tplan.execute_device_plan(blk, tp).tobytes() == data
        assert tplan.execute_plan(blk, tp).tobytes() == data
        assert_device_plans_equal(tplan.to_device_plan(tp),
                                  jplan.to_device_plan(jplan.plan_block_fast(blk)),
                                  "random")


def test_device_plan_waves_caps_and_overflow():
    blk = block_corpus()["zeros"]
    dp = tplan.to_device_plan(tplan.plan_block_fast(blk))
    assert dp.n_waves == tplan.MAX_RESOLVE_ROUNDS == jplan.MAX_RESOLVE_ROUNDS
    assert (dp.wave[dp.n_match:] == -1).all()
    assert tplan.DevicePlanCaps() == tplan.DevicePlanCaps(**dataclasses.asdict(
        jplan.DevicePlanCaps()))
    tiny = dict(max_lit=2, max_match=2)
    plan_t = tplan.plan_block_fast(block_corpus()["cmp_text"])
    plan_j = jplan.plan_block_fast(block_corpus()["cmp_text"])
    with pytest.raises(tplan.DevicePlanOverflow) as et:
        tplan.to_device_plan(plan_t, tplan.DevicePlanCaps(**tiny))
    with pytest.raises(jplan.DevicePlanOverflow) as ej:
        jplan.to_device_plan(plan_j, jplan.DevicePlanCaps(**tiny))
    assert str(et.value) == str(ej.value)
    small = dict(out_cap=100)
    with pytest.raises(tplan.DevicePlanOverflow) as et:
        tplan.to_device_plan(plan_t, tplan.DevicePlanCaps(**small))
    with pytest.raises(jplan.DevicePlanOverflow) as ej:
        jplan.to_device_plan(plan_j, jplan.DevicePlanCaps(**small))
    assert str(et.value) == str(ej.value)


def _outcome(fn, *a, **k):
    try:
        return "ok", fn(*a, **k)
    except (LZ4FormatError, JaxFormatError) as e:
        return "err", str(e)


def test_rejections_equal_reference():
    cases = list(lying_corpus().values())
    blocks = block_corpus()
    for name in ("cmp_text", "rle_274", "final_ext"):
        blk = blocks[name]
        cases += [(blk[:cut], MAX_BLOCK) for cut in range(0, len(blk), max(1, len(blk) // 40))]
        r = rng(len(blk))
        for _ in range(30):
            m = bytearray(blk)
            m[int(r.integers(0, len(blk)))] = int(r.integers(0, 256))
            cases.append((bytes(m), MAX_BLOCK))
    # A long literal block, so the vectorized planner (>= 2048 bytes) runs.
    big = blocks["lit_text"]
    cases += [(big[:cut], MAX_BLOCK) for cut in (2047, 2048, 3000, len(big) - 1)]
    cases += [(big, len(big) - 1)]
    for blk, max_out in cases:
        for planner in ("plan_block", "plan_block_fast"):
            kt, vt = _outcome(getattr(tplan, planner), blk, max_out=max_out)
            kj, vj = _outcome(getattr(jplan, planner), blk, max_out=max_out)
            assert kt == kj, (planner, blk[:16], max_out)
            if kt == "err":
                assert vt == vj
            else:
                assert_plans_equal(vt, vj, planner)
    assert tplan._ERR_MESSAGES == jplan._ERR_MESSAGES
