"""The read path's kernels, at the level of their plain versions and ops,
against the JAX package on the same seeded numpy inputs (tolerance zero):

  * `ref.decode_gather_ref`, `ref.plan_fields_ref` and `ref.crc32_ref`
    against `repro.kernels.ref` / `ops.crc32_bytes` / `binascii.crc32`;
  * `ops.decode_gather`, `ops.plan_speculative` (six plan columns and the
    status) and `ops.plan_decode` against `repro.kernels.ops`
    (``use_pallas=False``), and one case per Pallas kernel in interpret
    mode (``use_pallas=True``);
  * error-code parity on truncation and interior-flip sweeps, a stream
    whose sums wrap int32 after its first bad header, and `lit_blk`
    values out of range within `total`.

The CUDA kernels themselves are held against these plain versions on the
card by `chip_smoke.py` (phase `decode_kernels_check`).
"""
import binascii
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import decode_plan as tplan
from repro_torch.core.decode_engine import _spec_err_message
from repro_torch.core.decoder import LZ4FormatError
from repro_torch.kernels import _build
from repro_torch.kernels import crc32 as kcrc
from repro_torch.kernels import decode_wave as kwave
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan_speculative as kplan
from repro_torch.kernels import ref as tref

from test_torch_util import MAX_BLOCK, block_corpus, lying_corpus, rng

CAPS = tplan.DevicePlanCaps()
B_SPEC = CAPS.blk_cap + tops.SPEC_PAD
REF_ROWS = 16  # the reference is vmapped over batches of this many rows


def t32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def stack_payloads(blocks, width: int, garbage_seed: int | None = None):
    """(M, width) uint8 rows (zeros or seeded noise past each payload) and
    (M,) int32 lengths."""
    m = len(blocks)
    buf = (np.zeros((m, width), np.uint8) if garbage_seed is None
           else rng(garbage_seed).integers(0, 256, (m, width), np.uint8))
    ns = np.zeros((m,), np.int32)
    for j, b in enumerate(blocks):
        buf[j, : len(b)] = np.frombuffer(b, np.uint8)
        ns[j] = len(b)
    return buf, ns


def in_ref_batches(fn, *arrays):
    """Run a jitted, vmapped reference over rows in batches of REF_ROWS
    (one compiled shape), returning numpy arrays of all rows."""
    m = arrays[0].shape[0]
    pad = (-m) % REF_ROWS
    padded = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrays]
    outs = []
    for s in range(0, m + pad, REF_ROWS):
        res = fn(*(jnp.asarray(a[s: s + REF_ROWS]) for a in padded))
        res = res if isinstance(res, (tuple, list)) else (res,)
        outs.append([np.asarray(r) for r in res])
    return [np.concatenate(parts)[:m] for parts in zip(*outs)]


@functools.lru_cache(maxsize=None)
def ref_plan_speculative():
    return jax.jit(jax.vmap(functools.partial(
        jops.plan_speculative, max_lit=CAPS.max_lit, max_match=CAPS.max_match,
        out_cap=CAPS.out_cap)))


# -- plain versions ------------------------------------------------------------

def test_decode_gather_ref_equals_reference():
    """Random source maps, lit_blk out of range within total (negative,
    below -B, at and past B), every round bucket, ragged totals."""
    r = rng(31)
    M, B, K = 4, 300, 512
    block = r.integers(0, 256, (M, B), np.uint8)
    lit_blk = r.integers(-2 * B, 2 * B, (M, K)).astype(np.int32)
    lit_blk[:, :4] = [-1, -B, B, -B - 1]
    ptr = r.integers(0, K, (M, K)).astype(np.int32)
    total = np.array([K, 100, 0, K - 1], np.int32)
    for rounds in (0, 1, 2, 4, 8, 16):
        got = tref.decode_gather_ref(torch.from_numpy(block), t32(lit_blk),
                                     t32(ptr), t32(total), rounds).numpy()
        for m in range(M):
            want = np.asarray(jref.decode_gather_ref(
                jnp.asarray(block[m].astype(np.int32)), jnp.asarray(lit_blk[m]),
                jnp.asarray(ptr[m]), jnp.int32(total[m]), rounds))
            np.testing.assert_array_equal(got[m], want, err_msg=f"{rounds} {m}")
    # The wrapper on CPU tensors is the plain version, and counts nothing.
    before = kwave.launches
    out = kwave.decode_wave(torch.from_numpy(block), t32(lit_blk), t32(ptr),
                            t32(total), 16)
    assert kwave.launches == before
    np.testing.assert_array_equal(out.numpy(), tref.decode_gather_ref(
        torch.from_numpy(block), t32(lit_blk), t32(ptr), t32(total), 16).numpy())


def plan_field_rows():
    """Payload rows for the field kernel: corpus blocks, the lying corpus,
    truncations, n in {0, 1, 2, blk_cap}, a block of 0xFF bytes, noise."""
    corpus = block_corpus()
    rows = [corpus[k] for k in ("cmp_text", "zeros", "rle_529", "lit_text",
                                "final_ext", "lit_empty", "cmp_mixed")]
    rows += [b for b, _ in lying_corpus().values()]
    rows += [corpus["cmp_text"][:777], b"", b"\xf0", b"\x1f\x00"]
    rows += [b"\xff" * CAPS.blk_cap, rng(3).integers(0, 256, CAPS.blk_cap,
                                                     np.uint8).tobytes()]
    rows += [b"\x0f\x01\x00" + b"\xff" * 600 + b"\x07" + b"\x10B"]
    return rows


def test_plan_fields_ref_equals_reference():
    buf, ns = stack_payloads(plan_field_rows(), B_SPEC, garbage_seed=5)
    got = tref.plan_fields_ref(torch.from_numpy(buf), t32(ns))
    fn = jax.jit(jax.vmap(jref.plan_fields_ref))
    want = in_ref_batches(fn, buf.astype(np.int32), ns)
    for name, g, w in zip(kplan.FIELDS, got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # Through the wrapper (CPU tensors: the plain version).
    for g, w in zip(kplan.plan_speculative(torch.from_numpy(buf), t32(ns)), got):
        assert torch.equal(g, w)


def test_crc32_plain_equals_binascii_and_reference():
    r = rng(41)
    K = 4096
    ns = np.array([0, 1, 2, 3, 4, 5, 7, 8, 9, 63, 64, 65, 1000, 4095, 4096,
                   2048], np.int32)
    data = r.integers(0, 256, (len(ns), K), np.uint8)
    got = tref.crc32_ref(torch.from_numpy(data), t32(ns)).tolist()
    want = [binascii.crc32(data[j, : ns[j]].tobytes()) for j in range(len(ns))]
    assert got == want
    ref = in_ref_batches(jax.jit(jax.vmap(jops.crc32_bytes)), data, ns)[0]
    assert [int(v) for v in ref] == want
    # Rows of 64 KB, a row shorter than one chunk, the 1-D form of the op.
    big = r.integers(0, 256, (2, MAX_BLOCK), np.uint8)
    nb = np.array([MAX_BLOCK - 1, MAX_BLOCK], np.int32)
    assert kcrc.crc32(torch.from_numpy(big), t32(nb)).tolist() == [
        binascii.crc32(big[j, : nb[j]].tobytes()) for j in range(2)]
    small = torch.from_numpy(big[:1, :10].copy())
    assert int(tops.crc32_bytes(small[0], 7)) == binascii.crc32(big[0, :7].tobytes())
    assert tops.crc32_bytes(torch.zeros((0,), dtype=torch.uint8), 0).item() == 0


def test_crc_constants_match_the_kernel_source():
    """The x^(2^k) table hard-coded in csrc/crc32.cu is the one the plain
    version derives, and it repeats with period 32 (what the kernel's
    ``(k + 3) & 31`` relies on)."""
    src = (_build.CSRC / "crc32.cu").read_text()
    table = src[src.index("X2N[32]"): src.index("};", src.index("X2N[32]"))]
    consts = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", table)]
    x2n = tref.crc_x2n_table()
    assert consts == list(x2n)
    sq = int(tref._multmodp(x2n[31], np.array([x2n[31]], np.uint64))[0])
    assert sq == x2n[0]
    assert tref.crc_byte_table()[1] == 0x77073096


# -- ops ------------------------------------------------------------------------

OPS_BLOCKS = ("cmp_text", "zeros", "rle_529", "lit_text", "final_ext",
              "cmp_mixed")


def device_plans(names):
    corpus = block_corpus()
    plans = [tplan.to_device_plan(tplan.plan_block_fast(corpus[k])) for k in names]
    buf, _ = stack_payloads([corpus[k] for k in names], CAPS.blk_cap)
    cols = [np.stack([getattr(dp, f) for dp in plans]) for f in
            ("lit_src", "lit_dst", "lit_len", "match_dst", "match_off")]
    scal = [np.array([getattr(dp, f) for dp in plans], np.int32) for f in
            ("n_lit", "n_match", "out_size")]
    return plans, buf, cols, scal


def test_ops_decode_gather_equals_reference():
    plans, buf, cols, scal = device_plans(OPS_BLOCKS)
    corpus = block_corpus()
    depth = max(dp.n_waves for dp in plans)
    for rounds in (2, depth, tplan.MAX_RESOLVE_ROUNDS):
        got = tops.decode_gather(torch.from_numpy(buf), *map(t32, cols),
                                 *map(t32, scal), out_cap=CAPS.out_cap,
                                 rounds=rounds).numpy()
        fn = jax.jit(jax.vmap(functools.partial(
            jops.decode_gather, out_cap=CAPS.out_cap, rounds=rounds)))
        want = in_ref_batches(fn, buf, *cols, *scal)[0]
        np.testing.assert_array_equal(got, want, err_msg=str(rounds))
        if rounds >= depth:
            for j, k in enumerate(OPS_BLOCKS):
                dp = plans[j]
                assert got[j, : dp.out_size].tobytes() == tplan.execute_plan(
                    corpus[k], tplan.plan_block_fast(corpus[k])).tobytes()
                assert not got[j, dp.out_size:].any()


def spec_both(payloads, max_outs):
    """`ops.plan_speculative` of the port (one batch) and of the reference
    (vmapped), on the same rows: seven numpy arrays each."""
    buf, ns = stack_payloads(payloads, B_SPEC)
    mo = np.asarray(max_outs, np.int32)
    got = [t.numpy() for t in tops.plan_speculative(
        torch.from_numpy(buf), t32(ns), t32(mo), max_lit=CAPS.max_lit,
        max_match=CAPS.max_match, out_cap=CAPS.out_cap)]
    want = in_ref_batches(ref_plan_speculative(), buf, ns, mo)
    return got, want


def assert_spec_equal(got, want, label):
    names = ("lit_src", "lit_dst", "lit_len", "match_dst", "match_off",
             "match_len", "status")
    for n, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {n}")


def host_outcome(blk, max_out=MAX_BLOCK):
    try:
        tplan.plan_block_fast(blk, max_out=max_out)
        return None
    except LZ4FormatError as e:
        return str(e)


def test_ops_plan_speculative_equals_reference_and_host_planner():
    corpus = block_corpus()
    valid = [corpus[k] for k in OPS_BLOCKS] + [corpus["rle_274"], corpus["lit_empty"]]
    lying = list(lying_corpus().values())
    payloads = valid + [b for b, _ in lying]
    max_outs = [MAX_BLOCK] * len(valid) + [m for _, m in lying]
    got, want = spec_both(payloads, max_outs)
    assert_spec_equal(got, want, "corpus")
    status = got[-1]
    for j, blk in enumerate(valid):
        assert status[j, tops.SPEC_ERR] == 0
        dp = tplan.to_device_plan(tplan.plan_block(blk), compute_waves=False)
        assert status[j, tops.SPEC_N_LIT] == dp.n_lit
        assert status[j, tops.SPEC_N_MATCH] == dp.n_match
        assert status[j, tops.SPEC_OUT_SIZE] == dp.out_size
        np.testing.assert_array_equal(got[0][j], dp.lit_src)
        np.testing.assert_array_equal(got[4][j], dp.match_off)
    for j, (blk, mo) in enumerate(lying, start=len(valid)):
        msg = host_outcome(blk, mo)
        assert msg is not None and _spec_err_message(int(status[j, 0])) == msg
    assert (tops.SPEC_PAD, tops.SPEC_STATUS, tops.SPEC_ERR_MISSING_TOKEN) == \
        (jops.SPEC_PAD, jops.SPEC_STATUS, jops.SPEC_ERR_MISSING_TOKEN)


def _sweep_parity(payloads, label):
    got, want = spec_both(payloads, [MAX_BLOCK] * len(payloads))
    assert_spec_equal(got, want, label)
    status = got[-1]
    for j, blk in enumerate(payloads):
        msg = host_outcome(blk)
        err = int(status[j, tops.SPEC_ERR])
        if msg is None:
            assert err == 0, (label, j)
        else:
            assert err != 0 and _spec_err_message(err) == msg, (label, j, msg)


@pytest.mark.parametrize("name", ["cmp_text", "rle_274", "lit_text", "final_ext"])
def test_truncation_sweep_error_codes_equal(name):
    blk = block_corpus()[name]
    step = max(1, len(blk) // 60)
    _sweep_parity([blk[:cut] for cut in list(range(0, len(blk), step))
                   + [len(blk) - 1]], f"truncate {name}")


def test_interior_flip_sweep_error_codes_equal():
    blk = block_corpus()["cmp_text"]
    r = rng(20260808)
    payloads = []
    for _ in range(48):
        m = bytearray(blk)
        m[int(r.integers(0, len(blk)))] = int(r.integers(0, 256))
        payloads.append(bytes(m))
    _sweep_parity(payloads, "flip")


def test_sums_that_wrap_int32_after_the_first_bad_header():
    """Header 0 has a zero offset (error 5); the next two headers extend
    their match lengths over 4.3 M 0xFF bytes each, so the running output
    size passes 2^31 and wraps, as the reference's int32 cumsum does.  No
    block of the engine's size can reach this (each payload byte adds at
    most 255), so it takes a long row."""
    hdr = b"\x0f\x01\x00" + b"\xff" * 4_300_000 + b"\x07"
    blk = b"\x10A\x00\x00" + hdr + hdr + b"\x10B"
    buf = np.zeros((1, len(blk) + tops.SPEC_PAD), np.uint8)
    buf[0, : len(blk)] = np.frombuffer(blk, np.uint8)
    n = np.array([len(blk)], np.int32)
    mo = np.array([MAX_BLOCK], np.int32)
    got = [t.numpy()[0] for t in tops.plan_speculative(
        torch.from_numpy(buf), t32(n), t32(mo), max_lit=8, max_match=8,
        out_cap=CAPS.out_cap)]
    want = [np.asarray(a) for a in jops.plan_speculative(
        jnp.asarray(buf[0]), jnp.int32(n[0]), jnp.int32(mo[0]), max_lit=8,
        max_match=8, out_cap=CAPS.out_cap)]
    assert_spec_equal(got, want, "wrap")
    status = got[-1]
    assert status[tops.SPEC_ERR] == 5
    assert status[tops.SPEC_OUT_SIZE] < 0  # wrapped, identically


def test_ops_plan_decode_equals_reference():
    corpus = block_corpus()
    names = ("cmp_text", "rle_274", "final_ext", "lit_text")
    payloads = [corpus[k] for k in names] + [lying_corpus()["zero_offset"][0]]
    buf, ns = stack_payloads(payloads, B_SPEC)
    mo = np.full((len(payloads),), MAX_BLOCK, np.int32)
    out, status, crc = tops.plan_decode(
        torch.from_numpy(buf), t32(ns), t32(mo), out_cap=CAPS.out_cap,
        max_lit=CAPS.max_lit, max_match=CAPS.max_match,
        rounds=tplan.MAX_RESOLVE_ROUNDS, compute_crc=True)
    fn = jax.jit(jax.vmap(functools.partial(
        jops.plan_decode, out_cap=CAPS.out_cap, max_lit=CAPS.max_lit,
        max_match=CAPS.max_match, rounds=tplan.MAX_RESOLVE_ROUNDS)))
    w_out, w_status, w_crc = in_ref_batches(fn, buf, ns, mo)
    np.testing.assert_array_equal(out.numpy(), w_out)
    np.testing.assert_array_equal(status.numpy(), w_status)
    assert crc.tolist() == [int(v) for v in w_crc]
    for j, k in enumerate(names):
        data = tplan.decode_block_planned(corpus[k])
        assert out[j, : len(data)].numpy().tobytes() == data
        assert int(crc[j]) == binascii.crc32(data)
    assert int(status[-1, tops.SPEC_ERR]) == 5 and not out[-1].any()
    _, _, none = tops.plan_decode(
        torch.from_numpy(buf), t32(ns), t32(mo), out_cap=CAPS.out_cap,
        max_lit=CAPS.max_lit, max_match=CAPS.max_match, rounds=16,
        compute_crc=False)
    assert not none.any()


# -- the Pallas kernels in interpret mode, against the plain versions ------------

def test_decode_wave_pallas_interpret_equals_plain():
    plans, buf, cols, scal = device_plans(("cmp_text",))
    dp = plans[0]
    args = (jnp.asarray(buf[0]), *(jnp.asarray(c[0]) for c in cols),
            *(jnp.int32(s[0]) for s in scal))
    pal = np.asarray(jops.decode_gather(*args, out_cap=CAPS.out_cap,
                                        rounds=dp.n_waves, use_pallas=True))
    got = tops.decode_gather(torch.from_numpy(buf), *map(t32, cols),
                             *map(t32, scal), out_cap=CAPS.out_cap,
                             rounds=dp.n_waves).numpy()[0]
    np.testing.assert_array_equal(got, pal)


def test_plan_spec_pallas_interpret_equals_plain():
    from repro.kernels.plan_speculative import plan_spec_pallas

    blk = block_corpus()["rle_529"]
    buf, ns = stack_payloads([blk], B_SPEC)
    pal = plan_spec_pallas(jnp.asarray(buf[0].astype(np.int32)),
                           jnp.asarray(ns))
    got = tref.plan_fields_ref(torch.from_numpy(buf), t32(ns))
    for name, g, w in zip(kplan.FIELDS, got, pal):
        np.testing.assert_array_equal(g.numpy()[0], np.asarray(w), err_msg=name)


# -- wrappers ---------------------------------------------------------------------

def test_wrappers_check_their_inputs():
    u8 = torch.zeros((2, 8), dtype=torch.uint8)
    i32 = torch.zeros((2, 8), dtype=torch.int32)
    n = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(TypeError):
        kwave.decode_wave(i32, i32, i32, n, 1)
    with pytest.raises(ValueError):
        kwave.decode_wave(u8, i32, i32[:, :4], n, 1)
    with pytest.raises(ValueError):
        kwave.decode_wave(u8, i32, i32, n, -1)
    with pytest.raises(TypeError):
        kplan.plan_speculative(i32, n)
    with pytest.raises(ValueError):
        kplan.plan_speculative(u8, n[:1])
    with pytest.raises(TypeError):
        kcrc.crc32(u8, n.to(torch.int64))
    with pytest.raises(ValueError):
        kcrc.crc32(u8[0], n)
    meta = torch.empty((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        kcrc.crc32(meta, n.to("meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        kplan.plan_speculative(meta, n.to("meta"))
