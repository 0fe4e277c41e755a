"""Caps wider than the kernels' defaults (ROADMAP C2), on the CPU.

The reference's device decoder takes any `DevicePlanCaps`.  The port's must
too: `plan_speculative` rows wider than its shared-memory kernel take
(`blk_cap + SPEC_PAD` past `max_b()`, about 94,208) and `decode_wave`
tables wider than its uint16 one (`out_cap` past 65,536) run second code
paths, in device memory, in the same launches.  Here:

  * the port's `LZ4DecodeEngine(device="cpu")` with `blk_cap=98304`
    (on-device planning) and `out_cap=131072` (both planners) against the
    JAX engine built from the same keywords: bytes, `DecodeStats`, and the
    message for a corrupt payload wider than `max_b() - SPEC_PAD` but within
    `blk_cap`;
  * NumPy models of the two wide paths (the per-offset tables and the
    plain version's 16 doubling rounds of the chain select over ping-ponged
    jump and mark maps; int32 pointer tables ping-ponged with a stop at the
    first round that changes nothing) against the plain versions at
    B = 98,432 and K = 131,072, and past 3 * 2^16 where 16 rounds mark only
    the first 2^16 headers of a chain.

The kernels themselves run only on a GPU, where `chip_smoke.py`
(`read_small`, `decode_kernels_check`) holds them to the same plain
versions and engine.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import DevicePlanCaps as JaxCaps
from repro.core import FrameFormatError as JaxFrameError
from repro.core import LZ4DecodeEngine as JaxDecodeEngine
from repro_torch import LZ4DecodeEngine, LZ4Engine, compat
from repro_torch.core import frame as tframe
from repro_torch.core.decode_plan import DevicePlanCaps
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from test_torch_util import MAX_BLOCK, multiblock_corpus, rng

WIDE = {"blk_cap": dict(blk_cap=98304), "out_cap": dict(out_cap=131072)}
CASES = [("blk_cap", True), ("out_cap", False), ("out_cap", True)]
SHARED_MAX_B = 94_208     # plan_speculative's shared-memory kernel at the engine's caps
CORRUPT = 96_000          # > SHARED_MAX_B - SPEC_PAD, <= blk_cap
CHAIN_ROUNDS = 16


@functools.lru_cache(maxsize=1)
def frames():
    """(frame, data) of three blocks of the engine corpus, and a frame whose
    one block is a corrupt payload of CORRUPT noise bytes."""
    data = multiblock_corpus()[: 2 * MAX_BLOCK + 9000]
    frame = LZ4Engine(device="cpu", micro_batch=4).compress(data)
    noise = rng(16).integers(0, 256, CORRUPT, np.uint8).tobytes()
    bad = tframe.encode_frame([noise], [MAX_BLOCK], [False], checksums=[0])
    return frame, data, bad


def outcome(fn, frame):
    try:
        out = fn(frame)
        return "ok", out if isinstance(out, bytes) else np.asarray(out).tobytes()
    except (tframe.FrameFormatError, JaxFrameError) as e:
        return "error", str(e)


@pytest.mark.parametrize("caps,plan_on_device", CASES)
def test_wide_caps_engine_equals_reference(caps, plan_on_device):
    assert CORRUPT > SHARED_MAX_B - ops.SPEC_PAD
    cfg = dict(executor="device", plan_on_device=plan_on_device, micro_batch=2,
               use_pallas=False)
    port = LZ4DecodeEngine(device="cpu", caps=DevicePlanCaps(**WIDE[caps]),
                           **compat.decode_engine_config(**cfg))
    ref = JaxDecodeEngine(caps=JaxCaps(**WIDE[caps]), **cfg)
    frame, data, bad = frames()
    for method in ("decode", "decode_to_device"):
        got = outcome(getattr(port, method), frame)
        assert got == outcome(getattr(ref, method), frame) == ("ok", data), method
        assert port.stats.as_dict() == ref.stats.as_dict(), method
        got = outcome(getattr(port, method), bad)
        assert got[0] == "error"
        assert got == outcome(getattr(ref, method), bad), method
        assert port.stats.as_dict() == ref.stats.as_dict(), method


# -- plan_speculative's wide path ---------------------------------------------

def ctz(x: np.ndarray) -> np.ndarray:
    """Trailing zero bits of nonzero 32-bit values."""
    x = x.astype(np.int64)
    return np.log2(x & -x).astype(np.int64)


def plan_wide_model(block: np.ndarray, n: int):
    """One row through the wide kernel: the 0xFF bitmask of the bytes below
    n and its next-word index (int32), the header fields at every offset,
    then CHAIN_ROUNDS rounds over two jump maps and two mark maps, each
    round reading one copy and setting only ones in the other (which holds
    the marks of two rounds before)."""
    B = block.size
    n = min(max(n, 0), B - 1)
    blk = block.astype(np.int64)
    W = (B + 31) // 32
    isff = np.zeros(W * 32, bool)
    isff[:n] = blk[:n] == 255
    ff = (isff.reshape(W, 32) * (1 << np.arange(32, dtype=np.int64))).sum(1)
    full = ff == 0xFFFFFFFF
    nxt = np.full(W, W, np.int64)
    run = W
    for w in range(W - 1, -1, -1):
        nxt[w] = run
        if not full[w]:
            run = w

    def next_not_ff(j):
        w = j >> 5
        bits = ~ff[w] & (0xFFFFFFFF << (j & 31)) & 0xFFFFFFFF
        none = bits == 0
        w = np.where(none, nxt[w], w)
        bits = np.where(none, ~ff[np.minimum(w, W - 1)] & 0xFFFFFFFF, bits)
        return (w << 5) + ctz(bits)

    i = np.arange(B, dtype=np.int64)
    nm1 = max(n - 1, 0)
    byte = blk
    has_lx = (byte >> 4) == 15
    j1 = np.minimum(i + 1, B - 1)
    r1 = next_not_ff(j1) - j1
    term1 = i + 1 + r1
    t1b = blk[np.minimum(term1, nm1)]
    lit_len = np.where(has_lx, r1 * 255 + t1b + 15, byte >> 4)
    lit_start = i + 1 + np.where(has_lx, 1 + r1, 0)
    ls_end = lit_start + lit_len
    has_mx = (byte & 15) == 15
    o0 = np.minimum(ls_end, nm1)
    off = blk[o0] | (blk[np.minimum(o0 + 1, nm1)] << 8)
    j2 = np.minimum(ls_end + 2, n)
    r2 = next_not_ff(j2) - j2
    term2 = ls_end + 2 + r2
    t2b = blk[np.minimum(term2, nm1)]
    mlen = np.where(has_mx, r2 * 255 + t2b + 19, (byte & 15) + 4)
    nxt_hdr = ls_end + 2 + np.where(has_mx, r2 + 1, 0)
    flags = (has_lx & (term1 >= n)).astype(np.int64) | ((has_mx & (term2 >= n)).astype(np.int64) << 1)
    jump = [np.where(i < n, np.minimum(nxt_hdr, n), i), np.zeros(B, np.int64)]
    mark = [(i == 0).astype(np.int64), np.zeros(B, np.int64)]
    cur = 0
    for _ in range(CHAIN_ROUNDS):
        ja, ma, mb = jump[cur], mark[cur], mark[cur ^ 1]
        on = np.nonzero(ma)[0]
        mb[on] = 1
        mb[ja[on]] = 1
        jump[cur ^ 1] = ja[ja]
        cur ^= 1
    is_start = np.where(i < n, mark[cur], 0)
    return is_start, lit_start, lit_len, ls_end, off, mlen, flags


def plan_rows(B: int):
    """Rows of width B: a valid payload, noise that fills the width, a run of
    0xFF bytes, a short row, and a chain of 3-byte hops as long as B allows."""
    r = rng(21)
    payload = LZ4Engine(device="cpu").compress_to_blocks(multiblock_corpus()[:MAX_BLOCK])[0]
    noise = r.integers(0, 256, B - 1, np.uint8).tobytes()
    chain = b"".join(bytes([0]) + r.integers(0, 256, 2, np.uint8).tobytes()
                     for _ in range((B - 1) // 3))
    rows = [payload, noise, b"\xff" * (B - 1), noise[:5], chain]
    stack = r.integers(0, 256, (len(rows), B), np.uint8)  # noise past n
    ns = np.array([len(x) for x in rows], np.int32)
    for j, x in enumerate(rows):
        stack[j, : len(x)] = np.frombuffer(x, np.uint8)
    return stack, ns


@pytest.mark.parametrize("B", [98_304 + ops.SPEC_PAD, 3 * (1 << 16) + 3001])
def test_plan_wide_model_equals_plain(B):
    stack, ns = plan_rows(B)
    want = tref.plan_fields_ref(torch.from_numpy(stack), torch.from_numpy(ns))
    for m in range(stack.shape[0]):
        got = plan_wide_model(stack[m], int(ns[m]))
        for name, a, b in zip(("is_start", "lit_start", "lit_len", "ls_end", "off",
                               "mlen", "flags"), got, want):
            assert np.array_equal(a, b[m].numpy()), (B, m, name)
    if B > 3 * (1 << 16):  # 16 rounds: the chain's first 2^16 headers only
        assert int(want[0][4].sum()) == 1 << 16


# -- decode_wave's wide path ----------------------------------------------------

def wave_wide_model(block, lit_blk, ptr, total: int, rounds: int):
    """One row through the wide kernel: two int32 copies of the table, a
    round reads one and writes the other, and every thread stops after the
    first round that changed nothing; then block[lit_blk[ptr]] with
    `jnp.take`'s rules, zero at or past total."""
    K, B = ptr.size, block.size
    cur = np.clip(ptr.astype(np.int64), 0, K - 1)
    for _ in range(rounds):
        nxt = cur[cur]
        changed = (nxt != cur).any()
        cur = nxt
        if not changed:
            break
    s = lit_blk.astype(np.int64)[cur]
    s = np.where(s < 0, s + B, s)
    b = np.where((s >= 0) & (s < B), block[np.clip(s, 0, B - 1)], 0)
    return np.where(np.arange(K) < total, b, 0).astype(np.uint8)


@pytest.mark.parametrize("rounds", [0, 1, 5, 16])
def test_wave_wide_model_equals_plain(rounds):
    K, B = 131_072, 300
    r = rng(28)
    k = np.arange(K)
    rows = [(r.integers(0, B, K), np.maximum(k - 1, 0), K),            # RLE chain
            (r.integers(-2 * B, 2 * B, K), r.integers(0, K, K), K - 5),  # random maps
            (r.integers(0, B, K), np.minimum(k + r.integers(1, 50, K), K - 1), 77),
            (r.integers(0, B, K), k, K)]                                 # all literals
    block = r.integers(0, 256, (len(rows), B), np.uint8)
    lit = np.stack([x[0] for x in rows]).astype(np.int32)
    ptr = np.stack([x[1] for x in rows]).astype(np.int32)
    tot = np.array([x[2] for x in rows], np.int32)
    want = tref.decode_gather_ref(torch.from_numpy(block), torch.from_numpy(lit),
                                  torch.from_numpy(ptr), torch.from_numpy(tot), rounds)
    for m in range(len(rows)):
        got = wave_wide_model(block[m], lit[m], ptr[m], int(tot[m]), rounds)
        assert np.array_equal(got, want[m].numpy()), m
