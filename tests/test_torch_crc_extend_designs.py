"""NumPy models of how two hand kernels decompose their work, held against
the plain versions, `binascii.crc32` and the JAX package on the CPU
(tolerance zero):

  * `csrc/crc32.cu`: each row right-aligned in a virtual stream of whole
    CTA spans; thread t of a CTA keeps the register of its own lane stream
    (16 bytes at offset 16 t of every 4096), one lookup per byte in the
    stride-folded tables with the register folded into the piece's first
    four bytes; pieces cut from the two aligned 16-byte chunks around them
    by funnel shifts, the head and the leading zeros byte by byte; each
    register moved to the row's end by x^(-128 t) * x^(8 L_g) (the second
    factor a product across a warp's lanes, each multiply the kernel's
    byte-wise Horner form); the row's CTAs combined by XOR, rows with n < 4
    finished byte by byte; the launch's steps per CTA from its CTA budget.
  * `csrc/match_extend.cu`: per valid position, the extension word by word
    (unaligned words cut from aligned ones by funnel shifts, two words per
    side loaded per iteration, the count of equal bytes from the XOR's
    first set bit) where both ranges lie inside the row, byte by byte with
    clamped indices elsewhere; the valid positions of each warp's 256 listed
    in position order (a prefix sum of the lanes' counts) and worked on in
    list order, each length written over its candidate's slot.

The constants the decompositions depend on are parsed from the CUDA
sources, and the tables are the wrapper's own (`crc32.kernel_tables`), so a
model and its kernel cannot drift apart.  The kernels themselves run only on
a GPU, where `chip_smoke.py` holds them against the same plain versions.
"""
import binascii
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.match_extend import match_extend_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import crc32 as kcrc
from repro_torch.kernels import ref as tref

from test_torch_util import rng

MASK32 = 0xFFFFFFFF
POLY = 0xEDB88320
ONE = 1 << 31  # x^0, reflected


def cu_consts(name: str, *keys: str) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys}


CRC = cu_consts("crc32", "THREADS", "PIECE", "MAX_ITERS", "CTAS_PER_SM")
STRIDE = CRC["THREADS"] * CRC["PIECE"]
BYTE_OFF = CRC["PIECE"] * 256
INV_OFF = BYTE_OFF + 256
TABLE_WORDS = INV_OFF + CRC["THREADS"]
EXT = cu_consts("match_extend", "THREADS", "GROUP", "MIN_MATCH", "LAST_LITERALS")
H100_SMS = 132


# -- crc32 --------------------------------------------------------------------

def mul_bits(a, b):
    """a(x) * b(x) modulo the polynomial, reflected, bit by bit (zlib's
    multmodp), elementwise over uint64 arrays."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    a, b = np.broadcast_arrays(a, b)
    b = b.copy()
    p = np.zeros(a.shape, np.uint64)
    for i in range(31, -1, -1):
        p ^= b * ((a >> np.uint64(i)) & np.uint64(1))
        b = (b >> np.uint64(1)) ^ (np.uint64(POLY) * (b & np.uint64(1)))
    return p


def mul_bytes(a, b, t0):
    """The kernel's multiply: b * x^j (j < 8), a's four coefficient bytes
    each select an XOR of them, three Horner steps of x^8 through the byte
    table t0."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    a, b = np.broadcast_arrays(a, b)
    pw = [b.copy()]
    for _ in range(7):
        v = pw[-1]
        pw.append((v >> np.uint64(1)) ^ (np.uint64(POLY) * (v & np.uint64(1))))
    q = []
    for k in range(4):
        acc = np.zeros(a.shape, np.uint64)
        for j in range(8):
            acc ^= pw[j] * ((a >> np.uint64(31 - 8 * k - j)) & np.uint64(1))
        q.append(acc)
    p = q[3]
    for k in (2, 1, 0):
        p = (p >> np.uint64(8)) ^ t0[(p & np.uint64(0xFF)).astype(np.int64)] ^ q[k]
    return p


def crc_plan(M: int, K: int, sms: int) -> tuple[int, int, int]:
    """(iters, span, CTAs per row) of a launch (csrc `iters_for`)."""
    it = 1
    while (it < CRC["MAX_ITERS"] and STRIDE * it < K
           and M * -(-K // (STRIDE * it)) > CRC["CTAS_PER_SM"] * sms):
        it *= 2
    span = STRIDE * it
    return it, span, 1 if K <= 0 else -(-K // span)


def load_pieces(mem, rs: int, i0: np.ndarray, n: int) -> np.ndarray:
    """(threads, 4) little-endian words of row bytes [i0, i0 + 16) as the
    kernel loads them; `mem` index 0 is 16-byte aligned, the row starts at
    rs."""
    w = np.zeros((i0.size, 4), np.uint64)
    fast = i0 >= 4
    if fast.any():
        a = rs + i0[fast]
        s = int(a[0] & 15)
        assert ((a & 15) == s).all()  # the shift is the same for every piece of a row
        lo = mem[(a - s)[:, None] + np.arange(16)]
        hi = mem[(a - s + 16)[:, None] + np.arange(16)] if s else np.zeros_like(lo)
        W = np.concatenate([lo, hi], 1).astype(np.uint64).reshape(-1, 8, 4)
        W = (W * (np.uint64(1) << (np.uint64(8) * np.arange(4, dtype=np.uint64)))).sum(2)
        if s & 8:
            W[:, 0:6] = W[:, 2:8].copy()
        if s & 4:
            W[:, 0:5] = W[:, 1:6].copy()
        sh = np.uint64(8 * (s & 3))
        pair = W[:, 0:4] | (W[:, 1:5] << np.uint64(32))
        w[fast] = (pair >> sh) & np.uint64(MASK32)
    for t in np.nonzero(~fast & (i0 + 16 > 0))[0]:
        for k in range(16):
            i = int(i0[t]) + k
            if 0 <= i < n:
                b = int(mem[rs + i]) ^ (0xFF if n >= 4 and i < 4 else 0)
                w[t, k >> 2] |= np.uint64(b << (8 * (k & 3)))
    return w


def crc_model(mem, start: int, M: int, K: int, ns, sms: int = H100_SMS) -> list[int]:
    """CRC-32 of rows m at mem[start + m K:][:ns[m]] through the kernel's
    decomposition, one launch over (M, K)."""
    tab = kcrc.kernel_tables().astype(np.uint64)
    T = tab[:BYTE_OFF].reshape(CRC["PIECE"], 256)
    t0, inv = tab[BYTE_OFF:INV_OFF], tab[INV_OFF:TABLE_WORDS]
    x2n = tref.crc_x2n_table()  # csrc X2N (test_torch_decode_kernels holds it to the source)
    iters, span, G = crc_plan(M, K, sms)
    lg = span.bit_length() - 1
    tid = np.arange(CRC["THREADS"])
    out = []
    for m in range(M):
        n = min(max(int(ns[m]), 0), K)
        rs = start + m * K
        lead = G * span - n
        acc = 0
        for g in range(G):
            base = g * span - lead
            if base + span <= 0:
                continue
            j = G - 1 - g
            f = np.array([x2n[(lane + lg + 3) & 31] if (j >> lane) & 1 else ONE
                          for lane in range(32)], np.uint64)
            d, width = 1, max(j, 1).bit_length()
            while d < width:
                f = mul_bytes(f[np.arange(32) ^ d], f, t0)
                d <<= 1
            kt = mul_bytes(f[0], inv, t0)
            r = np.zeros(CRC["THREADS"], np.uint64)
            for it in range(iters):
                w = load_pieces(mem, rs, base + it * STRIDE + CRC["PIECE"] * tid, n)
                w[:, 0] ^= r
                byte = lambda k: ((w[:, k >> 2] >> np.uint64(8 * (k & 3))) & np.uint64(0xFF)).astype(np.int64)  # noqa: E731
                r = np.zeros_like(r)
                for k in range(CRC["PIECE"]):
                    r ^= T[k][byte(k)]
            r = mul_bytes(r, kt, t0)
            acc ^= int(np.bitwise_xor.reduce(r))
        if n >= 4:
            out.append(acc ^ MASK32)
        else:
            s = MASK32
            for b in mem[rs: rs + n]:
                s ^= int(b)
                for _ in range(8):
                    s = (s >> 1) ^ (POLY if s & 1 else 0)
            out.append(s ^ MASK32)
    return out


def crc_case(M: int, K: int, ns, offset: int, seed: int):
    """A 16-byte-aligned buffer with noise on both sides and M rows of K
    bytes from `offset`."""
    r = rng(seed)
    mem = r.integers(0, 256, offset + M * K + 64, np.uint8)
    return mem, offset, np.asarray(ns, np.int64)


CRC_CASES = {
    # name: (M, K, ns, offset into the buffer, sms)
    "n_0_to_17": (9, 64, [0, 1, 2, 3, 4, 5, 15, 16, 17], 0, H100_SMS),
    "ragged_odd_width": (6, 65536 + 7, [65543, 65542, 65535, 4096, 16, 3], 5, H100_SMS),
    "unaligned_1": (3, 1001, [1001, 999, 4], 1, H100_SMS),
    "unaligned_7": (3, 1007, [1007, 500, 3], 7, H100_SMS),
    "unaligned_15": (3, 4111, [4111, 4097, 4096], 15, H100_SMS),
    "many_rows": (133, 2048, None, 3, H100_SMS),
    "rows_of_many_ctas": (2, 600_999, [600_999, 595_999], 0, H100_SMS),
    "long_steps": (2, 600_999, [600_999, 595_999], 9, 8),
    "near_the_end": (4, 50_000, [49_999, 49_985, 49_984, 49_997], 2, 1),
}


def test_crc_constants_from_the_source():
    assert (kcrc.THREADS, kcrc.PIECE, kcrc.STRIDE) == (CRC["THREADS"], CRC["PIECE"], STRIDE)
    src = (_build.CSRC / "crc32.cu").read_text()
    for line in ("constexpr int BYTE_OFF = PIECE * 256;", "constexpr int INV_OFF = BYTE_OFF + 256;",
                 "constexpr int TABLE_WORDS = INV_OFF + THREADS;"):
        assert line in src
    tab = kcrc.kernel_tables()
    assert tab.dtype == np.uint32 and tab.size == TABLE_WORDS
    assert (tab[BYTE_OFF:INV_OFF] == tref.crc_byte_table()).all()
    # x^(-128 t) * x^(128 t) == 1 for every thread
    x128 = 1 << 30  # x
    for _ in range(7):
        x128 = int(mul_bits(x128, x128))
    inv = tab[INV_OFF:TABLE_WORDS].astype(np.uint64)
    pw = np.array([ONE], np.uint64)
    for t in range(CRC["THREADS"]):
        assert int(mul_bits(inv[t], pw[0])) == ONE, t
        pw = mul_bits(pw, x128)


def test_crc_stride_tables_are_crc0_of_a_byte_then_zeros():
    tab = kcrc.kernel_tables()
    t0 = tref.crc_byte_table()
    for j, b in ((0, 1), (3, 0x80), (4, 0xFF), (9, 0x5A), (15, 0x01), (15, 0xFF)):
        r = 0
        for k in range(STRIDE):
            byte = b if k == j else 0
            r = int(t0[(r ^ byte) & 0xFF]) ^ (r >> 8)
        assert int(tab[j * 256 + b]) == r, (j, b)


def test_crc_byte_multiply_equals_bit_serial():
    r = rng(11)
    a = r.integers(0, 1 << 32, 4000, np.uint64)
    b = r.integers(0, 1 << 32, 4000, np.uint64)
    a[:3], b[:3] = [ONE, 0, MASK32], [MASK32, 123, ONE]
    t0 = tref.crc_byte_table().astype(np.uint64)
    assert (mul_bytes(a, b, t0) == mul_bits(a, b)).all()


def test_crc_plan_fills_the_budget():
    assert crc_plan(8, 65536, H100_SMS) == (1, 4096, 16)
    assert crc_plan(64, 65536, H100_SMS) == (4, 16384, 4)
    iters, span, G = crc_plan(1, (64 << 20) + 5, H100_SMS)
    assert iters == CRC["MAX_ITERS"] and G == -(-((64 << 20) + 5) // span)
    assert crc_plan(65535, 16, H100_SMS) == (1, 4096, 1)  # one step covers the row
    for M, K in ((1, 1), (133, 65536), (3, 600_999), (5000, 70000)):
        iters, span, G = crc_plan(M, K, H100_SMS)
        assert G * span >= K and (iters == CRC["MAX_ITERS"] or G == 1
                                  or M * G <= CRC["CTAS_PER_SM"] * H100_SMS)


@pytest.mark.parametrize("case", list(CRC_CASES))
def test_crc_model_equals_binascii_and_plain(case):
    M, K, ns, offset, sms = CRC_CASES[case]
    if ns is None:
        ns = rng(7).integers(0, K + 1, M)
        ns[:4] = [0, 3, 4, K]
    mem, start, ns = crc_case(M, K, ns, offset, seed=len(case))
    got = crc_model(mem, start, M, K, ns, sms)
    rows = [mem[start + m * K: start + m * K + int(ns[m])].tobytes() for m in range(M)]
    assert got == [binascii.crc32(r) for r in rows]
    data = torch.from_numpy(mem[start: start + M * K].reshape(M, K).copy())
    plain = tref.crc32_ref(data, torch.from_numpy(ns.astype(np.int32)))
    assert plain.tolist() == got


@pytest.mark.parametrize("case", ["n_0_to_17", "unaligned_7", "near_the_end"])
def test_crc_model_equals_jax(case):
    M, K, ns, offset, sms = CRC_CASES[case]
    mem, start, ns = crc_case(M, K, ns, offset, seed=len(case))
    got = crc_model(mem, start, M, K, ns, sms)
    for m in range(M):
        row = jnp.asarray(mem[start + m * K: start + (m + 1) * K])
        assert int(jops.crc32_bytes(row, jnp.int32(ns[m]))) == got[m]


# -- match_extend --------------------------------------------------------------

def funnel(lo, hi, sh):
    return ((lo | (hi << np.uint64(32))) >> sh) & np.uint64(MASK32)


def words_of(mem, rs: int):
    """The row's aligned words (from the word that holds its byte 0), with
    o = rs & 3 (`mem` index 0 is aligned)."""
    o = rs & 3
    raw = mem[rs - o:]
    raw = raw[: raw.size // 4 * 4].astype(np.uint64).reshape(-1, 4)
    return (raw * (np.uint64(1) << (np.uint64(8) * np.arange(4, dtype=np.uint64)))).sum(1), o


def extension_model(mem, rs: int, B: int, p, c, cap):
    """e for positions p (candidates c, caps cap) of the row at mem[rs:]."""
    words, o = words_of(mem, rs)
    p, c, cap = (np.asarray(x, np.int64) for x in (p, c, cap))
    e = np.zeros(p.shape, np.int64)
    fast = (c >= 0) & (c + cap + 15 <= B) & (p + cap + 15 <= B)
    # fast: aligned words, two per side per iteration, no checks
    kp, kc = o + p + EXT["MIN_MATCH"], o + c + EXT["MIN_MATCH"]
    sa, sb = (8 * (kp & 3)).astype(np.uint64), (8 * (kc & 3)).astype(np.uint64)
    wa, wb = kp >> 2, kc >> 2
    live = fast & (cap > 0)
    while live.any():
        i = np.nonzero(live)[0]
        q = e[i] // 4
        a0, a1, a2 = (words[wa[i] + q + d] for d in (0, 1, 2))
        b0, b1, b2 = (words[wb[i] + q + d] for d in (0, 1, 2))
        d0 = funnel(a0, a1, sa[i]) ^ funnel(b0, b1, sb[i])
        d1 = funnel(a1, a2, sa[i]) ^ funnel(b1, b2, sb[i])
        first = lambda d: np.array([(int(x) & -int(x)).bit_length() - 1 for x in d], np.int64) >> 3  # noqa: E731
        stop0, stop1 = d0 != 0, (d0 == 0) & (d1 != 0)
        new = e[i] + 8
        new[stop0] = e[i][stop0] + first(d0[stop0])
        new[stop1] = e[i][stop1] + 4 + first(d1[stop1])
        e[i] = np.minimum(new, cap[i])
        live[i] = ~(stop0 | stop1) & (e[i] < cap[i])
    # elsewhere: every byte index clamped to [0, B - 1]
    s8 = mem[rs: rs + B].astype(np.int64)
    for k in np.nonzero(~fast)[0]:
        while e[k] < cap[k]:
            i0, j0 = p[k] + 4 + e[k], c[k] + 4 + e[k]
            wp = [s8[min(max(i0 + q, 0), B - 1)] for q in range(4)]
            wc = [s8[min(max(j0 + q, 0), B - 1)] for q in range(4)]
            same = next((q for q in range(4) if wp[q] != wc[q]), 4)
            e[k] = min(e[k] + same, cap[k])
            if same < 4:
                break
    return e


def match_extend_model(mem, start: int, B: int, cand, valid, ns, max_match: int):
    """(M, P) lengths through the kernel's decomposition: each warp's 256
    positions (8 per lane), the valid ones listed in position order at the
    ranks a prefix sum of the lanes' counts gives, worked on in list order
    (lane t takes items t, t + 32, ...), each length written over its
    slot."""
    M, P = cand.shape
    G, W = EXT["GROUP"], 32 * EXT["GROUP"]
    out = np.zeros((M, P), np.int64)
    for m in range(M):
        n = int(ns[m])
        rs = start + m * B
        order = []
        for c0 in range(0, P, W):
            v = np.zeros(W, bool)
            v[: min(W, P - c0)] = valid[m, c0: c0 + W]
            bits = v.reshape(32, G)
            counts = bits.sum(1)
            rank0 = np.cumsum(counts) - counts      # exclusive prefix over lanes
            items = np.full(int(counts.sum()), -1, np.int64)
            for lane in range(32):
                for j, k in enumerate(np.nonzero(bits[lane])[0]):
                    items[rank0[lane] + j] = c0 + G * lane + k
            assert (items >= 0).all() and (np.diff(items) > 0).all()  # position order
            order += list(items)
        order = np.array(order, np.int64)
        assert np.array_equal(order, np.nonzero(valid[m])[0])  # each valid position once
        cap = np.clip(n - EXT["LAST_LITERALS"] - (order + EXT["MIN_MATCH"]), 0,
                      max_match - EXT["MIN_MATCH"])
        out[m, order] = EXT["MIN_MATCH"] + extension_model(mem, rs, B, order, cand[m, order], cap)
    return out


def extend_case(kind: str, M: int, P: int, B: int, offset: int, seed: int):
    """mem (aligned at index 0), start, cand, valid, ns for one kind of
    input: a row of repeats (long matches), garbage candidates (negative,
    past the row, near INT_MAX), all zeros (every extension to its cap)."""
    r = rng(seed)
    mem = r.integers(0, 256, offset + M * B + 64, np.uint8)
    rows = mem[offset: offset + M * B].reshape(M, B)
    p = np.arange(P)
    if kind == "zeros":
        rows[:] = 0
        cand = np.maximum(p - r.integers(1, 9, (M, P)), 0)
        valid = np.ones((M, P), bool)
    else:
        unit = r.integers(0, 4, (M, 61), np.uint8)
        rows[:] = np.tile(unit, -(-B // 61))[:, :B]
        rows[:, r.integers(0, B, 40)] = 255  # mismatches
        cand = np.maximum(p - 61 * r.integers(1, 4, (M, P)), -1)
        valid = r.random((M, P)) < 0.7
        if kind == "garbage":
            pick = r.integers(0, 5, (M, P))
            cand = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                             [np.full((M, P), -7), r.integers(B - 6, B + 50, (M, P)),
                              np.full((M, P), (1 << 31) - 2), p + r.integers(0, 9, (M, P))],
                             cand)
    ns = np.array([B, B - 3, P, 40][:M], np.int64)
    return mem, offset, cand.astype(np.int64), valid, ns


EXTEND_CASES = [(kind, mm, off) for kind in ("repeats", "garbage", "zeros")
                for mm in (4, 5, 36, 100) for off in (0, 3)]


def test_match_extend_constants_from_the_source():
    assert (EXT["MIN_MATCH"], EXT["LAST_LITERALS"]) == (4, 5)
    assert EXT["GROUP"] == 8 and EXT["THREADS"] % 32 == 0


@pytest.mark.parametrize("kind,max_match,offset", EXTEND_CASES)
def test_match_extend_model_equals_plain(kind, max_match, offset):
    M, P, B = 4, 2040, 2048 + 13
    mem, start, cand, valid, ns = extend_case(kind, M, P, B, offset, seed=max_match + offset)
    got = match_extend_model(mem, start, B, cand, valid, ns, max_match)
    block = torch.from_numpy(mem[start: start + M * B].reshape(M, B).copy())
    want = tref.match_extend_ref(block, torch.from_numpy(cand.astype(np.int32)),
                                 torch.from_numpy(valid), torch.from_numpy(ns.astype(np.int32)),
                                 max_match)
    assert np.array_equal(got, want.numpy())
    if kind == "zeros":  # every valid extension runs to its cap
        p = np.arange(P)
        cap = np.clip(ns[:, None] - 5 - (p + 4), 0, max_match - 4)
        assert np.array_equal(got, 4 + cap)


@pytest.mark.parametrize("max_match", [5, 36])
def test_match_extend_model_equals_pallas_interpret(max_match):
    P, B = 2048, 2048 + max_match + 8
    mem, start, cand, valid, ns = extend_case("repeats", 1, P, B, 1, seed=3)
    ns[0] = B - 6
    got = match_extend_model(mem, start, B, cand, valid, ns, max_match)
    row = jnp.asarray(mem[start: start + B].astype(np.int32))
    want = match_extend_pallas(row, jnp.asarray(cand[0].astype(np.int32)),
                               jnp.asarray(valid[0]), jnp.asarray(ns[:1].astype(np.int32)),
                               max_match=max_match, interpret=True)
    assert np.array_equal(got[0], np.asarray(want))
