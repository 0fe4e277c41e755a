"""NumPy models of how two hand kernels decompose their work, held against
the plain versions and the JAX package on the CPU (tolerance zero):

  * `csrc/window_select.cu`: a block spread over a cluster of CTAs; chunk
    transfer tables over the clamped state d = clamp(fp - base, 0, R - 1)
    with R taken from the data; a composite per CTA and the entry of each
    CTA resolved from the ones before it; the chunks walked again from their
    true entries.  A block whose R passes the capacity takes the sequential
    walk, which wraps its free pointer in int32 as the plain version does.
  * `csrc/plan_speculative.cu`: the 0xFF bitmask plus next-word index that
    answers the run-table reads, and the chain select by chunk exits, a walk
    over the chunks from offset 0 and marking by doubling inside each chunk.

The constants the decompositions depend on (cluster sizes, chunk size,
capacity, the largest B) are parsed from the CUDA sources, so a model and its
kernel cannot drift apart.  The kernels themselves run only on a GPU, where
`chip_smoke.py` holds them against the same plain versions.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import jax_compressor as jc
from repro.kernels import ref as jref
from repro_torch.core.decode_plan import DevicePlanCaps
from repro_torch.kernels import _build, ops
from repro_torch.kernels import plan_speculative as kplan
from repro_torch.kernels import ref as tref

from test_torch_util import block_corpus, rng

PWS_ALL = (1, 4, 8, 16, 32, 64, 2048)
BLK_CAP = DevicePlanCaps().blk_cap
B_SPEC = BLK_CAP + ops.SPEC_PAD
MASK32 = 0xFFFFFFFF


def cu_consts(name: str, *keys: str) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys}


WS = cu_consts("window_select", "CLUSTER", "CHUNK_POS", "CAP", "TSTRIDE", "TILE")
PS = cu_consts("plan_speculative", "CLUSTER", "SEG", "MAX_B")


def wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


# -- window_select ----------------------------------------------------------------

def select_sequential_np(valid, lengths, pws):
    """The kernel's sequential walk: one window after another, the free
    pointer an int32 that wraps."""
    W = valid.size // pws
    emit = np.zeros(W, bool)
    pos = np.zeros(W, np.int32)
    ln = np.zeros(W, np.int32)
    fp = 0
    for w in range(W):
        base = w * pws
        start = fp - base if fp > base else 0
        idx = -1
        if start < pws:
            hits = np.flatnonzero(valid[base + start: base + pws])
            if hits.size:
                idx = start + int(hits[0])
        e = idx >= 0
        idx = max(idx, 0)
        emit[w], pos[w], ln[w] = e, base + idx, lengths[base + idx]
        if e:
            fp = wrap32(base + idx + int(lengths[base + idx]))
    return emit, pos, ln


def select_chunked_np(valid, lengths, pws):
    """The kernel's decomposition of one block.  Returns (emit, pos, length,
    path) with path "chunked" or "sequential"."""
    P = valid.size
    W = P // pws
    R = max(1, int(lengths[valid].max()) if valid.any() else 1)
    if R > WS["CAP"]:
        return (*select_sequential_np(valid, lengths, pws), "sequential")
    # the staged byte per position: the state after selecting it, which the
    # invariant keeps below R (no clamp at R - 1 needed)
    nx = np.maximum(np.arange(P) % pws + np.clip(lengths, 0, 255) - pws, 0)
    assert (nx[valid] <= R - 1).all()
    rel = np.arange(pws)
    # first valid offset >= d in window w, pws if none (find-first-set)
    nxt = np.minimum.accumulate(np.where(valid.reshape(W, pws), rel, pws)[:, ::-1],
                                axis=1)[:, ::-1]

    def step(w, d):
        inwin = d < pws
        idx = nxt[w, np.minimum(d, pws - 1)]
        found = inwin & (idx < pws)
        return np.where(found, nx[w * pws + np.minimum(idx, pws - 1)], np.maximum(d - pws, 0))

    wpc = max(1, WS["CHUNK_POS"] // pws)
    nchunk = -(-W // wpc)
    cpr = -(-nchunk // WS["CLUSTER"])
    first = np.arange(nchunk) * wpc

    # phase 1: every chunk's exit state for every entry state r < R
    tab = np.tile(np.arange(R), (nchunk, 1))
    for u in range(wpc):
        live = (first + u < W)[:, None]
        w = np.broadcast_to(np.minimum(first + u, W - 1)[:, None], tab.shape)
        tab = np.where(live, step(w, tab), tab)
    assert tab.max() < R <= WS["TSTRIDE"] <= 256   # byte tables

    # phase 2: per CTA, chunk entries for each CTA entry r and the composite;
    # a CTA's entry is the composites of the CTAs before it applied to 0
    chunk_entry = np.zeros(nchunk, np.int64)
    d = 0
    for rank in range(WS["CLUSTER"]):
        c0 = min(rank * cpr, nchunk)
        c1 = min(c0 + cpr, nchunk)
        ent = np.arange(R)
        for c in range(c0, c1):
            chunk_entry[c] = ent[d]
            ent = tab[c, ent]
        d = int(ent[d])

    # phase 3: the state entering every window, then each window's selection
    state = np.zeros(W, np.int64)
    cur = chunk_entry.copy()
    for u in range(wpc):
        live = first + u < W
        state[(first + u)[live]] = cur[live]
        cur = np.where(live, step(np.minimum(first + u, W - 1), cur), cur)
    w = np.arange(W)
    inwin = state < pws
    idx = nxt[w, np.minimum(state, pws - 1)]
    emit = inwin & (idx < pws)
    pos = (w * pws + np.where(emit, idx, 0)).astype(np.int32)
    return emit, pos, lengths[pos].astype(np.int32), "chunked"


def select_rows(pws: int, P: int, seed: int):
    """Rows that stress the decomposition at one pws: (name, valid, lengths,
    path the kernel takes)."""
    r = rng(seed)
    cap = WS["CAP"]
    rows = []

    def add(name, valid, lengths, path="chunked"):
        rows.append((name, valid.astype(bool), lengths.astype(np.int32), path))

    valid = r.random(P) < 0.5
    add("lengths_-3_to_cap", valid, r.integers(-3, cap + 1, P))
    add("jumps_windows", r.random(P) < 0.3, np.full(P, max(36, 9 * pws)).clip(max=cap))
    add("zero_and_negative", r.random(P) < 0.6, r.integers(-3, 2, P))
    add("all_valid_at_R", np.ones(P, bool), np.full(P, 17))
    add("all_valid_at_cap", np.ones(P, bool), np.full(P, cap))
    add("sparse_long", r.random(P) < 0.02, r.integers(4, cap + 1, P))
    add("none_valid", np.zeros(P, bool), r.integers(-(2**31), 2**31 - 1, P))
    raw = r.integers(-1000, 1000, P)      # raw lengths at empty-window bases
    v = r.random(P) < 0.4
    add("raw_at_invalid", v, np.where(v, r.integers(1, 40, P), raw))
    over = r.integers(4, 36, P)
    over[P // 2] = cap + 45               # one valid length above capacity
    add("above_capacity", np.ones(P, bool) & (r.random(P) < 0.7) | (np.arange(P) == P // 2),
        over, "sequential")
    wraps = r.integers(4, 36, P)
    wraps[P // 3] = 2**31 - 3             # the free pointer wraps int32
    add("free_pointer_wraps", (np.arange(P) % 3 != 1) | (np.arange(P) == P // 3),
        wraps, "sequential")
    return rows


@functools.lru_cache(maxsize=None)
def jax_select(pws: int):
    return jax.jit(jax.vmap(functools.partial(jc._select_sequential, pws=pws)))


def test_window_select_constants_from_the_source():
    assert 128 <= WS["CAP"] < WS["TSTRIDE"] <= 256     # states are bytes
    assert 1 <= WS["CLUSTER"] <= 8                      # a portable cluster
    assert WS["CHUNK_POS"] % 32 == 0 and WS["TILE"] % 2048 == 0


@pytest.mark.parametrize("pws", PWS_ALL)
def test_window_select_model_equals_plain_and_jax(pws):
    P = 4096
    rows = select_rows(pws, P, seed=100 + pws)
    valid = np.stack([x[1] for x in rows])
    lengths = np.stack([x[2] for x in rows])
    got = [select_chunked_np(v, l, pws) for v, l in zip(valid, lengths)]
    assert [g[3] for g in got] == [x[3] for x in rows]
    plain = [t.numpy() for t in tref.window_select_ref(
        torch.from_numpy(valid), torch.from_numpy(lengths), pws)]
    ref = [np.asarray(a) for a in jax_select(pws)(jnp.asarray(valid),
                                                   jnp.asarray(lengths))]
    for j, (name, *_rest) in enumerate(rows):
        for k, field in enumerate(("emit", "pos", "length")):
            np.testing.assert_array_equal(got[j][k], plain[k][j], err_msg=f"{name} {field}")
            np.testing.assert_array_equal(got[j][k], ref[k][j], err_msg=f"{name} {field} (jax)")


def test_window_select_model_at_the_main_path_shape():
    """P = 65536, pws = 8: 256 chunks of 32 windows, 64 per CTA; lengths of
    the datapath's range and a block with one valid length of 300."""
    P, pws = 65536, 8
    r = rng(7)
    valid = r.random((2, P)) < 0.45
    lengths = np.where(valid, r.integers(4, 37, (2, P)), 0).astype(np.int32)
    lengths[1, 40000] = 300
    valid[1, 40000] = True
    plain = [t.numpy() for t in tref.window_select_ref(
        torch.from_numpy(valid), torch.from_numpy(lengths), pws)]
    ref = [np.asarray(a) for a in jax_select(pws)(jnp.asarray(valid), jnp.asarray(lengths))]
    for j, path in enumerate(("chunked", "sequential")):
        got = select_chunked_np(valid[j], lengths[j], pws)
        assert got[3] == path
        for k in range(3):
            np.testing.assert_array_equal(got[k], plain[k][j])
            np.testing.assert_array_equal(got[k], ref[k][j])


@settings(max_examples=40, deadline=None, derandomize=True)
@given(P_pws=st.sampled_from([(64, 1), (64, 4), (256, 8), (512, 16), (1024, 4),
                              (1024, 32), (2048, 64), (2048, 2048), (1000, 8)]),
       density=st.floats(0.0, 1.0), lo=st.integers(-3, 300),
       span=st.integers(0, 300), seed=st.integers(0, 2**31 - 1))
def test_window_select_model_search(P_pws, density, lo, span, seed):
    P, pws = P_pws
    r = rng(seed)
    valid = r.random(P) < density
    lengths = r.integers(lo, min(lo + span, 300) + 1, P).astype(np.int32)
    got = select_chunked_np(valid, lengths, pws)
    plain = tref.window_select_ref(torch.from_numpy(valid)[None],
                                   torch.from_numpy(lengths)[None], pws)
    for k in range(3):
        np.testing.assert_array_equal(got[k], plain[k][0].numpy())


# -- plan_speculative ---------------------------------------------------------------

def ctz32(b):
    """Index of the lowest set bit of each nonzero uint32 (find-first-set - 1)."""
    b = b.astype(np.uint64)
    return np.log2(b & ((~b + 1) & MASK32)).astype(np.int64)


def ff_query_np(block, n):
    """The kernel's run-table stand-in: (words, nxt, next_not_ff(j))."""
    B = block.size
    W = -(-B // 32)
    bits = np.zeros(32 * W, np.uint64)
    bits[:B] = (block == 255) & (np.arange(B) < n)
    words = (bits.reshape(W, 32) << np.arange(32, dtype=np.uint64)).sum(1)
    nonfull = words != MASK32
    nnf = np.minimum.accumulate(np.where(nonfull, np.arange(W), W)[::-1])[::-1]
    nxt = np.append(nnf[1:], W)          # first non-full word after w

    def next_not_ff(j):
        j = np.asarray(j, np.int64)
        w = j >> 5
        b = ~words[w] & ((MASK32 << (j & 31).astype(np.uint64)) & MASK32) & MASK32
        need = b == 0
        w2 = np.where(need, nxt[w], w)
        assert (w2 < W).all()            # the index never runs past n's word
        b2 = np.where(need, ~words[np.minimum(w2, W - 1)] & MASK32, b)
        return w2 * 32 + ctz32(b2)

    return words, nxt, next_not_ff


def plan_model_np(block, n):
    """The kernel's decomposition of one row: seven int32 fields."""
    B = block.size
    n = min(max(int(n), 0), B - 1)
    blk = block.astype(np.int64)
    i = np.arange(B)
    nm1 = max(n - 1, 0)
    _, _, nnf = ff_query_np(block, n)
    ffrun = lambda j: nnf(j) - j  # noqa: E731

    lit_nib = blk >> 4
    has_lx = lit_nib == 15
    j1 = np.minimum(i + 1, B - 1)
    r1 = ffrun(j1)
    term1 = i + 1 + r1
    t1b = blk[np.minimum(term1, nm1)]
    lit_len = np.where(has_lx, r1 * 255 + t1b + 15, lit_nib)
    lit_start = i + 1 + np.where(has_lx, 1 + r1, 0)
    ls_end = lit_start + lit_len
    m_nib = blk & 15
    has_mx = m_nib == 15
    o0 = np.minimum(ls_end, nm1)
    off = blk[o0] | (blk[np.minimum(o0 + 1, nm1)] << 8)
    j2 = np.minimum(ls_end + 2, n)
    r2 = ffrun(j2)
    term2 = ls_end + 2 + r2
    t2b = blk[np.minimum(term2, nm1)]
    mlen = np.where(has_mx, r2 * 255 + t2b + 19, m_nib + 4)
    nxt = ls_end + 2 + np.where(has_mx, r2 + 1, 0)
    flags = (has_lx & (term1 >= n)).astype(np.int64) | ((has_mx & (term2 >= n)) << 1)
    jump = np.where(i < n, np.minimum(nxt, n), i)

    # chain select: chunks of L offsets, one per CTA of the cluster, each cut
    # into segments of SEG offsets
    C, SEG = PS["CLUSTER"], PS["SEG"]
    L = (-(-B // C) + 31) // 32 * 32
    cs = np.minimum(i // L * L, B)                  # chunk start of each offset
    ce = np.minimum(cs + L, B)
    se_end = np.minimum(cs + ((i - cs) // SEG + 1) * SEG, ce)
    fixed = jump == i
    p = jump.copy()                                 # segment exits
    while True:
        z = np.where((p < se_end) & ~fixed, p[p], p)
        if (z == p).all():
            break
        p = z
    seg_exit = p
    ex = seg_exit.copy()                            # chunk exits, last segment first
    for k in range(C):
        s0, e0 = min(k * L, B), min(k * L + L, B)
        for g0 in reversed(range(s0, e0, SEG)):
            g1 = min(g0 + SEG, e0)
            x = seg_exit[g0:g1]
            later = (x < e0) & (x >= g1)
            ex[g0:g1] = np.where(later, ex[np.where(later, x, 0)], x)
    mark = np.zeros(B, np.int64)
    cur = 0
    for k in range(C):
        s0, e0 = min(k * L, B), min(k * L + L, B)
        if not s0 <= cur < e0:
            continue
        entry, cur = cur, int(ex[cur])
        firsts = []                                 # the chain's first node per segment
        x = entry
        while x < e0:
            firsts.append(x)
            nx = int(seg_exit[x])
            if nx < s0 + ((x - s0) // SEG + 1) * SEG:
                break                               # ends at n inside the segment
            x = nx
        for x in firsts:                            # one walk per segment
            end = min(s0 + ((x - s0) // SEG + 1) * SEG, e0)
            while True:
                mark[x] = 1
                j = int(jump[x])
                if j == x or j >= end:
                    break
                x = j
    is_start = np.where(i < n, mark, 0)
    return [x.astype(np.int32) for x in
            (is_start, lit_start, lit_len, ls_end, off, mlen, flags)]


def chain_row(r, n: int, through=()) -> bytes:
    """A stream of sequences with no match extension, of hop 3..17 bytes
    (token, lit_nib literals, two offset bytes), that passes through every
    offset in `through` and ends at n."""
    out = bytearray()
    targets = sorted(t for t in through if 0 < t < n)
    while len(out) < n:
        cur = len(out)
        gap = next((t - cur for t in targets if t > cur), n - cur)
        hop = gap if 3 <= gap <= 17 else min(17, max(3, gap - 3))
        hop = min(hop, n - cur) if n - cur >= 3 else n - cur
        lit = max(hop - 3, 0)
        out.append((lit << 4) | int(r.integers(0, 15)))
        out += bytes(r.integers(0, 256, max(hop - 1, 0), np.uint8))
    return bytes(out[:n])


def plan_rows(B: int, seed: int):
    """(name, row bytes of width B, n)."""
    r = rng(seed)
    C = PS["CLUSTER"]
    L = (-(-B // C) + 31) // 32 * 32
    cap = B - ops.SPEC_PAD
    rows = []
    longest = bytearray()
    while len(longest) < cap:            # 00 xx xx: one 3-byte hop each
        longest += bytes([0]) + bytes(r.integers(0, 256, 2, np.uint8))
    rows.append(("longest_chain", bytes(longest[:cap]), cap))
    k = 2 * L // 255 + 1                 # literals that jump a whole chunk
    head = bytes([0xF0]) + b"\xff" * k + bytes([7])
    lit = bytes(r.integers(0, 256, 255 * k + 7 + 15, np.uint8))
    body = head + lit + b"\x01\x00" + chain_row(r, cap - len(head) - len(lit) - 2)
    rows.append(("literals_past_a_chunk", body, cap))
    for d in (0, -1, 1, -3):
        rows.append((f"hops_on_chunk_edges{d:+d}",
                     chain_row(r, cap, [q * L + d for q in range(1, C)]), cap))
    seg_edges = [q * L + g * PS["SEG"] for q in range(C) for g in range(1, -(-L // PS["SEG"]))]
    for d in (0, -1):
        rows.append((f"hops_on_segment_edges{d:+d}",
                     chain_row(r, cap, [t + d for t in seg_edges]), cap))
    rows.append(("all_0xff", b"\xff" * cap, cap))
    rows.append(("0xff_then_short_n", b"\xff" * cap, 40))
    noise = bytes(r.integers(0, 256, cap, np.uint8))
    for n in (0, 1, 2, 3, cap):
        rows.append((f"noise_n{n}", noise, n))
    ffish = np.where(r.random(cap) < 0.7, 255, r.integers(0, 256, cap)).astype(np.uint8)
    rows.append(("mostly_0xff", ffish.tobytes(), cap))
    for name in ("cmp_text", "zeros", "rle_529", "final_ext"):
        p = block_corpus()[name]
        rows.append((name, p, len(p)))
    return rows


def stack_rows(rows, B: int, seed: int):
    buf = rng(seed).integers(0, 256, (len(rows), B), np.uint8)  # noise past n
    ns = np.zeros(len(rows), np.int32)
    for j, (_, row, n) in enumerate(rows):
        buf[j, : len(row)] = np.frombuffer(row, np.uint8)
        ns[j] = n
    return buf, ns


def test_plan_constants_from_the_source():
    assert PS["MAX_B"] == 3 * 2**16 - 1 == kplan.MAX_B
    assert 1 <= PS["CLUSTER"] <= 8 and PS["SEG"] % 32 == 0


def test_ff_query_equals_the_run_table():
    """next_not_ff(j) - j == the reversed-cummin run table at every j, on
    rows with long and short 0xFF runs, and on an all-0xFF row."""
    r = rng(3)
    for B, n, density in ((B_SPEC, BLK_CAP, 0.9), (B_SPEC, BLK_CAP, 1.0),
                          (1000, 999, 0.97), (33, 31, 1.0), (5, 0, 1.0)):
        block = np.where(r.random(B) < density, 255, r.integers(0, 255, B)).astype(np.uint8)
        idx = np.arange(B)
        v = np.where((block == 255) & (idx < n), B, idx)
        table = np.minimum.accumulate(v[::-1])[::-1] - idx
        _, _, nnf = ff_query_np(block, n)
        np.testing.assert_array_equal(nnf(idx) - idx, table)


@functools.lru_cache(maxsize=None)
def jax_plan():
    return jax.jit(jax.vmap(jref.plan_fields_ref))


def test_plan_model_equals_plain_and_jax():
    rows = plan_rows(B_SPEC, seed=11)
    buf, ns = stack_rows(rows, B_SPEC, seed=12)
    plain = [t.numpy() for t in tref.plan_fields_ref(torch.from_numpy(buf),
                                                     torch.from_numpy(ns))]
    ref = [np.asarray(a) for a in jax_plan()(jnp.asarray(buf.astype(np.int32)),
                                              jnp.asarray(ns))]
    for j, (name, _, n) in enumerate(rows):
        got = plan_model_np(buf[j], ns[j])
        for k, field in enumerate(kplan.FIELDS):
            np.testing.assert_array_equal(got[k], plain[k][j], err_msg=f"{name} {field}")
            np.testing.assert_array_equal(got[k], ref[k][j], err_msg=f"{name} {field} (jax)")
    # the rows reach what they are named for
    C, is_start = PS["CLUSTER"], dict(zip([x[0] for x in rows], plain[0]))
    L = (-(-B_SPEC // C) + 31) // 32 * 32
    assert is_start["longest_chain"].sum() == -(-BLK_CAP // 3)   # 21,846 headers
    assert is_start["literals_past_a_chunk"][L: 2 * L].sum() == 0
    for d in (0, -1, 1, -3):
        assert is_start[f"hops_on_chunk_edges{d:+d}"][[q * L + d for q in range(1, C)]].all()
    edges = [q * L + g * PS["SEG"] for q in range(C) for g in range(1, -(-L // PS["SEG"]))]
    edges = [t for t in edges if t < BLK_CAP - 3]
    for d in (0, -1):
        assert is_start[f"hops_on_segment_edges{d:+d}"][[t + d for t in edges]].all()


def test_plan_guard_is_where_reachable_equals_16_rounds():
    """At B = MAX_B the longest chain (3-byte hops to n = B - 1) is marked
    the same by the model (every reachable offset) and the plain version
    (fewer than 2^16 hops); a few bytes longer, they part."""
    r = rng(5)
    for B, same in ((PS["MAX_B"], True), (PS["MAX_B"] + 4, False)):
        n = B - 1
        row = bytearray()
        while len(row) < n:
            row += bytes([0]) + bytes(r.integers(0, 256, 2, np.uint8))
        block = np.zeros(B, np.uint8)
        block[:n] = np.frombuffer(bytes(row[:n]), np.uint8)
        got = plan_model_np(block, n)[0]
        plain = tref.plan_fields_ref(torch.from_numpy(block)[None],
                                     torch.tensor([n], dtype=torch.int32))[0][0].numpy()
        assert np.array_equal(got, plain) == same


@settings(max_examples=40, deadline=None, derandomize=True)
@given(B=st.sampled_from([1, 2, 3, 33, 64, 257, 1000, 4099]),
       n_frac=st.floats(0.0, 1.0), ff=st.floats(0.0, 1.0), chain=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_plan_model_search(B, n_frac, ff, chain, seed):
    r = rng(seed)
    n = min(int(n_frac * B), B - 1)
    block = np.where(r.random(B) < ff, 255, r.integers(0, 256, B)).astype(np.uint8)
    if chain and n >= 3:
        block[:n] = np.frombuffer(chain_row(r, n, [B // 2, B // 3]), np.uint8)
    got = plan_model_np(block, n)
    plain = tref.plan_fields_ref(torch.from_numpy(block)[None],
                                 torch.tensor([n], dtype=torch.int32))
    for k, field in enumerate(kplan.FIELDS):
        np.testing.assert_array_equal(got[k], plain[k][0].numpy(), err_msg=field)
