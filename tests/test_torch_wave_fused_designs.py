"""NumPy models of how two hand kernels decompose their work, held against
the plain versions and the JAX package on the CPU (tolerance zero):

  * `csrc/decode_wave.cu`: a block spread over a cluster of C CTAs, each
    owning a power-of-two slice of the pointer table (two uint16 copies)
    and the literal byte of each own entry; a round gathers every entry's
    source from the CTA that owns it, stamps the round into the flag of its
    parity in every CTA when anything changed, and stops, in every CTA at
    once, at the first round that changed no entry; the output reads the literal byte from the owner
    of the resolved source.
  * `csrc/fused_compress.cu`: a block spread over a cluster of CTAs, each
    owning P / C positions cut into warp segments of whole windows; each CTA
    stages only the bytes its positions read (16-byte chunks from the row's
    16-byte-aligned start, so foreign bytes on either side and
    uninitialised shared memory past the copy), walks its segments in
    steps of 32 lanes, window by window (read, then atomicMax), folds the
    summaries of the CTAs
    before it into its exclusive prefix of segment tables, and compares and
    extends by funnel-shifted words.

The constants the decompositions depend on (thread and cluster counts, slice
and segment limits, the LZ4 limits) are parsed from the CUDA sources, and
the launch plan is the wrapper's own `_plan`, so a model and its kernel
cannot drift apart.  The kernels themselves run only on a GPU, where
`chip_smoke.py` holds them against the same plain versions.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_wave import decode_wave_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import decode_wave as kwave
from repro_torch.kernels import fused_compress as kfused
from repro_torch.kernels import ref as tref

from test_torch_util import MAX_BLOCK, adversarial_corpus, rng

MASK32 = 0xFFFFFFFF
HASH_PRIME = 2654435761


def cu_consts(name: str, *keys: str) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys}


DW = cu_consts("decode_wave", "THREADS", "THREADS_ALONE", "CLUSTER", "CLUSTER_MIN",
               "MIN_SLICE", "MAX_K", "HEADER", "SMEM_MAX")
FC = cu_consts("fused_compress", "THREADS", "CLUSTER", "MAX_SEGMENTS",
               "MIN_MATCH", "MF_LIMIT", "LAST_LITERALS")


# -- decode_wave ------------------------------------------------------------------

def slice_log2(K: int, C: int) -> int:
    per = -(-K // C)
    lg = 0
    while (1 << lg) < per or (1 << lg) < DW["MIN_SLICE"]:
        lg += 1
    return lg


def smem_bytes(K: int, C: int) -> int:
    """Dynamic shared memory per CTA: the flags, two uint16 copies of the
    slice and its literal bytes (csrc `smem_bytes`)."""
    return DW["HEADER"] + 5 * (1 << slice_log2(K, C))


def wave_model_np(block, lit_blk, ptr, total: int, rounds: int, C: int):
    """One row through the cluster decomposition: (out, rounds run)."""
    K, B = ptr.size, block.size
    lg = slice_log2(K, C)
    S = 1 << lg
    assert C * S >= K and (S // 2 < -(-K // C) or S == DW["MIN_SLICE"])
    lens = np.array([max(0, min(S, K - r * S)) for r in range(C)])
    own = np.arange(S)[None, :] < lens[:, None]
    cur = np.zeros((C, S), np.uint16)          # padding entries start at 0
    lb = np.zeros((C, S), np.uint8)
    for r in range(C):
        k0, ln = r * S, lens[r]
        cur[r, :ln] = np.clip(ptr[k0: k0 + ln], 0, K - 1)
        s = lit_blk[k0: k0 + ln].astype(np.int64)
        s = np.where(s < 0, s + B, s)
        ok = (s >= 0) & (s < B)
        lb[r, :ln] = np.where(ok, block[np.clip(s, 0, max(B - 1, 0))] if B else 0, 0)
    flags = np.zeros((C, 2), np.int64)         # each CTA's own copy
    ran = 0
    for r in range(rounds):
        a = cur.astype(np.int64)
        owner, off = a >> lg, a & (S - 1)
        assert (owner < C).all()               # every pointer stays inside K
        v = cur[owner, off]
        changed = ((v != cur) & own).any(axis=1)
        if changed.any():                      # stamped into every CTA's copy
            flags[:, r & 1] = r + 1
        cur = v
        ran += 1
        stop = flags[:, r & 1] != r + 1        # each CTA reads its own copy
        assert stop.all() or not stop.any()
        if stop.all():
            break
    p = cur.astype(np.int64)
    b = lb[p >> lg, p & (S - 1)]
    k = np.arange(C * S).reshape(C, S)
    b = np.where(k < total, b, 0)
    return b[own], ran


def wave_rows(K: int, B: int, seed: int, C: int):
    """(name, block, lit_blk, ptr, total) rows for one K: the all-zero
    block's RLE chain (depth K - 1), chains through every slice boundary
    of a cluster of C (both ways), random maps with cycles and forward
    pointers, lit_blk out of range, ragged totals."""
    r = rng(seed)
    S = 1 << slice_log2(K, C)
    block = r.integers(0, 256, B, np.uint8)
    k = np.arange(K)
    rows = []
    lit = r.integers(0, B, K).astype(np.int32)
    rows.append(("rle_chain_depth_K-1", block, lit, np.maximum(k - 1, 0), K))
    # a chain that visits both sides of every slice boundary, in a shuffled
    # order, so its hops cross slices backwards and forwards
    edges = [e for q in range(1, C) if q * S < K for e in (q * S - 1, q * S)]
    order = r.permutation(np.array(edges + [0, K - 1], np.int64))
    for name, fill in (("cross_slices_on_literals", k), ("cross_slices_on_back_refs",
                                                         np.maximum(k - 3, 0))):
        ptr = fill.copy()
        ptr[order[0]] = order[0]                 # the chain's literal
        ptr[order[1:]] = order[:-1]
        rows.append((name, block, lit, ptr, K))
    rows.append(("random_maps", block, r.integers(-2 * B, 2 * B, K).astype(np.int32),
                 r.integers(0, K, K), int(r.integers(0, K + 1))))
    cyc = r.permutation(K)                       # one permutation: cycles only
    rows.append(("cycles_total_0", block, lit, cyc, 0))
    fwd = np.minimum(k + r.integers(1, 50, K), K - 1)   # forward pointers
    rows.append(("forward_pointers", block, lit, fwd, K - 7))
    ptr = np.where(r.random(K) < 0.1, k, np.maximum(k - r.integers(1, 5000, K), 0))
    rows.append(("lz_like", block, lit, ptr, K))
    return [(n, b, l.astype(np.int32), np.asarray(p).astype(np.int32), t)
            for n, b, l, p, t in rows]


def test_decode_wave_constants_from_the_source():
    assert DW["MAX_K"] == kwave.MAX_K == 2**16
    assert DW["CLUSTER"] == 8 and DW["CLUSTER_MIN"] == 2
    assert 2 * DW["THREADS"] <= DW["THREADS_ALONE"] <= 1024
    assert DW["MIN_SLICE"] % 16 == 0            # the output's 16-byte stores
    # the largest layout fits from 2 CTAs up: two uint16 copies and the
    # literal bytes of 32,768 entries (the launch refuses one CTA at K =
    # 65536, so the wrapper checks only MAX_K)
    assert smem_bytes(MAX_BLOCK, 1) > DW["SMEM_MAX"]
    for C in (2, 4, 8):
        assert smem_bytes(MAX_BLOCK, C) <= DW["SMEM_MAX"]
    assert smem_bytes(MAX_BLOCK, DW["CLUSTER_MIN"]) == 16 + 5 * 32768
    # two CTAs share an SM from 4 per block up; a CTA of 2 fills one alone
    assert 2 * smem_bytes(MAX_BLOCK, 4) <= DW["SMEM_MAX"] < 2 * smem_bytes(MAX_BLOCK, 2)


@pytest.mark.parametrize("K,C", [(1021, 8), (1021, 4), (65536, 8), (65536, 4),
                                 (65536, 2), (20, 8), (4096 + 17, 2)])
def test_decode_wave_model_equals_plain(K, C):
    B = 300
    rows = wave_rows(K, B, seed=K + C, C=C)
    block = np.stack([x[1] for x in rows])
    lit = np.stack([x[2] for x in rows])
    ptr = np.stack([x[3] for x in rows])
    total = np.array([x[4] for x in rows], np.int32)
    tb, tl, tp, tt = map(torch.from_numpy, (block, lit, ptr, total))
    for rounds in range(17):
        plain = tref.decode_gather_ref(tb, tl, tp, tt, rounds).numpy()
        for j, (name, *_rest) in enumerate(rows):
            got, ran = wave_model_np(block[j], lit[j], ptr[j], total[j], rounds, C)
            np.testing.assert_array_equal(got, plain[j], err_msg=f"{name} r={rounds}")
            assert ran <= rounds
    # the RLE chain needs all 16 rounds at K = 65536 and ends on its literal
    if K == 65536:
        _, ran = wave_model_np(block[0], lit[0], ptr[0], K, 16, C)
        assert ran == 16


@pytest.mark.parametrize("K", [1021, 65536])
def test_decode_wave_model_equals_jax(K):
    B = 300
    rows = wave_rows(K, B, seed=7 * K, C=DW["CLUSTER"])
    for rounds in (0, 1, 5, 16):
        for name, block, lit, ptr, total in rows:
            got, _ = wave_model_np(block, lit, ptr, total, rounds, DW["CLUSTER"])
            want = np.asarray(jref.decode_gather_ref(
                jnp.asarray(block.astype(np.int32)), jnp.asarray(lit),
                jnp.asarray(ptr), jnp.int32(total), rounds))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {rounds}")


@pytest.mark.parametrize("K,rounds", [(1021, 3), (65536, 16)])
def test_decode_wave_model_equals_pallas_interpret(K, rounds):
    B = 300
    for name, block, lit, ptr, total in wave_rows(K, B, seed=K + 1, C=8)[:2]:
        lit = np.clip(lit, 0, B - 1)
        pal = np.asarray(decode_wave_pallas(
            jnp.asarray(block.astype(np.int32)), jnp.asarray(lit), jnp.asarray(ptr),
            jnp.asarray([total], jnp.int32), rounds))
        for C in (8, 4, 2):
            got, _ = wave_model_np(block, lit, ptr, total, rounds, C)
            np.testing.assert_array_equal(got, pal.astype(np.uint8), err_msg=name)


def test_decode_wave_model_stops_with_every_cta():
    """A round that changes entries in one CTA only runs on in all; a map
    already at a fixed point stops after one round; rounds are capped."""
    K, C, B = 65536, 8, 64
    block = rng(2).integers(0, 256, B, np.uint8)
    lit = np.arange(K, dtype=np.int32) % B
    k = np.arange(K, dtype=np.int32)
    ptr = k.copy()
    ptr[K - 5: K] = K - 6                       # depth 2, in the last CTA only
    ptr[K - 6] = K - 7
    _, ran = wave_model_np(block, lit, ptr, K, 16, C)
    assert ran == 2
    _, ran = wave_model_np(block, lit, k, K, 16, C)
    assert ran == 1
    _, ran = wave_model_np(block, lit, np.maximum(k - 1, 0), K, 7, C)
    assert ran == 7


# -- fused_compress ---------------------------------------------------------------

def word_at(sw, i):
    """The kernel's funnel shift of two aligned 32-bit words, vectorised."""
    i = np.asarray(i, np.int64)
    lo = sw[i >> 2].astype(np.uint64)
    hi = sw[(i >> 2) + 1].astype(np.uint64)
    return (((hi << 32) | lo) >> ((i & 3) * 8).astype(np.uint64)) & MASK32


def ctz32(x):
    x = x.astype(np.uint64)
    return np.log2(x & ((~x + 1) & MASK32)).astype(np.int64)


def stage(memory, start: int, B: int, P: int, lo: int, hi: int, max_match: int,
          smem: int, r):
    """One CTA's shared copy of the row at `start` of `memory`: 16-byte
    chunks from the 16-byte-aligned start up to the last byte it reads,
    noise (uninitialised memory) after them."""
    mis = start & 15
    need = min(min(P, hi + max_match) + 8, B)
    nbytes = ((mis + need + 15) >> 4) << 4
    s = r.integers(0, 256, smem, np.uint8)
    s[:nbytes] = memory[start - mis: start - mis + nbytes]
    return s.view("<u4"), mis


def fused_model_np(memory, start: int, B: int, n: int, P: int, hash_bits: int,
                   pws: int, max_match: int, cluster=None, seed: int = 0):
    """One row (bytes [start, start + B) of `memory`) through the kernel's
    decomposition: (cand, lengths) int32."""
    plan = kfused._plan(B, P, hash_bits, pws, cluster)
    C, nseg = plan.cluster, plan.nseg
    span = P // C
    Ls = span // nseg
    assert span % (nseg * max(32, pws)) == 0 and nseg <= FC["MAX_SEGMENTS"]
    assert plan.smem_bytes <= kfused._SMEM_LIMIT
    E, shift = 1 << hash_bits, 32 - hash_bits
    tdt = np.uint32 if plan.wide else np.uint16
    n = min(max(int(n), 0), P)
    last = n - FC["MIN_MATCH"]
    r = rng(seed)
    cand = np.full(P, -1, np.int64)
    length = np.zeros(P, np.int64)
    summaries = []
    for rank in range(C):
        lo, hi = rank * span, (rank + 1) * span
        sw, mis = stage(memory, start, B, P, lo, hi, max_match, plan.tab_off + 16, r)
        hsh = lambda q: ((word_at(sw, mis + q) * HASH_PRIME) & MASK32) >> shift  # noqa: E731
        tab = np.zeros((nseg, E), np.int64)
        lc = np.zeros(span, np.int64)
        lane = np.arange(32)
        seg = np.arange(nseg)[:, None]            # all warps of the CTA at once
        first = lo + np.arange(nseg)[:, None] * Ls

        def read(base):                           # (positions, valid, hash)
            p = base + lane[None, :]
            return p, p <= last, hsh(p)

        segs = np.broadcast_to(seg, (nseg, 32))

        def write(p, valid, h):                   # atomicMax of p + 1
            np.maximum.at(tab, (segs[valid], h[valid]), p[valid] + 1)

        if pws <= 32:
            for t in range(0, Ls, 32):            # a step: 32 / pws windows in order
                p, valid, h = read(first + t)
                for w in range(0, 32, pws):
                    mine = valid & (lane >= w) & (lane < w + pws)
                    lc[p[mine] - lo] = tab[seg, h][mine]
                    write(p, mine, h)
        else:
            for wb in range(0, Ls, pws):          # read the window, then write it
                for t in range(wb, wb + pws, 32):
                    p, valid, h = read(first + t)
                    lc[p[valid] - lo] = tab[seg, h][valid]
                for t in range(wb, wb + pws, 32):
                    p, valid, h = read(first + t)
                    write(p, valid, h)
        assert lc.max(initial=0) <= np.iinfo(tdt).max
        summaries.append(tab.max(0))
        incoming = np.max(summaries[:rank], axis=0) if rank else np.zeros(E, np.int64)
        pref = np.maximum.accumulate(np.vstack([incoming, tab]), axis=0)[:-1]
        p = np.arange(lo, hi)
        valid = p <= last
        w = word_at(sw, mis + p)
        c1 = np.where(valid, lc[p - lo], 0)
        c1 = np.where(valid & (c1 == 0),
                      pref[(p - lo) // Ls, ((w * HASH_PRIME) & MASK32) >> shift], c1)
        cd = np.where(valid, c1 - 1, -1)
        ok = (cd >= 0) & (p <= n - FC["MF_LIMIT"])
        ok &= word_at(sw, mis + np.maximum(cd, 0)) == w
        max_extra = np.clip(n - FC["LAST_LITERALS"] - (p + FC["MIN_MATCH"]), 0,
                            max_match - FC["MIN_MATCH"])
        j = np.zeros_like(p)
        live = ok & (j < max_extra)
        while live.any():
            x = (word_at(sw, mis + np.where(live, p + 4 + j, 0))
                 ^ word_at(sw, mis + np.where(live, cd + 4 + j, 0)))
            hit = live & (x != 0)
            j = np.where(hit, j + (ctz32(np.where(hit, x, 1)) >> 3), j)
            j = np.where(live & ~hit, j + 4, j)
            live = live & ~hit & (j < max_extra)
        cand[lo:hi] = cd
        length[lo:hi] = np.where(ok, FC["MIN_MATCH"] + np.minimum(j, max_extra), 0)
    return cand.astype(np.int32), length.astype(np.int32)


def boundary_row(P: int, C: int, r) -> bytes:
    """Noise with one word repeated on both sides of every CTA boundary
    (hash peers that straddle two CTAs' ranges) and a run across each."""
    row = bytearray(r.integers(0, 256, P, np.uint8).tobytes())
    span = P // C
    for q in range(1, C):
        b = q * span
        word = bytes(r.integers(0, 256, 4, np.uint8))
        for at in (b - 40, b - 9, b - 4, b, b + 3, b + 33):
            row[at: at + 4] = word
        row[b - 20: b - 12] = b"\x5a" * 8
        row[b + 60: b + 100] = b"\x5a" * 40
    return bytes(row)


def fused_rows(P: int, C: int, seed: int):
    """(name, data, n): the boundary row; n of 0..13, inside every CTA's
    range and at P; the all-zero and run-heavy blocks; text."""
    r = rng(seed)
    span = P // C
    adv = adversarial_corpus()
    rows = [("boundary_peers", boundary_row(P, C, r), P)]
    base = adv["text"][:P] + b"\x00" * max(0, P - len(adv["text"]))
    rows += [(f"n{n}", base, n) for n in range(14)]
    rows += [(f"n_in_cta{q}", base, q * span + d)
             for q in range(C) for d in (5, 2 * 32 + 3)]
    for name in ("all_zero_block", "rle_runs", "low_entropy", "structured"):
        d = adv[name][:P]
        rows.append((name, d, len(d)))
    return rows


def fused_batch(rows, P: int, B: int, offset: int, seed: int):
    """`memory` holding the rows back to back from byte `offset` (noise
    before, between past n and after, as in a batch of rows), starts, ns."""
    r = rng(seed)
    M = len(rows)
    memory = r.integers(0, 256, offset + M * B + 64, np.uint8)
    starts, ns = [], []
    for j, (_, data, n) in enumerate(rows):
        s = offset + j * B
        memory[s: s + len(data)] = np.frombuffer(data, np.uint8)
        memory[s + n: s + B] = r.integers(0, 256, B - n, np.uint8)   # noise past n
        starts.append(s)
        ns.append(n)
    return memory, starts, np.array(ns, np.int32)


def plain_fused(memory, starts, ns, B, P, hb, pws, mm):
    stack = np.stack([memory[s: s + B] for s in starts])
    c, l = tref.fused_ref(torch.from_numpy(stack), torch.from_numpy(ns), P, hb, pws, mm)
    return c.numpy(), l.numpy(), stack


# (hash_bits, max_match, pws, P): chip_smoke.py's sweep and its extra corners;
# hash_bits >= 12 on small P (the plain version's grid is W x 2^hash_bits).
FUSED_CASES = [(8, 36, 8, MAX_BLOCK), (6, 12, 8, MAX_BLOCK), (10, 68, 4, MAX_BLOCK),
               (8, 36, 16, MAX_BLOCK), (12, 36, 8, 8192), (16, 36, 8, 4096),
               (8, 36, 64, MAX_BLOCK), (13, 20, 32, 8192), (8, 36, 2048, 6144),
               (1, 36, 1, 4096)]


def test_fused_constants_and_plans_from_the_source():
    assert FC["CLUSTER"] == kfused.CLUSTER and FC["MAX_SEGMENTS"] == 32
    assert FC["THREADS"] == 32 * FC["MAX_SEGMENTS"]
    B = MAX_BLOCK + 71
    main = kfused._plan(B, MAX_BLOCK, 8, 8)
    assert (main.cluster, main.nseg, main.tables_in_shared, main.wide) == (
        FC["CLUSTER"], 32, True, False)
    assert main.smem_bytes == MAX_BLOCK + 32 + 33 * 4 * 256 + MAX_BLOCK // main.cluster * 2
    for hb, mm, pws, P in FUSED_CASES + [(16, 36, 8, MAX_BLOCK), (8, 36, 8, 2 * MAX_BLOCK)]:
        for cluster in (1, 2, 4, 8):
            plan = kfused._plan(P + 71, P, hb, pws, cluster)
            span = P // plan.cluster
            assert plan.cluster <= cluster and span % (plan.nseg * max(32, pws)) == 0
            assert plan.smem_bytes <= kfused._SMEM_LIMIT
            assert plan.tab_off == P + 32 and plan.lc_off % 16 == 0
            assert plan.wide == (P > 65536)


@pytest.mark.parametrize("hb,mm,pws,P", FUSED_CASES)
def test_fused_model_equals_plain(hb, mm, pws, P):
    B = P + 71
    rows = fused_rows(P, kfused._plan(B, P, hb, pws).cluster, seed=hb * 100 + pws)
    if hb >= 10:                       # the plain version's grid is W x 2^hb
        rows = rows[:1] + rows[15:18] + rows[-4:-2]
    for offset in (0, 3):              # rows at every alignment mod 4 and 16
        memory, starts, ns = fused_batch(rows, P, B, 64 + offset, seed=offset + P)
        c_p, l_p, _ = plain_fused(memory, starts, ns, B, P, hb, pws, mm)
        for j, (name, _, n) in enumerate(rows):
            c, l = fused_model_np(memory, starts[j], B, n, P, hb, pws, mm, seed=j)
            np.testing.assert_array_equal(c, c_p[j], err_msg=f"{name} cand")
            np.testing.assert_array_equal(l, l_p[j], err_msg=f"{name} lengths")


def test_fused_model_at_every_cluster_size():
    """Clusters of 1, 2 and 8 (and 4, the default) give the same answer."""
    P, hb, mm, pws = MAX_BLOCK, 8, 36, 8
    B = P + 71
    rows = fused_rows(P, 8, seed=5)[:1] + fused_rows(P, 8, seed=5)[15:25:3]
    memory, starts, ns = fused_batch(rows, P, B, 77, seed=6)
    c_p, l_p, _ = plain_fused(memory, starts, ns, B, P, hb, pws, mm)
    for cluster in (1, 2, 8):
        for j, (name, _, n) in enumerate(rows):
            c, l = fused_model_np(memory, starts[j], B, n, P, hb, pws, mm, cluster)
            np.testing.assert_array_equal(c, c_p[j], err_msg=f"{name} C={cluster}")
            np.testing.assert_array_equal(l, l_p[j], err_msg=f"{name} C={cluster}")


@functools.lru_cache(maxsize=None)
def jax_fused(P: int, hb: int, pws: int, mm: int, use_pallas: bool):
    return jax.jit(functools.partial(jops.fused_match_candidates, positions=P,
                                     hash_bits=hb, pws=pws, max_match=mm,
                                     use_pallas=use_pallas))


@pytest.mark.parametrize("hb,mm,pws,P,use_pallas",
                         [(8, 36, 8, MAX_BLOCK, True), (10, 68, 4, MAX_BLOCK, False),
                          (8, 36, 2048, 6144, True), (16, 36, 8, 4096, False)])
def test_fused_model_equals_jax(hb, mm, pws, P, use_pallas):
    B = P + 71
    rows = fused_rows(P, kfused._plan(B, P, hb, pws).cluster, seed=hb + pws)
    rows = [rows[0], rows[5], rows[16], rows[-4]]
    memory, starts, ns = fused_batch(rows, P, B, 129, seed=hb)
    fn = jax_fused(P, hb, pws, mm, use_pallas)
    for j, (name, _, n) in enumerate(rows):
        masked = memory[starts[j]: starts[j] + B].astype(np.int32)
        masked[n:] = 0                      # the JAX package takes zeros past n
        c_j, l_j = fn(jnp.asarray(masked), jnp.int32(n))
        c, l = fused_model_np(memory, starts[j], B, n, P, hb, pws, mm)
        np.testing.assert_array_equal(c, np.asarray(c_j), err_msg=f"{name} cand")
        np.testing.assert_array_equal(l, np.asarray(l_j), err_msg=f"{name} lengths")


def test_fused_model_wide_positions():
    """P > 65536: uint32 tables and candidates (the kernel keeps them in the
    cand output), equal to the plain version past position 65536."""
    P, hb, mm, pws = 2 * MAX_BLOCK, 6, 36, 8
    B = P + 40
    data = (adversarial_corpus()["text"] * 3)[:P]
    rows = [("text_wide", data, P), ("n_past_65536", data, 70001)]
    memory, starts, ns = fused_batch(rows, P, B, 1, seed=9)
    c_p, l_p, _ = plain_fused(memory, starts, ns, B, P, hb, pws, mm)
    assert kfused._plan(B, P, hb, pws).wide
    for j, (name, _, n) in enumerate(rows):
        c, l = fused_model_np(memory, starts[j], B, n, P, hb, pws, mm)
        np.testing.assert_array_equal(c, c_p[j], err_msg=name)
        np.testing.assert_array_equal(l, l_p[j], err_msg=name)
    assert (c_p[0][MAX_BLOCK:] > MAX_BLOCK).any()
