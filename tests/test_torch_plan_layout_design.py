"""A NumPy model of how `csrc/plan_layout.cu` decomposes its work, held
against the plain version (`ref.plan_layout_ref`) on the CPU, exactly.

The model follows the kernel phase by phase: a row's [0, n) cut into one
slice per CTA of the cluster, each slice's chain nodes listed in offset
order with their int32 running sum, the slices' bases and counts, the
eight checks at each node with the lowest failing (offset, code) key; then
the output row cut into slices, the node covering a slice's first and last
byte found by the warp's 32-way search, the nodes between copied in windows
of WCAP, each window writing the bytes its nodes cover, and the rest
filled.  It checks that every output byte is written exactly once, by the
window or the fill, and that the groups of 4 and the ragged ends of
`write_range` tile each range.  The constants are parsed from the CUDA
source, so the model and its kernel cannot drift apart; WCAP is also run
small, so that a slice takes many windows.  The kernel itself runs only on
a GPU, where `chip_smoke.py` holds it against the same plain version.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core.decode_plan import DevicePlanCaps
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref

from test_torch_util import MAX_BLOCK, block_corpus, lying_corpus, rng

CAPS = DevicePlanCaps()
SRC = (_build.CSRC / "plan_layout.cu").read_text()
K = {k: int(re.search(rf"constexpr int {k} = (\d+);", SRC).group(1))
     for k in ("THREADS", "CLUSTER", "PER", "WCAP", "N_STATUS", "ERR_MISSING_TOKEN")}


def wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def warp_last_le(S: list, x: int) -> int:
    """The kernel's warp search: the last t with S[t] <= x, 32-way."""
    lo, hi = 0, len(S)
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        ok = [lane for lane in range(32) if lo + lane * step < hi
              and S[lo + lane * step] <= x]
        lo += max(ok) * step
        hi = min(lo + step, hi)
    return lo


def write_groups(lo: int, hi: int, vec: bool) -> list:
    """The positions `write_range` writes, in its three loops."""
    if lo >= hi:
        return []
    vlo = vhi = hi
    if vec:
        vlo = min((lo + 3) & ~3, hi)
        vhi = max(vlo, hi & ~3)
    out = list(range(lo, vlo)) + list(range(vhi, hi))
    for q in range(vlo >> 2, vhi >> 2):
        out += [4 * q + d for d in range(4)]
    return out


def model_row(f, n: int, max_out: int, max_lit: int, max_match: int,
              out_cap: int, wcap: int, vec_out: bool):
    """One row: (status list, total, lit_blk, ptr) as the kernel makes them."""
    is_start, lit_start, lit_len, ls_end, off, mlen, flags = f
    B, C = len(is_start), K["CLUSTER"]
    nn = min(max(n, 0), B)
    L = (-(-nn // C) + 3) & ~3
    slices = []
    for r in range(C):
        s0 = min(r * L, nn)
        s1 = min(s0 + L, nn)
        nodes, run, lits, matches, fin = [], 0, 0, 0, 0
        for i in range(s0, s1):
            if is_start[i] > 0:
                nonfinal = ls_end[i] != n
                nodes.append([i, run])
                run = wrap32(run + int(lit_len[i]) + (int(mlen[i]) if nonfinal else 0))
                lits += lit_len[i] > 0
                matches += nonfinal
                fin |= not nonfinal
        slices.append(dict(s0=s0, nodes=nodes, sum=run, n_lit=lits,
                           n_match=matches, final_ok=fin))
    base, cpre, b, cp = [], [], 0, 0
    for sl in slices:
        base.append(b)
        cpre.append(cp)
        b = wrap32(b + sl["sum"])
        cp += len(sl["nodes"])
    key = None
    for r, sl in enumerate(slices):
        for nd in sl["nodes"]:
            i, prev = nd[0], wrap32(base[r] + nd[1])
            ll, ls, o, ml, fl = (int(lit_len[i]), int(ls_end[i]), int(off[i]),
                                 int(mlen[i]), int(flags[i]))
            nonfinal = ls != n
            before = wrap32(prev + ll)
            checks = (fl & 1, ls > n, wrap32(prev + ll) > max_out,
                      nonfinal and wrap32(ls + 2) > n, nonfinal and o == 0,
                      nonfinal and o > before, nonfinal and fl & 2,
                      nonfinal and wrap32(before + ml) > max_out)
            code = next((c + 1 for c, bad in enumerate(checks) if bad), 0)
            if code:
                key = min(key, (i, code)) if key else (i, code)
            nd[1] = prev
    lits = sum(sl["n_lit"] for sl in slices)
    matches = sum(sl["n_match"] for sl in slices)
    out_size = b
    code = key[1] if key else (0 if any(sl["final_ok"] for sl in slices)
                               else K["ERR_MISSING_TOKEN"])
    over = int(lits > max_lit or matches > max_match or out_size > out_cap)
    clean = code == 0 and not over
    status = [code, lits, matches, out_size, over]

    lit_blk = np.full(out_cap, -7, np.int64)
    ptr = np.full(out_cap, -7, np.int64)
    hits = np.zeros(out_cap, np.int64)
    Q = (-(-out_cap // C) + 3) & ~3
    for r in range(C):
        a = min(r * Q, out_cap)
        bnd = min(a + Q, out_cap)
        e = max(a, min(bnd, out_size)) if clean else a
        if e > a:
            def cover(x):
                j = C - 1
                while j > 0 and not (slices[j]["nodes"] and base[j] <= x):
                    j -= 1
                return cpre[j] + warp_last_le([nd[1] for nd in slices[j]["nodes"]], x)

            def node(g):
                j = C - 1
                while j > 0 and not (slices[j]["nodes"] and cpre[j] <= g):
                    j -= 1
                return slices[j]["nodes"][g - cpre[j]]

            g0, g1 = cover(a), cover(e - 1)
            g = g0
            while g <= g1:
                cnt = min(wcap, g1 - g + 1)
                win = [node(g + w) for w in range(cnt)]
                S = np.array([nd[1] for nd in win])
                hi = node(g + cnt)[1] if g + cnt <= g1 else e
                lo = a if g == g0 else int(S[0])
                p = np.array(write_groups(lo, hi, vec_out), np.int64)
                if p.size:
                    w = np.searchsorted(S, p, side="right") - 1
                    assert (w >= 0).all()
                    idx = np.array([nd[0] for nd in win])[w]
                    s = S[w]
                    lit = p - s < lit_len[idx]
                    lit_blk[p] = np.where(lit, lit_start[idx] + (p - s), 0)
                    ptr[p] = np.where(lit, p, np.clip(p - off[idx], 0, out_cap - 1))
                    np.add.at(hits, p, 1)
                g += wcap
        p = np.array(write_groups(e, bnd, vec_out), np.int64)
        if p.size:
            lit_blk[p], ptr[p] = 0, p
            np.add.at(hits, p, 1)
    assert (hits == 1).all(), "every output byte written exactly once"
    return status, out_size if clean else 0, lit_blk, ptr


def model(fields, n, max_out, max_lit, max_match, out_cap, wcap):
    rows = [model_row([f[m].numpy().astype(np.int64) for f in fields], int(n[m]),
                      int(max_out[m]), max_lit, max_match, out_cap, wcap,
                      out_cap % 4 == 0)
            for m in range(len(n))]
    return (torch.tensor([r[0] for r in rows], dtype=torch.int32),
            torch.tensor([r[1] for r in rows], dtype=torch.int32),
            torch.from_numpy(np.stack([r[2] for r in rows])).to(torch.int32),
            torch.from_numpy(np.stack([r[3] for r in rows])).to(torch.int32))


def chain_row(r, n: int) -> bytes:
    """A valid block of about n bytes: sequences of 1..14 literals and
    4..18-byte matches whose offsets point anywhere into the output so far,
    then 5 final literals."""
    out, size = bytearray(), 0
    while len(out) < n:
        lit = int(r.integers(1, 15))
        body = r.integers(0, 256, lit, np.uint8).tobytes()
        o = int(r.integers(1, size + lit + 1))
        ml = int(r.integers(0, 15))
        out += bytes([lit << 4 | ml]) + body + o.to_bytes(2, "little")
        size += lit + ml + 4
    return bytes(out) + b"\x50" + r.integers(0, 256, 5, np.uint8).tobytes()


def rows_and_fields(payloads, width):
    buf = np.zeros((len(payloads), width), np.uint8)
    ns = np.zeros((len(payloads),), np.int32)
    for j, p in enumerate(payloads):
        buf[j, : len(p)] = np.frombuffer(p, np.uint8)
        ns[j] = len(p)
    n = torch.from_numpy(ns)
    return tref.plan_fields_ref(torch.from_numpy(buf), n), n


def test_constants_from_the_source():
    assert K["CLUSTER"] == 8 and K["THREADS"] % 32 == 0
    assert K["THREADS"] // 32 <= 32       # one warp scans the warp totals
    assert K["PER"] % 4 == 0              # is_start read as int4
    assert K["N_STATUS"] == ops.SPEC_STATUS
    assert K["ERR_MISSING_TOKEN"] == ops.SPEC_ERR_MISSING_TOKEN
    # A window at the engine's caps holds every node of an output slice: a
    # node other than the final one covers at least 4 bytes.
    q = (-(-CAPS.out_cap // K["CLUSTER"]) + 3) & ~3
    assert K["WCAP"] >= q // 4 + 2


@pytest.mark.parametrize("wcap", [K["WCAP"], 5])
@pytest.mark.parametrize("out_cap", [CAPS.out_cap, 4099, 64])
def test_model_equals_plain(wcap, out_cap):
    corpus = block_corpus()
    r = rng(77)
    payloads = [corpus[k] for k in ("cmp_text", "zeros", "rle_529", "lit_text",
                                    "final_ext", "lit_empty")]
    payloads += [b for b, _ in lying_corpus().values()]
    payloads += [chain_row(r, 3000), chain_row(r, 40), b"", b"\x00"]
    max_outs = [MAX_BLOCK] * len(payloads)
    fields, n = rows_and_fields(payloads, CAPS.blk_cap + ops.SPEC_PAD)
    mo = torch.tensor(max_outs, dtype=torch.int32)
    args = (fields, n, mo, CAPS.max_lit, CAPS.max_match, out_cap)
    got = model(*args, wcap)
    want = tref.plan_layout_ref(*fields, n, mo, *args[3:])
    for g, w, name in zip(got, want, ("status", "total", "lit_blk", "ptr")):
        assert torch.equal(g, w), name
    valid = list(range(6)) + [len(payloads) - 4, len(payloads) - 3]
    assert (got[0][valid, ops.SPEC_ERR] == 0).all()
    if out_cap == CAPS.out_cap:           # the valid rows are clean
        assert (got[1][valid] == got[0][valid, ops.SPEC_OUT_SIZE]).all()


@pytest.mark.parametrize("seed", range(4))
def test_model_equals_plain_on_damaged_chains(seed):
    """Dense valid chains, the same cut short or with bytes flipped (errors
    at any node, sums past max_out), and random max_out, at a window of 3
    nodes."""
    r = rng(900 + seed)
    payloads, max_outs = [], []
    for j in range(10):
        p = bytearray(chain_row(r, int(r.integers(10, 4000))))
        if j % 3 == 0:
            p = p[: len(p) // 2]
        elif r.random() < 0.6:
            for _ in range(int(r.integers(1, 4))):
                p[int(r.integers(0, len(p)))] = int(r.integers(0, 256))
        payloads.append(bytes(p))
        max_outs.append(int(r.choice([MAX_BLOCK, int(r.integers(0, 20000))])))
    fields, n = rows_and_fields(payloads, 4096 + ops.SPEC_PAD + 3)
    mo = torch.tensor(max_outs, dtype=torch.int32)
    args = (fields, n, mo, CAPS.max_lit, 700, 16384)
    got = model(*args, 3)
    want = tref.plan_layout_ref(*fields, n, mo, *args[3:])
    for g, w, name in zip(got, want, ("status", "total", "lit_blk", "ptr")):
        assert torch.equal(g, w), name
    assert (got[1] > 0).any() and (got[0][:, ops.SPEC_ERR] > 0).any()
