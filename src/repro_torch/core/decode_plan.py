"""Two-phase block decode: parse the token stream once into a flat copy plan.

This is the software analogue of the paper's feedback-free pipeline run in
reverse (and of Sitaridi et al., arXiv 1606.00519, on GPUs): instead of
interleaving *parsing* (serial by construction — every sequence's position
depends on the previous one) with *copying* (bulk data movement), we separate
them:

  plan_block     — one pass over the token stream; no byte is copied.  The
                   result is a ``BlockPlan``: flat NumPy arrays of literal
                   spans (src in the block, dst in the output) and match
                   copies (dst, src = dst - offset, length).  All format
                   validation happens here, with the output cap enforced
                   BEFORE each span is admitted to the plan, so a malicious
                   length field can never force an allocation past `max_out`.
  execute_plan   — bulk execution: every literal span lands with ONE fancy-
                   index gather; match copies run in dependency *waves* —
                   each wave executes every match whose source bytes are
                   already materialized as one vectorized gather/scatter
                   (matches only ever read output produced strictly before
                   their own write position, so readiness is an interval
                   query against the still-pending write intervals, fully
                   vectorizable because write intervals are disjoint and
                   sorted).  Pathological chains (e.g. RLE-style blocks where
                   every match reads the previous match's output) would
                   degrade to one match per wave, so after ``wave_limit``
                   waves — or when a wave goes thin — execution falls back to
                   an in-order chunked copy loop, which is always correct.

`decode_block_planned` composes the two and is bit-identical to the serial
`decode_block` / `decode_block_bytewise` oracles (asserted in tests on
random, adversarial, and overlap-heavy corpora).

Device-side execution (the read-path mirror of the compress engine's
device-resident emit) needs one more shape: `BlockPlan` is ragged — every
block has a different number of literal runs and matches — but a jit graph
wants uniform arrays.  `DevicePlan` is the fixed-shape, padding-aware form:
flat int32 arrays sized by `DevicePlanCaps`, so a micro-batch of blocks
stacks into `(M, cap)` arrays exactly like the compress side's block stack.
`to_device_plan` converts (rejecting plans that exceed the caps with
`DevicePlanOverflow`, which callers turn into a host fallback), and
`execute_device_plan` is the NumPy oracle of the device algorithm:

  the dependency-wave formulation above is data-dependent (an RLE chain
  degrades to one match per wave — fine on the host, where a sequential
  fallback exists, fatal in a fixed-shape graph).  Instead, every output
  byte's *immediate* source is a pure function of the plan (literal bytes
  point at the input block, match bytes at output position ``k - offset``),
  and the transitive source is resolved by POINTER DOUBLING: after r
  rounds of ``ptr = ptr[ptr]`` every chain of depth <= 2^r lands on a
  literal byte, so ceil(log2(MAX_BLOCK)) = 16 rounds suffice for ANY valid
  block — pathological chains included, no fallback path.  `DevicePlan`'s
  per-sequence ``wave`` index records the round at which each match's bytes
  resolve; its max (``n_waves``) lets the decode engine run fewer doubling
  rounds for shallow micro-batches.

A copy of the JAX package's NumPy planner (that module imports no JAX, but
this package imports nothing of the reference).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from .decoder import LZ4FormatError

__all__ = ["BlockPlan", "DevicePlan", "DevicePlanCaps", "DevicePlanOverflow",
           "MAX_RESOLVE_ROUNDS", "plan_block", "plan_block_fast",
           "execute_plan", "execute_device_plan", "to_device_plan",
           "decode_block_planned"]


@dataclasses.dataclass
class BlockPlan:
    """Flat copy plan for one block (all arrays int64, spans in bytes).

    Literal run r copies ``block[lit_src[r] : lit_src[r]+lit_len[r]]`` to
    output position ``lit_dst[r]``; match m copies ``match_len[m]`` bytes
    from output position ``match_src[m]`` to ``match_dst[m]`` (LZ4
    semantics: the ranges may overlap, in which case the copy replicates
    the ``match_dst - match_src``-wide pattern).  Literal and match dst
    spans together tile ``[0, usize)`` exactly.
    """

    usize: int
    lit_src: np.ndarray
    lit_dst: np.ndarray
    lit_len: np.ndarray
    match_dst: np.ndarray
    match_src: np.ndarray
    match_len: np.ndarray

    @property
    def n_sequences(self) -> int:
        return len(self.lit_len) + len(self.match_len)


def plan_block(block: bytes, max_out: int | None = None) -> BlockPlan:
    """Parse an LZ4 block into a BlockPlan without copying any payload bytes.

    Raises LZ4FormatError on every malformation the serial decoders reject,
    with identical semantics: the `max_out` cap is checked before a literal
    run or match copy is admitted, never after.
    """
    lit_src: list[int] = []
    lit_dst: list[int] = []
    lit_lens: list[int] = []
    m_dst: list[int] = []
    m_src: list[int] = []
    m_len: list[int] = []
    i = 0
    out_len = 0
    n = len(block)
    blk = block
    while True:
        if i >= n:
            raise LZ4FormatError("truncated block: missing token")
        token = blk[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise LZ4FormatError("truncated literal length")
                b = blk[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise LZ4FormatError("truncated literals")
        if max_out is not None and out_len + lit_len > max_out:
            raise LZ4FormatError("output exceeds limit")
        if lit_len:
            lit_src.append(i)
            lit_dst.append(out_len)
            lit_lens.append(lit_len)
            out_len += lit_len
            i += lit_len
        if i == n:
            break  # final literals-only sequence
        if i + 2 > n:
            raise LZ4FormatError("truncated offset")
        offset = blk[i] | (blk[i + 1] << 8)
        i += 2
        if offset == 0:
            raise LZ4FormatError("zero offset")
        if offset > out_len:
            raise LZ4FormatError("offset beyond output")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise LZ4FormatError("truncated match length")
                b = blk[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        if max_out is not None and out_len + match_len > max_out:
            raise LZ4FormatError("output exceeds limit")
        m_dst.append(out_len)
        m_src.append(out_len - offset)
        m_len.append(match_len)
        out_len += match_len
    a = lambda xs: np.asarray(xs, np.int64)
    return BlockPlan(
        usize=out_len,
        lit_src=a(lit_src), lit_dst=a(lit_dst), lit_len=a(lit_lens),
        match_dst=a(m_dst), match_src=a(m_src), match_len=a(m_len),
    )


# Below this size the Python parse beats the full-width NumPy prepass.
_FAST_MIN = 2048

# Sequence-order error priorities for the vectorized validator (must mirror
# the check order of plan_block / decode_block exactly).
_ERR_MESSAGES = {
    1: "truncated literal length",
    2: "truncated literals",
    3: "output exceeds limit",
    4: "truncated offset",
    5: "zero offset",
    6: "offset beyond output",
    7: "truncated match length",
    8: "output exceeds limit",
}


class _PlanWorkspace:
    """Per-thread reusable buffers for the vectorized planner.

    Fresh NumPy allocations cost first-touch page faults per op — orders of
    magnitude more than the arithmetic at 64 KB scale — so every full-width
    intermediate writes into preallocated arrays via ``out=``.  One
    workspace per worker thread (threading.local), sized for MAX_BLOCK and
    reused for every block the thread decodes.
    """

    CAP = 65536  # MAX_BLOCK; avoid importing lz4_types for one constant

    def __init__(self):
        c = self.CAP
        self.idx = np.arange(c, dtype=np.int32)
        self.idxp1 = np.arange(1, c + 1, dtype=np.int32)
        self.ui = np.empty(c, np.int32)
        self.ffrun = np.zeros(c + 1, np.int32)
        self.i = [np.empty(c, np.int32) for _ in range(8)]
        self.b = [np.empty(c, bool) for _ in range(4)]
        # Execute-phase span-gather scratch (indices + staging bytes).
        self.span_a = np.empty(c, np.int32)
        self.span_b = np.empty(c, np.int32)
        self.u8tmp = np.empty(c, np.uint8)
        # Touch every page once so reuse never faults.
        for a in (self.ui, self.ffrun, *self.i, *self.b,
                  self.span_a, self.span_b, self.u8tmp):
            a.fill(0)


_tls = threading.local()


def _workspace() -> _PlanWorkspace:
    ws = getattr(_tls, "plan_ws", None)
    if ws is None:
        ws = _tls.plan_ws = _PlanWorkspace()
    return ws


def plan_block_fast(block: bytes, max_out: int | None = None) -> BlockPlan:
    """Vectorized `plan_block`: identical plans, identical rejections.

    The serial parse is feedback-limited only through each sequence's
    *position*; every field is a pure function of its byte offset.  So:
    compute token nibbles, 0xFF-run lengths, extended literal/match lengths,
    offsets, and next-sequence positions for EVERY byte position with NumPy
    (the feedback-free part, all ``out=`` into a per-thread workspace), then
    follow the next[] chain from position 0 (one memoryview hop per sequence
    — the only serial residue), and validate all visited sequences with one
    vectorized pass that reproduces the serial decoder's per-sequence check
    order.
    """
    n = len(block)
    if n == 0:
        raise LZ4FormatError("truncated block: missing token")
    if n < _FAST_MIN or n > _PlanWorkspace.CAP:
        return plan_block(block, max_out=max_out)
    ws = _workspace()
    u8 = np.frombuffer(block, np.uint8)
    idx = ws.idx[:n]
    idxp1 = ws.idxp1[:n]
    ui = ws.ui[:n]
    np.copyto(ui, u8)
    i1, i2, i3, i4, i5, i6, i7, i8 = (a[:n] for a in ws.i)
    b1, b2, b3, b4 = (a[:n] for a in ws.b)

    # ffrun[i] = length of the 0xFF run starting at i (ffrun[n] == 0).
    np.equal(u8, 255, out=b1)
    rev = b1[::-1]
    np.copyto(i1, idx)
    np.copyto(i1, -1, where=rev)          # i1 = idx where NOT a 255-run, else -1
    np.maximum.accumulate(i1, out=i1)     # last non-255 position (reversed frame)
    np.subtract(idx, i1, out=i1)          # run length ending at i (reversed)
    ffrun = ws.ffrun[: n + 1]
    np.copyto(ffrun[:n], i1[::-1])
    np.multiply(ffrun[:n], b1, out=ffrun[:n])  # zero where byte != 255
    ffrun[n] = 0

    np.right_shift(ui, 4, out=i2)         # i2 = literal nibble
    np.equal(i2, 15, out=b2)              # b2 = has literal extension
    np.take(ffrun, idxp1, out=i3)         # i3 = r1 (255-run after token)
    np.add(idxp1, i3, out=i4)             # i4 = terminator position
    np.greater_equal(i4, n, out=b3)
    np.logical_and(b3, b2, out=b3)        # b3 = truncated literal length
    np.minimum(i4, n - 1, out=i4)
    np.take(ui, i4, out=i5)               # i5 = terminator byte
    np.multiply(i3, 255, out=i4)
    np.add(i4, i5, out=i4)
    np.add(i4, 15, out=i4)                # i4 = extended literal length
    lit_len = i5
    np.copyto(lit_len, i2)
    np.copyto(lit_len, i4, where=b2)      # i5 = lit_len
    lit_start = i4
    np.add(idx, 1, out=lit_start)
    np.add(lit_start, 1, out=i1)
    np.add(i1, i3, out=i1)
    np.copyto(lit_start, i1, where=b2)    # i4 = lit_start (token + header)
    ls_end = i1
    np.add(lit_start, lit_len, out=ls_end)  # i1 = offset-field position

    np.bitwise_and(ui, 15, out=i2)        # i2 = match nibble
    np.equal(i2, 15, out=b1)              # b1 = has match extension (b1 reused)
    np.minimum(ls_end, n - 1, out=i6)
    np.take(ui, i6, out=i7)               # low offset byte
    np.add(i6, 1, out=i6)
    np.minimum(i6, n - 1, out=i6)
    np.take(ui, i6, out=i8)
    np.left_shift(i8, 8, out=i8)
    np.bitwise_or(i7, i8, out=i7)         # i7 = offset (garbage if truncated)
    np.add(ls_end, 2, out=i6)             # i6 = ext-byte position
    np.minimum(i6, n, out=i3)
    np.take(ffrun, i3, out=i8)            # i8 = r2
    np.add(i6, i8, out=i6)                # i6 = match terminator position
    np.greater_equal(i6, n, out=b4)
    np.logical_and(b4, b1, out=b4)        # b4 = truncated match length
    np.minimum(i6, n - 1, out=i6)
    np.take(ui, i6, out=i3)               # i3 = terminator byte
    np.multiply(i8, 255, out=i6)
    np.add(i6, i3, out=i3)
    np.add(i3, 19, out=i3)                # i3 = extended match length
    mlen = i6
    np.add(i2, 4, out=mlen)
    np.copyto(mlen, i3, where=b1)         # i6 = match_len
    nxt = i2
    np.add(ls_end, 2, out=nxt)
    np.add(i8, 1, out=i8)
    np.add(nxt, i8, out=i3)
    np.copyto(nxt, i3, where=b1)          # i2 = next sequence position

    # Serial residue: hop the sequence chain.  For a valid final sequence
    # ls_end == n and nxt > n, so the walk exits on pos >= n either way;
    # headers are >= 1 byte, so nxt > pos and the walk always terminates.
    nxt_mv = memoryview(nxt)
    starts = []
    append = starts.append
    pos = 0
    while pos < n:
        append(pos)
        pos = nxt_mv[pos]

    T = np.asarray(starts, np.int64)
    ll = lit_len[T].astype(np.int64)
    ls_end_T = ls_end[T].astype(np.int64)
    final_ok = bool(ls_end_T[-1] == n)
    nonfinal = ls_end_T != n
    if not final_ok:
        # Chain left the block without a final literals-only sequence.  If
        # it ended exactly at n after a match, the serial decoders see a
        # missing token; field-level truncations are reported below.
        nonfinal[-1] = True
    ml = np.where(nonfinal, mlen[T].astype(np.int64), 0)
    off_T = i7[T].astype(np.int64)
    total = np.cumsum(ll + ml)
    before_match = total - ml      # output length after seq's literals
    prev_total = before_match - ll  # output length before the sequence

    # Vectorized validation, in the serial decoders' per-sequence order.
    err = np.zeros(len(T), np.int8)

    def _mark(cond, code):
        np.copyto(err, code, where=(err == 0) & cond)

    _mark(b3[T], 1)
    _mark(ls_end_T > n, 2)
    if max_out is not None:
        _mark(prev_total + ll > max_out, 3)
    _mark(nonfinal & (ls_end_T + 2 > n), 4)
    _mark(nonfinal & (off_T == 0), 5)
    _mark(nonfinal & (off_T > before_match), 6)
    _mark(nonfinal & b4[T], 7)
    if max_out is not None:
        _mark(nonfinal & (before_match + ml > max_out), 8)
    bad = np.nonzero(err)[0]
    if len(bad):
        raise LZ4FormatError(_ERR_MESSAGES[int(err[bad[0]])])
    if not final_ok:
        raise LZ4FormatError("truncated block: missing token")

    keep = ll > 0
    return BlockPlan(
        usize=int(total[-1]),
        lit_src=lit_start[T].astype(np.int64)[keep],
        lit_dst=prev_total[keep],
        lit_len=ll[keep],
        match_dst=before_match[nonfinal],
        match_src=before_match[nonfinal] - off_T[nonfinal],
        match_len=ml[nonfinal],
    )


def _span_fill(starts: np.ndarray, lens: np.ndarray, buf: np.ndarray) -> np.ndarray:
    """Fill ``buf`` with the flat indices covering every [start, start+len).

    Standard delta/cumsum expansion, O(total) with no Python loop, writing
    into a workspace buffer so repeated calls never fault fresh pages.  All
    ``lens`` must be > 0.  Returns the filled view.
    """
    total = int(lens.sum())
    v = buf[:total]
    v.fill(1)
    ends = np.cumsum(lens)
    v[0] = starts[0]
    if len(starts) > 1:
        v[ends[:-1]] = starts[1:] - starts[:-1] - lens[:-1] + 1
    np.cumsum(v, out=v)
    return v


def _finish_sequential(out: np.ndarray, d: np.ndarray, s: np.ndarray,
                       L: np.ndarray) -> None:
    """In-order chunked copies for the remaining matches, in bytes-land.

    Per-element NumPy slicing costs ~µs per match; for the typical 36-byte
    paper-capped match a memoryview slice copy is ~10x cheaper while large
    spans still move at memcpy speed.  Always correct (strict stream
    order), used when wave scheduling stops paying.
    """
    mv = memoryview(out)
    for dst, src, ln in zip(d.tolist(), s.tolist(), L.tolist()):
        off = dst - src
        if off >= ln:
            mv[dst:dst + ln] = mv[src:src + ln]
        else:
            pattern = bytes(mv[src:dst])
            reps = -(-ln // off)
            mv[dst:dst + ln] = (pattern * reps)[:ln]


def execute_plan(block: bytes, plan: BlockPlan, out: np.ndarray | None = None,
                 wave_limit: int = 8, min_wave: int = 256) -> np.ndarray:
    """Materialize a BlockPlan into a uint8 output array.

    ``out`` may be a caller-provided view of exactly ``plan.usize`` bytes
    (e.g. a disjoint slice of one preallocated output buffer; the decode
    engine currently returns per-block bytes instead, since its process
    executor must ship results across the pool anyway).

    Hybrid bulk execution, adaptively picking the cheaper mechanism:

      literals     — one fancy-index gather for ALL runs at once (span
                     expansion through the per-thread workspace), or a
                     memoryview copy loop when there are few runs;
      matches      — dependency *waves*: every match whose source bytes are
                     already materialized executes in one vectorized
                     gather/scatter per wave (readiness is an interval query
                     against the still-pending write intervals — pending
                     writes are disjoint and sorted, so two binary searches
                     per match).  Overlapping matches (offset < length)
                     replicate their pattern chunkwise; thin waves and
                     pathological chains fall back to in-order memoryview
                     copies after ``wave_limit`` waves (always correct).
    """
    if out is None:
        out = np.empty(plan.usize, np.uint8)
    elif len(out) != plan.usize:
        raise ValueError(f"out buffer is {len(out)} bytes, plan needs {plan.usize}")
    if plan.usize == 0:
        return out
    ws_ok = plan.usize <= _PlanWorkspace.CAP
    # Phase 1: literals.
    nlit = len(plan.lit_len)
    if nlit >= 64 and ws_ok:
        ws = _workspace()
        blk = np.frombuffer(block, np.uint8)
        src_v = _span_fill(plan.lit_src, plan.lit_len, ws.span_a)
        dst_v = _span_fill(plan.lit_dst, plan.lit_len, ws.span_b)
        np.take(blk, src_v, out=ws.u8tmp[: len(src_v)])
        out[dst_v] = ws.u8tmp[: len(src_v)]
    elif nlit:
        mv = memoryview(out)
        src_mv = memoryview(block)
        for dst, src, ln in zip(plan.lit_dst.tolist(), plan.lit_src.tolist(),
                                plan.lit_len.tolist()):
            mv[dst:dst + ln] = src_mv[src:src + ln]
    # Phase 2: match copies in dependency waves.
    d, s, L = plan.match_dst, plan.match_src, plan.match_len
    if not len(d):
        return out
    pend = np.arange(len(d))
    waves = 0
    while pend.size:
        if waves >= wave_limit or not ws_ok:
            _finish_sequential(out, d[pend], s[pend], L[pend])
            break
        dp, sp, Lp = d[pend], s[pend], L[pend]
        dep = dp + Lp
        # A pending match needs [sp, min(sp+Lp, dp)) materialized before it
        # can run (bytes at/after its own dst are produced by the copy
        # itself — that is the overlap-replication case, handled below).
        need_end = np.minimum(sp + Lp, dp)
        lo = np.searchsorted(dep, sp, side="right")
        hi = np.searchsorted(dp, need_end, side="left")
        ready = lo >= hi
        sel_size = int(ready.sum())
        if sel_size < min_wave and sel_size < pend.size:
            # Thin wave: vectorization overhead beats the win; finish in order.
            _finish_sequential(out, d[pend], s[pend], L[pend])
            break
        ds, ss, Ls = dp[ready], sp[ready], Lp[ready]
        overlap = (ds - ss) < Ls
        if overlap.any():
            # Overlap-ready matches are mutually independent (their reads
            # hit only materialized bytes), so subset order is free.
            _finish_sequential(out, ds[overlap], ss[overlap], Ls[overlap])
        plain = ~overlap
        if plain.any():
            dsp, ssp, lsp = ds[plain], ss[plain], Ls[plain]
            if dsp.size < 64:
                _finish_sequential(out, dsp, ssp, lsp)
            else:
                ws = _workspace()
                src_v = _span_fill(ssp, lsp, ws.span_a)
                dst_v = _span_fill(dsp, lsp, ws.span_b)
                np.take(out, src_v, out=ws.u8tmp[: len(src_v)])
                out[dst_v] = ws.u8tmp[: len(src_v)]
        pend = pend[~ready]
        waves += 1
    return out


# ---------------------------------------------------------------------------
# Fixed-shape device plans (the jit-consumable form of BlockPlan)
# ---------------------------------------------------------------------------

# ceil(log2(MAX_BLOCK)): after this many pointer-doubling rounds every
# source chain in a <= 64 KB output is resolved (chain positions strictly
# decrease, so depth < 2^16), for ANY valid plan.  The static worst case.
MAX_RESOLVE_ROUNDS = 16


class DevicePlanOverflow(ValueError):
    """Plan does not fit the fixed-shape caps; caller should fall back to
    host execution for this block (the decode engine does, and counts it)."""


@dataclasses.dataclass(frozen=True)
class DevicePlanCaps:
    """Static array sizes for `DevicePlan` (= compiled-shape axes).

    Defaults are sized for the paper scheme the compress engine emits: one
    match per `pws`-byte window caps matches at MAX_BLOCK/8 = 8192 (plus
    one literal run per match + the final run), padded up for lane
    alignment.  Foreign LZ4 blocks can legally exceed this (down to 4-byte
    matches back to back — up to 16384); they overflow and decode on host.
    """

    max_lit: int = 8448      # literal-span slots (engine scheme: <= 8193)
    max_match: int = 8448    # match slots (engine scheme: <= 8192)
    blk_cap: int = 65536     # compressed-payload buffer (csize <= usize)
    out_cap: int = 65536     # decoded-output buffer (usize <= MAX_BLOCK)


_DEFAULT_CAPS = DevicePlanCaps()


@dataclasses.dataclass
class DevicePlan:
    """Fixed-shape `BlockPlan`: flat int32 arrays padded to `caps` sizes.

    Rows past `n_lit` / `n_match` are zero padding and must be ignored
    (the device graph masks them by slot index, not by sentinel values).
    ``wave[m]`` is the pointer-doubling round at which match m's bytes are
    fully resolved (see module docstring); ``n_waves`` is the block's max —
    the number of on-device gather rounds this plan actually needs.  When
    the converter is asked to skip wave analysis, ``wave`` is -1 and
    ``n_waves`` is the static worst case `MAX_RESOLVE_ROUNDS`.
    """

    caps: DevicePlanCaps
    lit_src: np.ndarray    # (max_lit,) int32 — source offset in the block
    lit_dst: np.ndarray    # (max_lit,) int32 — dest offset in the output
    lit_len: np.ndarray    # (max_lit,) int32
    match_dst: np.ndarray  # (max_match,) int32
    match_off: np.ndarray  # (max_match,) int32 — back-offset (dst - src)
    match_len: np.ndarray  # (max_match,) int32
    wave: np.ndarray       # (max_match,) int32 — resolve round (or -1)
    n_lit: int
    n_match: int
    out_size: int
    n_waves: int

    @property
    def n_sequences(self) -> int:
        return self.n_lit + self.n_match


def _expand_spans(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat indices covering every [start, start+len) — fresh-array twin of
    `_span_fill` for the conversion path (not perf-critical there)."""
    total = int(lens.sum())
    v = np.ones(total, np.int64)
    ends = np.cumsum(lens)
    v[0] = starts[0]
    if len(starts) > 1:
        v[ends[:-1]] = starts[1:] - starts[:-1] - lens[:-1] + 1
    np.cumsum(v, out=v)
    return v


def _byte_sources(plan: BlockPlan):
    """Per-output-byte immediate source maps (the device layout, in NumPy).

    Returns ``(is_lit, lit_blk, ptr)`` over ``[0, plan.usize)``:
    ``is_lit[k]`` marks bytes produced by a literal run, ``lit_blk[k]`` is
    their source index in the compressed block, and ``ptr[k]`` is one
    application of the source function f — k itself for literal bytes
    (fixed point), ``k - offset`` for match bytes.
    """
    usize = plan.usize
    is_lit = np.zeros(usize, bool)
    lit_blk = np.zeros(usize, np.int64)
    ptr = np.arange(usize, dtype=np.int64)
    if len(plan.lit_len):
        dst_v = _expand_spans(plan.lit_dst, plan.lit_len)
        is_lit[dst_v] = True
        lit_blk[dst_v] = _expand_spans(plan.lit_src, plan.lit_len)
    if len(plan.match_len):
        md_v = _expand_spans(plan.match_dst, plan.match_len)
        off_v = np.repeat(plan.match_dst - plan.match_src, plan.match_len)
        ptr[md_v] = md_v - off_v
    return is_lit, lit_blk, ptr


def _resolve_rounds(is_lit: np.ndarray, ptr: np.ndarray):
    """Run pointer doubling to a fixed point; returns (ptr_resolved, round
    at which each byte resolved).  Bounded by MAX_RESOLVE_ROUNDS."""
    rounds = np.zeros(len(ptr), np.int32)
    resolved = is_lit[ptr] if len(ptr) else np.zeros(0, bool)
    r = 0
    while not resolved.all():
        r += 1
        assert r <= MAX_RESOLVE_ROUNDS, "unresolvable source chain"
        ptr = ptr[ptr]
        newly = is_lit[ptr] & ~resolved
        rounds[newly] = r
        resolved |= newly
    return ptr, rounds


def execute_device_plan(block: bytes, plan: BlockPlan) -> np.ndarray:
    """NumPy oracle of the DEVICE decode algorithm (`kernels.ops.decode_gather`).

    Same result as `execute_plan`, different mechanism: build the per-byte
    immediate-source maps, pointer-double to transitive literal sources,
    then materialize the whole output with ONE gather from the block.  The
    tests pin `execute_plan` == this == the plain PyTorch version, and
    `chip_smoke.py` pins the CUDA kernel to the plain version, so the device
    path has an explicit host twin.
    """
    if plan.usize == 0:
        return np.zeros(0, np.uint8)
    is_lit, lit_blk, ptr = _byte_sources(plan)
    ptr, _ = _resolve_rounds(is_lit, ptr)
    blk = np.frombuffer(block, np.uint8)
    return blk[lit_blk[ptr]]


def to_device_plan(plan: BlockPlan, caps: DevicePlanCaps | None = None,
                   compute_waves: bool = True) -> DevicePlan:
    """`BlockPlan` -> fixed-shape `DevicePlan` (raises `DevicePlanOverflow`
    when the plan exceeds ``caps``).

    ``compute_waves=True`` runs the host doubling analysis to fill the
    per-sequence ``wave`` index and the exact ``n_waves`` — O(usize·rounds)
    NumPy work that lets the decode engine dispatch shallow micro-batches
    with fewer on-device gather rounds.  ``False`` skips the analysis and
    pins ``n_waves`` to the always-correct `MAX_RESOLVE_ROUNDS`.
    """
    caps = caps or _DEFAULT_CAPS
    n_lit = len(plan.lit_len)
    n_match = len(plan.match_len)
    if n_lit > caps.max_lit:
        raise DevicePlanOverflow(
            f"{n_lit} literal runs exceed cap {caps.max_lit}")
    if n_match > caps.max_match:
        raise DevicePlanOverflow(
            f"{n_match} matches exceed cap {caps.max_match}")
    if plan.usize > caps.out_cap:
        raise DevicePlanOverflow(
            f"output size {plan.usize} exceeds cap {caps.out_cap}")

    def _pad(values: np.ndarray, cap: int) -> np.ndarray:
        out = np.zeros(cap, np.int32)
        out[: len(values)] = values
        return out

    wave = np.full(caps.max_match, -1, np.int32)
    n_waves = MAX_RESOLVE_ROUNDS
    if compute_waves:
        if plan.usize == 0:
            n_waves = 0
        else:
            is_lit, _, ptr = _byte_sources(plan)
            _, rounds = _resolve_rounds(is_lit, ptr)
            n_waves = int(rounds.max())
            if n_match:
                md_v = _expand_spans(plan.match_dst, plan.match_len)
                bounds = np.concatenate(
                    ([0], np.cumsum(plan.match_len)[:-1]))
                wave[:n_match] = np.maximum.reduceat(rounds[md_v], bounds)
    return DevicePlan(
        caps=caps,
        lit_src=_pad(plan.lit_src, caps.max_lit),
        lit_dst=_pad(plan.lit_dst, caps.max_lit),
        lit_len=_pad(plan.lit_len, caps.max_lit),
        match_dst=_pad(plan.match_dst, caps.max_match),
        match_off=_pad(plan.match_dst - plan.match_src, caps.max_match),
        match_len=_pad(plan.match_len, caps.max_match),
        wave=wave,
        n_lit=n_lit,
        n_match=n_match,
        out_size=plan.usize,
        n_waves=n_waves,
    )


def decode_block_planned(block: bytes, max_out: int | None = None,
                         fast: bool = True) -> bytes:
    """plan + execute; bit-identical to `decode_block`.

    ``fast=False`` forces the serial-parse planner (the reference the
    vectorized planner is tested against).
    """
    planner = plan_block_fast if fast else plan_block
    plan = planner(block, max_out=max_out)
    return execute_plan(block, plan).tobytes()
