"""Ops of both paths: stock torch layout stages + dispatch to the hand kernels.

Counterpart of the JAX package's `kernels/ops.py`.  The prefix-sum /
scatter layout stages that the reference leaves to XLA stay stock torch ops
here (`torch.cummax`, `torch.cumsum`, `scatter_reduce_`), except on the
read path's fused `plan_decode`, where the `plan_layout` kernel takes the
place of `plan_speculative`'s validation and compaction and of
`_decode_layout`; the kernels proper are reached through their wrappers,
which launch the CUDA kernel for tensors on the card and run the plain
version for tensors on the CPU.  Everything is batched over a leading ``M``
axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.lz4_types import MIN_MATCH

from . import ref
from .crc32 import crc32
from .decode_wave import decode_wave
from .emit_scatter import emit_scatter
from .fibhash import fibhash
from .fused_compress import fused_compress
from .match_extend import match_extend
from .plan_layout import plan_layout
from .plan_speculative import plan_speculative as plan_fields
from .ref import (  # noqa: F401  (the status lanes, re-exported)
    SPEC_ERR,
    SPEC_ERR_MISSING_TOKEN,
    SPEC_N_LIT,
    SPEC_N_MATCH,
    SPEC_OUT_SIZE,
    SPEC_OVERFLOW,
    SPEC_STATUS,
)


def hash_positions(blocks_u8, hash_bits: int = 8, positions: int | None = None):
    """Word + Fibonacci hash at every position of each (M, B) uint8 row.

    Each word reads bytes p..p+3, so at most B - 3 positions have one;
    ``positions`` (default B - 3) takes the first P of them without copying
    the rows.  Returns ``(words, hashes)``, both (M, P) int32: the word as
    the bit pattern of its uint32 value and the hash in [0, 2^hash_bits).
    """
    P = blocks_u8.shape[1] - 3 if positions is None else positions
    return fibhash(blocks_u8, P, hash_bits)


def match_lengths(blocks_u8, cand, valid, ns, max_match: int = 36):
    """Bounded match length per position (0 where ~valid, else in
    [4, max_match]).

    blocks_u8 : (M, B) uint8; cand (M, P) int32; valid (M, P) bool;
    ns (M,) int32.  Every block read is clamped to the row, so garbage
    candidates where ~valid are harmless.
    """
    return match_extend(blocks_u8, cand, valid, ns, max_match)


def fused_match_candidates(blocks_u8, ns, positions: int, hash_bits: int = 8,
                           pws: int = 8, max_match: int = 36):
    """Fused hash -> last-value-table candidate -> bounded-match datapath.

    blocks_u8 : (M, B) uint8; bytes at index >= ns[m] are ignored;
                B >= positions + max_match (the padded compressor block)
    ns        : (M,) int32 true block lengths
    positions : position count P

    Returns ``(cand, lengths)``, both (M, P) int32: the candidate per
    position (-1 where none) and the full bounded match length (0 where no
    valid match).
    """
    return fused_compress(blocks_u8, ns, positions, hash_bits=hash_bits,
                          pws=pws, max_match=max_match)


def _ext_len(v):
    """Extension byte count for a token-nibble value (literal count or
    match_len - MIN_MATCH): 0 below 15, else 1 + (v - 15) // 255."""
    return torch.where(v < 15, torch.zeros_like(v),
                       1 + torch.div(v - 15, 255, rounding_mode="floor"))


def _emit_layout(emit, pos, length, offset, n, out_cap: int):
    """Per-sequence output layout + covering-sequence map.

    Prefix sums turn the per-window match records into exact byte offsets —
    a cummax recovers each sequence's literal anchor (as in `_plan_size`), a
    cumsum over per-sequence byte sizes places every token — then one
    scatter of sequence ids at those starts plus a cummax over output
    positions yields `seg`, the covering-sequence index of every output
    byte.  The final literals-only sequence is appended as column W.

    emit/pos/length/offset : (M, W) per-window match records; n : (M,) int32.
    Returns (seg (M, out_cap) int32, fields (M, ref.N_FIELDS, W+1) int32,
    total (M,) int32).
    """
    emit = emit.to(torch.bool)
    pos = pos.to(torch.int32)
    length = length.to(torch.int32)
    offset = offset.to(torch.int32)
    n = n.to(torch.int32)
    M, W = emit.shape
    dev = emit.device
    zero = torch.zeros_like(pos)

    end = torch.where(emit, pos + length, zero)
    run_end = torch.cummax(end, dim=1).values
    anchor = torch.cat([zero[:, :1], run_end[:, :-1]], dim=1)
    lit = torch.where(emit, pos - anchor, zero)
    mlx = torch.where(emit, length - MIN_MATCH, zero)
    lit_ext = torch.where(emit, _ext_len(lit), zero)
    match_ext = torch.where(emit, _ext_len(mlx), zero)
    seq_size = torch.where(emit, 3 + lit_ext + lit + match_ext, zero)
    csum = torch.cumsum(seq_size, dim=1, dtype=torch.int32)
    starts = csum - seq_size

    final_start = csum[:, -1]
    final_anchor = run_end[:, -1]
    final_lit = n - final_anchor
    final_ext = _ext_len(final_lit)
    total = final_start + 1 + final_ext + final_lit

    zcol = torch.zeros((M,), dtype=torch.int32, device=dev)

    def app(a, v):
        return torch.cat([a.to(torch.int32), v[:, None]], dim=1)

    fields = torch.stack([
        app(starts, final_start),                      # F_START
        app(anchor, final_anchor),                     # F_ANCHOR
        app(lit, final_lit),                           # F_LIT
        app(lit_ext, final_ext),                       # F_LIT_EXT
        app(mlx, zcol),                                # F_MLX
        app(match_ext, zcol),                          # F_MATCH_EXT
        app(torch.where(emit, offset, zero), zcol),    # F_OFF
        app(emit.to(torch.int32), zcol),               # F_HAS_MATCH
    ], dim=1)

    # seg[k] = index of the sequence covering output byte k: scatter each
    # live sequence's id at its start (non-emitting windows have zero-size
    # sequences — their starts collide with a neighbour's, so they are
    # routed to one extra slot that is sliced off: scatter_reduce_ does not
    # drop out-of-range indices), then a cummax forward-fills.
    live = torch.cat([emit, torch.ones((M, 1), dtype=torch.bool, device=dev)],
                     dim=1)
    sidx = torch.where(live, fields[:, ref.F_START].to(torch.int64),
                       torch.full((), out_cap, dtype=torch.int64, device=dev))
    sidx = torch.clamp(sidx, 0, out_cap)
    ids = torch.arange(1, W + 2, dtype=torch.int32, device=dev).expand(M, W + 1)
    smap = torch.zeros((M, out_cap + 1), dtype=torch.int32, device=dev)
    smap.scatter_reduce_(1, sidx, ids, reduce="amax", include_self=True)
    seg = torch.cummax(smap[:, :out_cap], dim=1).values - 1
    return seg.contiguous(), fields.contiguous(), total.to(torch.int32)


def emit_bytes(blocks_u8, emit, pos, length, offset, n, out_cap: int):
    """Device-side LZ4 byte emission from per-window match records.

    blocks_u8 : (M, B) uint8 input blocks
    emit/pos/length/offset : (M, W) per-window match records (BlockRecords)
    n         : (M,) int32 true block lengths
    out_cap   : output buffer size per block; must exceed the worst-case
                compressed size (literals-only: MAX_BLOCK + 257 + 1)

    Returns ``(out, total)``: a (M, out_cap) uint8 buffer whose first
    `total[m]` bytes per row are the compressed block (bit-identical to
    `core.emitter.emit_block`, the host oracle) and the exact sizes.
    """
    seg, fields, total = _emit_layout(emit, pos, length, offset, n, out_cap)
    return emit_scatter(blocks_u8, seg, fields, total), total


# -- read path ----------------------------------------------------------------

def _span_map(starts, n_valid, out_cap: int):
    """Covering-span index per output position (scatter + cummax fill).

    The decode-side twin of `_emit_layout`'s seg map: scatter each live
    span's slot id at its start, then a cummax forward-fills so every output
    byte knows the last span that started at or before it.  Padding slots
    (index >= `n_valid`) and starts outside [0, out_cap) go to one sentinel
    slot that is sliced off (the reference drops them; `scatter_reduce_`
    does not drop out-of-range indices).

    starts : (M, S) int32;  n_valid : (M,) int32.
    Returns (M, out_cap) int32; -1 where no span has started yet.
    """
    M, S = starts.shape
    dev = starts.device
    slot = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    st = starts.to(torch.int64)
    live = (slot < n_valid.to(torch.int32)[:, None]) & (st >= 0) & (st < out_cap)
    idx = torch.where(live, st, torch.full_like(st, out_cap))
    smap = torch.zeros((M, out_cap + 1), dtype=torch.int32, device=dev)
    smap.scatter_reduce_(1, idx, (slot + 1).expand(M, S), reduce="amax",
                         include_self=True)
    return torch.cummax(smap[:, :out_cap], dim=1).values - 1


def decode_gather(blk_u8, lit_src, lit_dst, lit_len, match_dst, match_off,
                  n_lit, n_match, out_size, out_cap: int, rounds: int):
    """Device-side decode of a micro-batch of fixed-shape `DevicePlan`s.

    The read-path mirror of `emit_bytes`, with the same split of labour: the
    span layout (scatter + cummax covering maps, gathers of per-span fields)
    is stock torch; the pointer-doubling resolve and the byte gather are the
    `decode_wave` kernel.

    blk_u8    : (M, B) uint8 compressed payloads, zeroed past their length
    lit_*     : (M, L) int32 literal runs (src in block, dst in output,
                length); slots >= n_lit are padding
    match_*   : (M, Mm) int32 matches (dst in output, back-offset); slots
                >= n_match are padding
    n_lit, n_match, out_size : (M,) int32 (out_size 0 for padding rows)
    out_cap   : output row size (>= every out_size)
    rounds    : pointer-doubling rounds; `MAX_RESOLVE_ROUNDS` (16) covers
                every valid block, fewer suffice when the plans' `n_waves`
                say so

    Returns (M, out_cap) uint8 whose first out_size bytes per row are the
    decoded block (== `core.decode_plan.execute_plan`).
    """
    lit_blk, ptr = _decode_layout(lit_src, lit_dst, lit_len, match_dst,
                                  match_off, n_lit, n_match, out_size, out_cap)
    return decode_wave(blk_u8.contiguous(), lit_blk, ptr,
                       out_size.to(torch.int32).contiguous(), rounds)


def _decode_layout(lit_src, lit_dst, lit_len, match_dst, match_off, n_lit,
                   n_match, out_size, out_cap: int):
    """Per-output-byte source maps of `decode_gather` (stock torch): the
    literal source index ``lit_blk`` and the immediate source ``ptr`` (k for
    literal bytes and past out_size, k - offset for match bytes), both
    (M, out_cap) int32 and contiguous — the `decode_wave` kernel's inputs."""
    L = lit_src.shape[1]
    Mm = match_dst.shape[1]
    dev = lit_src.device
    k = torch.arange(out_cap, dtype=torch.int32, device=dev)[None, :]

    def take(a, i):
        return torch.gather(a, 1, i.to(torch.int64))

    li = _span_map(lit_dst, n_lit, out_cap)
    mi = _span_map(match_dst, n_match, out_cap)
    liC = torch.clamp(li, 0, L - 1)
    lit_dst_k = take(lit_dst, liC)
    lit_end = lit_dst_k + take(lit_len, liC)
    is_lit = (li >= 0) & (k < lit_end)
    in_range = k < out_size.to(torch.int32)[:, None]
    moff = take(match_off, torch.clamp(mi, 0, Mm - 1))
    # Literal bytes (and everything past out_size) are fixed points of the
    # source map; match bytes point back by their covering match's offset.
    ptr = torch.where(is_lit | ~in_range, k, k - moff)
    ptr = torch.clamp(ptr, 0, out_cap - 1)
    lit_blk = torch.where(is_lit, take(lit_src, liC) + (k - lit_dst_k),
                          torch.zeros_like(k))
    return lit_blk.contiguous(), ptr.contiguous()


# Buffer padding past the block cap: the speculative parser's 0xFF-run table
# is read at index n, so the payload row must be strictly longer than any
# payload.
SPEC_PAD = 128


def _compact(mask, values, cap: int):
    """Scatter ``values`` where ``mask`` holds to ordinal slots 0, 1, ... of
    a zeroed (M, cap) int32 column (scatter-max, so negative values leave 0,
    as the reference's scatter-max over zeros does); ordinals >= cap go to a
    sentinel slot that is sliced off.  Returns (column, count)."""
    M = mask.shape[0]
    m32 = mask.to(torch.int32)
    ords = torch.cumsum(m32, dim=1, dtype=torch.int32) - 1
    count = m32.sum(dim=1, dtype=torch.int32)
    idx = torch.where(mask, torch.clamp(ords, max=cap), torch.full_like(ords, cap))
    cols = []
    for v in values:
        z = torch.zeros((M, cap + 1), dtype=torch.int32, device=mask.device)
        z.scatter_reduce_(1, idx.to(torch.int64), v, reduce="amax",
                          include_self=True)
        cols.append(z[:, :cap])
    return cols, count


def plan_speculative(blk_u8, n, max_out, max_lit: int = 8448,
                     max_match: int = 8448, out_cap: int = 65536):
    """Parse a micro-batch of token streams into `DevicePlan` columns.

    The device-side replacement for `plan_block_fast` + `to_device_plan`:
    the `plan_speculative` kernel decodes a candidate header at every offset
    and selects the real chain; this stock-torch half validates the chain
    with the host planner's error codes (per header the lowest failing
    check, across headers the first bad one), lays out output offsets with
    a cumsum, and compacts the headers into fixed-shape plan columns with
    one scatter per column.  `plan_decode` no longer runs it (the
    `plan_layout` kernel lays out the output with no plan columns); it
    stays as the plan-column form of the JAX package's op, which the tests
    hold both to the reference and to `plan_layout`.

    blk_u8  : (M, B) uint8 payloads zeroed past n; B > every n (pad with
              `SPEC_PAD`)
    n       : (M,) int32 payload lengths;  max_out : (M,) int32 decoded-size
              limits (the host planner's `max_out`)

    Returns ``(lit_src, lit_dst, lit_len, match_dst, match_off, match_len,
    status)``: six zero-padded (M, cap) int32 columns, equal to
    ``to_device_plan(plan_block_fast(...))`` for valid streams, and the
    (M, SPEC_STATUS) int32 status (``SPEC_*`` lanes).  The columns are
    garbage where the status carries an error or an overflow.

    All arithmetic is int32 (``cumsum`` with ``dtype=torch.int32``: plain
    `torch.cumsum` would promote to int64).  Sums past the first bad header
    may wrap, as the reference's do; they never decide the selected error.
    """
    M, B = blk_u8.shape
    dev = blk_u8.device
    n = n.to(torch.int32)
    max_out = max_out.to(torch.int32)[:, None]
    is_start, lit_start, lit_len, ls_end, off, mlen, flags = plan_fields(
        blk_u8.contiguous(), n.contiguous())
    n1 = n[:, None]
    started = is_start > 0
    trunc_lx = (flags & 1) > 0
    trunc_mx = (flags & 2) > 0
    nonfinal = ls_end != n1
    zero = torch.zeros_like(lit_len)

    ll = torch.where(started, lit_len, zero)
    ml = torch.where(started & nonfinal, mlen, zero)
    contrib = ll + ml
    cum = torch.cumsum(contrib, dim=1, dtype=torch.int32)
    prev_total = cum - contrib
    before_match = prev_total + ll
    out_size = cum[:, -1]

    err = torch.zeros((M, B), dtype=torch.int32, device=dev)
    checks = (
        (trunc_lx, 1),                                   # truncated lit len
        (ls_end > n1, 2),                                # truncated literals
        (prev_total + lit_len > max_out, 3),             # output exceeds limit
        (nonfinal & (ls_end + 2 > n1), 4),               # truncated offset
        (nonfinal & (off == 0), 5),                      # zero offset
        (nonfinal & (off > before_match), 6),            # offset beyond output
        (nonfinal & trunc_mx, 7),                        # truncated match len
        (nonfinal & (before_match + mlen > max_out), 8),  # exceeds limit
    )
    for cond, code in checks:
        err = torch.where(started & cond & (err == 0),
                          torch.full_like(err, code), err)
    has_err = err > 0
    pos = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    first = torch.where(has_err, pos, torch.full_like(pos, B)).min(dim=1).values
    err_code = torch.gather(err, 1, first.clamp(max=B - 1)[:, None])[:, 0]
    err_code = torch.where(first < B, err_code, torch.zeros_like(err_code))
    final_ok = (started & (ls_end == n1)).any(dim=1)
    err_code = torch.where((err_code == 0) & ~final_ok,
                           torch.full_like(err_code, SPEC_ERR_MISSING_TOKEN),
                           err_code)

    (lit_src_o, lit_dst_o, lit_len_o), n_lit = _compact(
        started & (lit_len > 0), (lit_start, prev_total, lit_len), max_lit)
    (match_dst_o, match_off_o, match_len_o), n_match = _compact(
        started & nonfinal, (before_match, off, mlen), max_match)

    overflow = (n_lit > max_lit) | (n_match > max_match) | (out_size > out_cap)
    status = torch.stack([err_code, n_lit, n_match, out_size,
                          overflow.to(torch.int32)], dim=1)
    return (lit_src_o, lit_dst_o, lit_len_o, match_dst_o, match_off_o,
            match_len_o, status)


def plan_decode(blk_u8, n, max_out, out_cap: int, max_lit: int,
                max_match: int, rounds: int, compute_crc: bool = True):
    """Fused plan + execute (+ CRC) for a micro-batch, all on the device.

    Four kernels: `plan_speculative` (the header at every offset and the
    chain), `plan_layout` (the chain's checks, status and `decode_wave`'s
    source maps), `decode_wave` and, when `compute_crc`, `crc32`:
    compressed payloads in, decoded rows out, with no host parse and no
    stock op between the kernels.  The result equals `plan_speculative`
    below followed by `decode_gather`.  Rows whose status carries an error
    or a caps overflow decode to zeros (the caller raises or falls back
    from the status).

    Returns ``(out, status, crc)``: (M, out_cap) uint8 decoded rows, the
    (M, SPEC_STATUS) int32 status and (M,) int64 CRC-32 of each decoded row
    (zeros when `compute_crc` is off).
    """
    blk_u8 = blk_u8.contiguous()
    n = n.to(torch.int32).contiguous()
    max_out = max_out.to(torch.int32).contiguous()
    status, total, lit_blk, ptr = plan_layout(
        *plan_fields(blk_u8, n), n, max_out, max_lit=max_lit,
        max_match=max_match, out_cap=out_cap)
    out = decode_wave(blk_u8, lit_blk, ptr, total, rounds)
    crc = crc32(out, total) if compute_crc else torch.zeros(
        (out.shape[0],), dtype=torch.int64, device=out.device)
    return out, status, crc


def crc32_bytes(data_u8, n):
    """CRC-32 (== ``binascii.crc32``) of ``data_u8[m, :n[m]]`` per row.

    data_u8 : (M, K) uint8, or (K,) for one row;  n : (M,) int32 (or an int
    for one row).  Returns (M,) int64 holding the unsigned CRC (a 0-dim
    tensor for one row).  One `crc32` kernel launch for the whole batch.
    """
    one = data_u8.dim() == 1
    if one:
        data_u8 = data_u8[None]
    if not torch.is_tensor(n) or n.dim() == 0:
        n = torch.full((data_u8.shape[0],), int(n), dtype=torch.int32,
                       device=data_u8.device)
    crc = crc32(data_u8.contiguous(), n.to(torch.int32).contiguous())
    return crc[0] if one else crc
