"""Batched PyTorch engine of the paper's combined scheme (S1 + S2).

The Hopper re-expression of the hardware architecture in Fig. 5 (the JAX
package's counterpart is `core/jax_compressor.py`).  Two datapaths compute
the same match records, selected by ``candidate_impl``:

  fused (``"auto"``, ``"fused"``) — Word Shift + Hash Calculation, Hash
        Table (last-value table, multi-port), Match Searching, Extended
        Match (bounded, S2) in ONE kernel, `kernels.ops.fused_match_candidates`
        (csrc/fused_compress.cu on the card, `kernels.ref.fused_ref` on the
        CPU): cand(p) = max{q : hash(q)=hash(p), window(q)<window(p)} plus
        the bounded match length, no sort anywhere.
  staged (``"sort"``, ``"sortkey"``, ``"scatter"``) — the same stages one
        at a time: `kernels.ops.hash_positions` (csrc/fibhash.cu), a
        candidate stage in stock torch ops (argsort, a sort of packed keys,
        or the scatter-max grid of `kernels.ref.scatter_candidates_ref`),
        the 4-byte word compare, and `kernels.ops.match_lengths`
        (csrc/match_extend.cu).
  single-match select (S1)
        -> per-window earliest-eligible selection.  The only true
           sequential state is the free pointer; S2 bounds its reach to
           max_match-1 bytes, so it admits BOTH
             * the paper-faithful window scan (`scan_impl="sequential"`:
               csrc/window_select.cu on the card, a Python loop on the CPU),
             * a log-depth composition of per-window transfer tables of size
               R = max_match (`scan_impl="associative"`, stock torch ops).
  Sequence Encoding
        -> exact compressed size (`_plan_size`) and, on the default engine
           path, byte emission on the device (`compress_blocks_bytes` ->
           `kernels.ops.emit_bytes`); the host emitter (`emitter.py`) stays
           as the bit-identity oracle.

Every function takes a micro-batch: tensors carry an explicit leading axis
``M`` and run on the device their inputs live on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels.ref import scatter_candidates_ref
from repro_torch.kernels.window_select import window_select

from .lz4_types import (
    DEFAULT_HASH_BITS,
    DEFAULT_MAX_MATCH,
    DEFAULT_PWS,
    MAX_BLOCK,
    MF_LIMIT,
    MIN_MATCH,
    Sequence,
)

_PAD = 71  # block padding: max max_match (68) + 3 word-shift bytes

# Candidate-resolution implementations: the staged ones and the fused
# single-pass datapath.  All give the same match records.
CANDIDATE_IMPLS = ("sort", "sortkey", "scatter", "fused")

# The span factory of callers that trace nothing.
_NO_SPANS = obs.span_factory(False)

# Device-emit output buffer size per block.  The worst case compressed block
# is literals-only: 1 token + 257 extension bytes + MAX_BLOCK literals =
# MAX_BLOCK + 258; the buffer keeps the reference's size so the two packages'
# `host_bytes` counters agree.
OUT_CAP = MAX_BLOCK + 2048


def resolve_candidate_impl(candidate_impl: str = "auto") -> str:
    """Resolve ``"auto"`` to the implementation that runs.

    ``"auto"`` runs the fused datapath (the hand kernel on the card, its
    plain version on the CPU).  Concrete names pass through unchanged, so a
    caller can always pin one: ``"sort"``, ``"sortkey"`` and ``"scatter"``
    run the staged path.
    """
    if candidate_impl == "auto":
        return "fused"
    if candidate_impl not in CANDIDATE_IMPLS:
        raise ValueError(
            f"candidate_impl must be 'auto' or one of {CANDIDATE_IMPLS}, "
            f"got {candidate_impl!r}")
    return candidate_impl


@dataclasses.dataclass(frozen=True)
class BlockRecords:
    """Per-window match records of a micro-batch — the hardware's output signals."""

    emit: torch.Tensor     # (M, W) bool
    pos: torch.Tensor      # (M, W) int32
    length: torch.Tensor   # (M, W) int32
    offset: torch.Tensor   # (M, W) int32
    size: torch.Tensor     # (M,) int32 — exact compressed size of each block


def _wrap_int32(x):
    """int64 -> int32 with two's-complement wrap-around (what int32
    arithmetic in the reference does on overflow)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _shift_right(x, fill: int):
    """x[:, i-1] at column i, `fill` at column 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _sorted_key(hashes, n, hash_bits: int):
    """Per position the sort key ``h * P + p`` in int32, as the reference
    forms it: positions without a full 4-byte word take the sentinel bucket
    ``1 << hash_bits`` (they can neither find nor become candidates), and the
    product wraps — at hash_bits 16 the sentinel's key is p itself."""
    M, P = hashes.shape
    p = torch.arange(P, dtype=torch.int64, device=hashes.device)[None, :]
    valid_pos = p <= n.to(torch.int64)[:, None] - MIN_MATCH
    h = torch.where(valid_pos, hashes, torch.full_like(hashes, 1 << hash_bits))
    return h, _wrap_int32(h.to(torch.int64) * P + p)


def _resolve_groups(h_s, p_s, pws: int):
    """Candidates in sorted order: within a run of equal hashes, a window's
    positions all take the last position of the run's previous window."""
    M, P = h_s.shape
    w_s = torch.div(p_s, pws, rounding_mode="floor")
    prev_h, prev_w, prev_p = (_shift_right(x, -1) for x in (h_s, w_s, p_s))
    same_hash = h_s == prev_h
    head = ~(same_hash & (w_s == prev_w))
    group_id = (torch.cumsum(head.to(torch.int32), dim=1, dtype=torch.int32)
                - 1).to(torch.int64)
    head_cand = torch.where(head & same_hash, prev_p, torch.full_like(prev_p, -1))
    # Each group has exactly one head: scatter its candidate, gather back.
    group_val = torch.zeros((M, P), dtype=torch.int32, device=h_s.device)
    group_val.scatter_add_(1, group_id, torch.where(
        head, head_cand + 1, torch.zeros_like(head_cand)).to(torch.int32))
    return torch.gather(group_val, 1, group_id) - 1


def _candidates(hashes, n, hash_bits: int, pws: int):
    """Sort-based last-value-table candidate resolution (argsort of the
    packed key).  hashes (M, P) int32, n (M,) int32 -> (M, P) int32."""
    h, key = _sorted_key(hashes, n, hash_bits)
    order = torch.argsort(key, dim=1, stable=True)
    cand_s = _resolve_groups(torch.gather(h, 1, order), order.to(torch.int32), pws)
    return torch.zeros_like(hashes).scatter_(1, order, cand_s)


def _candidates_sortkey(hashes, n, hash_bits: int, pws: int):
    """Key-packed sort candidate resolution: sort the int32 keys themselves
    and recover hash and position by bit operations, as the reference does
    (``key >> 16`` arithmetic, ``key & (P - 1)``)."""
    P = hashes.shape[1]
    if P & (P - 1):
        raise ValueError(f"key packing requires a power-of-two P, got {P}")
    _, key = _sorted_key(hashes, n, hash_bits)
    skey = torch.sort(key, dim=1).values
    p_s = skey & (P - 1)
    cand_s = _resolve_groups(skey >> 16, p_s, pws)
    return torch.zeros_like(hashes).scatter_(1, p_s.to(torch.int64), cand_s)


_CANDIDATE_FNS = {"sort": _candidates, "sortkey": _candidates_sortkey,
                  # the scatter-max grid that the fused datapath's plain
                  # version shares, so the two cannot drift
                  "scatter": scatter_candidates_ref}


def staged_candidates(blocks_u8, ns, candidate_impl: str, hash_bits: int,
                      pws: int):
    """The staged datapath up to the extension: hash -> candidates -> word
    compare.

    blocks_u8 : (M, MAX_BLOCK + _PAD) uint8; ns : (M,) int32.
    Returns ``(block, cand, valid4)``: the blocks with every byte at or past
    n zeroed (what the reference hashes and extends over), the (M, MAX_BLOCK)
    int32 candidates and the bool mask of positions whose 4-byte word equals
    their candidate's and where a match may start.
    """
    M, B = blocks_u8.shape
    dev = blocks_u8.device
    # Zero the padding region so it can never fake matches past n.
    idx = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    block = torch.where(idx < ns[:, None], blocks_u8, torch.zeros_like(blocks_u8))
    words, hashes = ops.hash_positions(block, hash_bits, positions=MAX_BLOCK)
    cand = _CANDIDATE_FNS[candidate_impl](hashes, ns, hash_bits, pws)
    p = torch.arange(MAX_BLOCK, dtype=torch.int32, device=dev)[None, :]
    wc = torch.gather(words, 1, torch.clamp(cand, 0, MAX_BLOCK - 1).to(torch.int64))
    valid4 = (cand >= 0) & (wc == words) & (p <= ns[:, None] - MF_LIMIT)
    return block, cand, valid4


def _select_sequential(valid, lengths, pws: int):
    """Paper-faithful window scan: one step per window, free-pointer carry."""
    return window_select(valid, lengths, pws)


def _select_associative(valid, lengths, pws: int, max_match: int):
    """Beyond-paper: compose per-window free-pointer transfer tables.

    S2 bounds the free pointer entering window w to [ws, ws + R) with
    R = max_match (fp' = p + len <= ws-1 + max_match).  Each window is a
    monotone step-function on R states; composition is exact and
    associative, so a log-step (Hillis-Steele) prefix composition gives the
    free pointer entering every window in ceil(log2 W) rounds of gathers.
    """
    M, P = valid.shape
    W = P // pws
    R = max_match  # entering fp - window_start is in [0, R)
    dev = valid.device
    validw = valid.to(torch.bool).reshape(M, W, pws)
    lenw = lengths.to(torch.int32).reshape(M, W, pws)
    base = (torch.arange(W, dtype=torch.int32, device=dev) * pws)[None, :, None]
    rel = torch.arange(pws, dtype=torch.int32, device=dev)[None, None, :]

    # Transfer table: for entering fp = ws + r, the resulting absolute fp'.
    r = torch.arange(R, dtype=torch.int32, device=dev)
    elig = validw[:, :, None, :] & (rel[:, :, None, :] >= r[None, None, :, None])
    any_e = elig.any(-1)                                        # (M, W, R)
    idx = torch.argmax(elig.to(torch.uint8), dim=-1)            # (M, W, R)
    sel_end = base + idx.to(torch.int32) + torch.gather(lenw, 2, idx)
    table = torch.where(any_e, sel_end, base + r[None, None, :])

    # Inclusive prefix composition.  After the round with stride d, entry w
    # maps the fp entering window max(0, w - 2d + 1) to the fp leaving
    # window w; `tbase` is that first window's start.  The exit fp of the
    # earlier part is < (later part's base) + R by the S2 bound, so the
    # clamp below is exact, not an approximation.
    tbase = base[0, :, 0].clone()                               # (W,)
    d = 1
    while d < W:
        r2 = torch.clamp(table[:, :-d] - tbase[None, d:, None], 0, R - 1)
        composed = torch.gather(table[:, d:], 2, r2.to(torch.int64))
        table = torch.cat([table[:, :d], composed], dim=1)
        tbase = torch.cat([tbase[:d], tbase[:-d]])
        d *= 2
    # Entering fp for window w = prefix over [0..w-1] evaluated at r = 0.
    entering = torch.cat(
        [torch.zeros((M, 1), dtype=torch.int32, device=dev), table[:, :-1, 0]],
        dim=1)
    # Reconstruct the selection for every window in parallel.
    rw = torch.clamp(entering[:, :, None] - base, 0, R - 1)     # (M, W, 1)
    elig_w = validw & (rel >= rw)
    emit = elig_w.any(-1)
    idxw = torch.argmax(elig_w.to(torch.uint8), dim=-1)         # (M, W)
    pos = base[:, :, 0] + idxw.to(torch.int32)
    length = torch.gather(lenw, 2, idxw[:, :, None])[:, :, 0]
    return emit, pos, length


def _lit_ext(x):
    return torch.where(x < 15, torch.zeros_like(x),
                       1 + torch.div(x - 15, 255, rounding_mode="floor"))


def _match_ext(l):
    return _lit_ext(l - MIN_MATCH)


def _plan_size(emit, pos, length, n):
    """Exact compressed size from per-window match records ((M, W) -> (M,))."""
    zero = torch.zeros_like(pos)
    end = torch.where(emit, pos + length, zero)
    run_end = torch.cummax(end, dim=1).values
    prev_end = torch.cat([zero[:, :1], run_end[:, :-1]], dim=1)
    lit = pos - prev_end
    per = torch.where(emit, 1 + _lit_ext(lit) + lit + 2 + _match_ext(length),
                      zero)
    final_lit = n.to(torch.int32) - run_end[:, -1]
    total = per.sum(dim=1, dtype=torch.int32) + 1 + _lit_ext(final_lit) + final_lit
    return total.to(torch.int32)


def _match_records(blocks_u8, ns, hash_bits: int, max_match: int, pws: int,
                   scan_impl: str, candidate_impl: str, sp):
    """The candidate and select stages of a micro-batch: ``(ns, cand, emit,
    pos, length)`` with ``ns`` as int32."""
    if blocks_u8.dim() != 2 or blocks_u8.shape[1] != MAX_BLOCK + _PAD:
        raise ValueError(f"expected (M, {MAX_BLOCK + _PAD}) blocks, got "
                         f"{tuple(blocks_u8.shape)}")
    candidate_impl = resolve_candidate_impl(candidate_impl)
    if scan_impl not in ("sequential", "associative"):
        raise ValueError(scan_impl)
    ns = ns.to(torch.int32)

    with sp("compress.candidates"):
        if candidate_impl == "fused":
            # Single-pass datapath: hash, candidate, word compare and the
            # bounded extension come back from ONE kernel — no intermediate
            # hash/word arrays.
            cand, lengths = ops.fused_match_candidates(
                blocks_u8, ns, positions=MAX_BLOCK, hash_bits=hash_bits,
                pws=pws, max_match=max_match)
            valid = lengths >= MIN_MATCH
        else:
            block, cand, valid4 = staged_candidates(
                blocks_u8, ns, candidate_impl, hash_bits, pws)
            lengths = ops.match_lengths(block, cand, valid4, ns,
                                        max_match=max_match)
            valid = valid4 & (lengths >= MIN_MATCH)

    with sp("compress.select"):
        if scan_impl == "sequential":
            emit, pos, length = _select_sequential(valid, lengths, pws)
        else:
            emit, pos, length = _select_associative(valid, lengths, pws,
                                                    max_match)
    return ns, cand, emit, pos, length


def _records(ns, cand, emit, pos, length) -> BlockRecords:
    """The selected windows as match records, with each block's exact size."""
    # `pos` is a real position for every window (the window base where
    # nothing was eligible), so the gather needs no clamp.
    offset = pos - torch.gather(cand, 1, pos.to(torch.int64))
    emit = emit & (length > 0)
    size = _plan_size(emit, pos, length, ns)
    zero = torch.zeros_like(pos)
    return BlockRecords(
        emit=emit,
        pos=torch.where(emit, pos, torch.full_like(pos, -1)),
        length=torch.where(emit, length, zero),
        offset=torch.where(emit, offset, zero),
        size=size,
    )


def compress_blocks_records(
    blocks_u8,
    ns,
    hash_bits: int = DEFAULT_HASH_BITS,
    max_match: int = DEFAULT_MAX_MATCH,
    pws: int = DEFAULT_PWS,
    scan_impl: str = "sequential",
    candidate_impl: str = "auto",
    sp=_NO_SPANS,
) -> BlockRecords:
    """Compress a micro-batch of padded blocks to per-window match records.

    blocks_u8 : (M, MAX_BLOCK + _PAD) uint8 (content beyond `ns` is ignored)
    ns        : (M,) int32 true lengths (0 <= n <= MAX_BLOCK)
    sp        : span factory for the stages' spans (``compress.candidates``,
                ``.select``, ``.emit``); none recorded by default
    """
    stages = _match_records(blocks_u8, ns, hash_bits, max_match, pws,
                            scan_impl, candidate_impl, sp)
    with sp("compress.emit"):
        return _records(*stages)


def compress_blocks_bytes(
    blocks_u8,
    ns,
    hash_bits: int = DEFAULT_HASH_BITS,
    max_match: int = DEFAULT_MAX_MATCH,
    pws: int = DEFAULT_PWS,
    scan_impl: str = "sequential",
    candidate_impl: str = "auto",
    out_cap: int = OUT_CAP,
    sp=_NO_SPANS,
):
    """Compress a micro-batch of padded blocks to FINAL BYTES on the device.

    The device-resident emit path: the match-record pipeline of
    `compress_blocks_records` feeds straight into `kernels.ops.emit_bytes` —
    token byte-lengths, exclusive prefix-sum offsets and the byte scatter all
    stay on the device, so the only host transfer per block is its slice of
    the (M, out_cap) uint8 output plus a size scalar.  ``sp`` as for
    `compress_blocks_records`.

    Returns ``(out, size)``: ``out[m, :size[m]]`` is block m's compressed
    bytes, bit-identical to ``emitter.emit_block(...)`` on the same records.
    """
    ns, *stages = _match_records(blocks_u8, ns, hash_bits, max_match, pws,
                                 scan_impl, candidate_impl, sp)
    with sp("compress.emit"):
        rec = _records(ns, *stages)
        # The stages' tensors (cand alone is 4 bytes a position) are freed
        # before the emit kernel's output is allocated.
        del stages
        return ops.emit_bytes(blocks_u8, rec.emit, rec.pos, rec.length,
                              rec.offset, ns, out_cap=out_cap)


def compress_block_records(block_u8, n, **kw) -> BlockRecords:
    """Single-block form of `compress_blocks_records` (adds and strips M=1)."""
    dev = block_u8.device
    rec = compress_blocks_records(
        block_u8[None], torch.as_tensor([int(n)], dtype=torch.int32, device=dev),
        **kw)
    return BlockRecords(rec.emit[0], rec.pos[0], rec.length[0], rec.offset[0],
                        rec.size[0])


def compress_block_bytes(block_u8, n, **kw):
    """Single-block form of `compress_blocks_bytes` (adds and strips M=1)."""
    dev = block_u8.device
    out, size = compress_blocks_bytes(
        block_u8[None], torch.as_tensor([int(n)], dtype=torch.int32, device=dev),
        **kw)
    return out[0], size[0]


def pad_block(data: bytes) -> tuple[np.ndarray, int]:
    buf = np.zeros(MAX_BLOCK + _PAD, dtype=np.uint8)
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf, len(data)


def records_to_plan(rec: BlockRecords, n: int) -> list[Sequence]:
    """Host-side: one block's per-window records -> sequence plan."""
    emit, pos, length, offset = (
        np.asarray(t.cpu()) for t in (rec.emit, rec.pos, rec.length, rec.offset))
    plan: list[Sequence] = []
    anchor = 0
    for w in np.nonzero(emit)[0]:
        plan.append(Sequence(anchor, int(pos[w]) - anchor, int(length[w]), int(offset[w])))
        anchor = int(pos[w]) + int(length[w])
    plan.append(Sequence(anchor, n - anchor))
    return plan


def compress_bytes(
    data: bytes,
    hash_bits: int = DEFAULT_HASH_BITS,
    max_match: int = DEFAULT_MAX_MATCH,
    use_pallas: bool = False,
    scan_impl: str = "sequential",
    device=None,
) -> list[bytes]:
    """Deprecated: use :class:`repro_torch.core.engine.LZ4Engine`.

    Thin compatibility wrapper over the batched engine; still returns the
    historical list-of-raw-LZ4-blocks shape (no frame, no passthrough).
    ``use_pallas`` is accepted for the reference's signature and has no
    effect (the port has no Pallas).  ``device`` is the engine's: the card
    by default, ``"cpu"`` for the plain versions.
    """
    import warnings

    from .engine import LZ4Engine

    warnings.warn(
        "compress_bytes is deprecated; use LZ4Engine.compress (framed) or "
        "LZ4Engine.compress_to_blocks", DeprecationWarning, stacklevel=2,
    )
    eng = LZ4Engine(hash_bits=hash_bits, max_match=max_match, scan_impl=scan_impl,
                    device=device)
    return eng.compress_to_blocks(data)
