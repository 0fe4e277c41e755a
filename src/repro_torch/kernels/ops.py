"""Write-side ops: stock torch layout stages + dispatch to the hand kernels.

Counterpart of the JAX package's `kernels/ops.py` for the write path.  The
prefix-sum / scatter layout stages that the reference leaves to XLA stay
stock torch ops here (`torch.cummax`, `torch.cumsum`, `scatter_reduce_`);
the kernels proper are reached through their wrappers, which launch the
CUDA kernel for tensors on the card and run the plain version for tensors
on the CPU.  Everything is batched over a leading ``M`` axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.lz4_types import MIN_MATCH

from . import ref
from .emit_scatter import emit_scatter
from .fused_compress import fused_compress


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
