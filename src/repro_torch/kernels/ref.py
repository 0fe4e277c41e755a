"""Plain PyTorch versions of the write-path kernels (the correctness references).

Every function here is batched: the leading axis ``M`` is the micro-batch of
blocks, and nothing is vmapped.  They run on whatever device their inputs
live on; on CPU tensors the kernel wrappers (`fused_compress.py`,
`emit_scatter.py`, `window_select.py`) dispatch to them, and on the card
they are what each hand-written kernel is held against.

All arithmetic is integer, so every comparison against these functions is
exact (tolerance zero).
"""
from __future__ import annotations

import torch

from repro_torch.core.lz4_types import HASH_PRIME, LAST_LITERALS, MF_LIMIT, MIN_MATCH

# Row layout of the per-sequence `fields` array consumed by the emit kernel
# (`emit_bytes_ref` here, `csrc/emit_scatter.cu` on the card).  One column
# per sequence: the W per-window sequences plus the final literals-only one.
F_START = 0       # output byte offset of the sequence's token
F_ANCHOR = 1      # input offset of the sequence's first literal
F_LIT = 2         # literal count
F_LIT_EXT = 3     # literal-length extension byte count
F_MLX = 4         # match length - MIN_MATCH (0 for the final sequence)
F_MATCH_EXT = 5   # match-length extension byte count
F_OFF = 6         # 16-bit match back-offset (0 for the final sequence)
F_HAS_MATCH = 7   # 1 where the sequence carries a match, 0 for the final one
N_FIELDS = 8

# Element budget of the (rows, W * E + 1) int32 hash-table-over-time grid that
# `scatter_candidates_ref` materializes; larger batches are processed in row
# chunks so the plain version's footprint stays bounded (the grid is 8 MB per
# block at hash_bits = 8 and 128 MB at 12).
_GRID_ELEMS = 1 << 25


def fibhash_ref(b0, b1, b2, b3, hash_bits: int):
    """Fibonacci hash of the little-endian 4-byte word at each position.

    b0..b3 are the byte streams shifted by 0..3 positions (any integer dtype,
    values in [0, 255]).  Returns ``(words, hashes)``: the word as the int32
    bit pattern of its uint32 value, and the hash in [0, 2^hash_bits).

    torch has no complete uint32, so the word lives in int64 and the 32-bit
    product ``(w * HASH_PRIME) mod 2^32`` is assembled from 16-bit halves —
    no intermediate leaves the int64 range.
    """
    w = (b0.to(torch.int64) | (b1.to(torch.int64) << 8)
         | (b2.to(torch.int64) << 16) | (b3.to(torch.int64) << 24))
    lo = (w & 0xFFFF) * HASH_PRIME
    hi = (((w >> 16) * HASH_PRIME) & 0xFFFF) << 16
    prod = (lo + hi) & 0xFFFFFFFF
    h = prod >> (32 - hash_bits)
    words = torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)
    return words, h.to(torch.int32)


def match_extend_ref(block, cand, valid, n, max_match: int):
    """Bounded extended-match length (the paper's feedforward S2 datapath).

    block : (M, B) byte values (any integer dtype)
    cand  : (M, P) int32 candidate position per position (garbage if ~valid)
    valid : (M, P) bool   4-byte match already confirmed at p
    n     : (M,) int32    true block lengths
    max_match : the match-length cap (paper: 36)

    Returns (M, P) int32 full match length (>= 4 where valid, 0 elsewhere),
    capped at max_match and at the end-of-block rule (match end <= n-5).
    """
    M, P = cand.shape
    B = block.shape[1]
    p = torch.arange(P, dtype=torch.int64, device=cand.device)[None, :]
    n = n.to(torch.int64)[:, None]
    cand = cand.to(torch.int64)
    max_extra = torch.clamp(n - LAST_LITERALS - (p + MIN_MATCH), 0,
                            max_match - MIN_MATCH)
    prefix = torch.ones((M, P), dtype=torch.bool, device=cand.device)
    length = torch.zeros((M, P), dtype=torch.int32, device=cand.device)
    for j in range(max_match - MIN_MATCH):
        cur = block[:, torch.clamp(p[0] + MIN_MATCH + j, 0, B - 1)]
        cnd = torch.gather(block, 1, torch.clamp(cand + MIN_MATCH + j, 0, B - 1))
        prefix = prefix & (cur == cnd) & (j < max_extra)
        length = length + prefix.to(torch.int32)
    return torch.where(valid, MIN_MATCH + length, torch.zeros_like(length))


def _scatter_candidates_chunk(hashes, n, hash_bits: int, pws: int):
    M, P = hashes.shape
    dev = hashes.device
    E = 1 << hash_bits
    W = P // pws
    p = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    valid_pos = p <= n.to(torch.int64)[:, None] - MIN_MATCH
    win = p // pws
    h = hashes.to(torch.int64)
    # Invalid positions go to one sentinel slot past the grid, sliced off
    # below (scatter_reduce_ does not drop out-of-range indices).
    key = torch.where(valid_pos, win * E + h, torch.full_like(h, W * E))
    table = torch.zeros((M, W * E + 1), dtype=torch.int32, device=dev)
    table.scatter_reduce_(1, key, (p + 1).to(torch.int32).expand(M, P),
                          reduce="amax", include_self=True)
    tm = table[:, : W * E].reshape(M, W, E)
    run_max = torch.cummax(tm, dim=1).values
    excl = torch.cat(
        [torch.zeros((M, 1, E), dtype=torch.int32, device=dev), run_max[:, :-1]],
        dim=1)
    idx = win * E + torch.clamp(h, 0, E - 1)
    cand = torch.gather(excl.reshape(M, W * E), 1, idx) - 1
    return torch.where(valid_pos, cand, torch.full_like(cand, -1))


def scatter_candidates_ref(hashes, n, hash_bits: int, pws: int):
    """Scatter-max last-value-table candidate resolution (no sort).

    cand(p) = max{q : hash(q)=hash(p), win(q)<win(p)}: scatter positions
    into a (windows x entries) grid — the hash table materialized over
    time — exclusive cummax along the window axis, gather at
    (win(p), hash(p)).  hashes: (M, P) int32, n: (M,) int32.
    Returns (M, P) int32, -1 where no candidate / invalid position.
    """
    M, P = hashes.shape
    per_row = (P // pws) * (1 << hash_bits) + 1
    rows = max(1, _GRID_ELEMS // per_row)
    if M <= rows:
        return _scatter_candidates_chunk(hashes, n, hash_bits, pws)
    return torch.cat([
        _scatter_candidates_chunk(hashes[i: i + rows], n[i: i + rows],
                                  hash_bits, pws)
        for i in range(0, M, rows)
    ])


def fused_ref(block, n, positions: int, hash_bits: int, pws: int,
              max_match: int):
    """Plain version of the fused compression datapath (fused_compress.cu).

    One expression of hash -> last-value-table candidate -> word compare ->
    bounded extension.

    block     : (M, B) byte values (uint8 or any integer dtype); content at
                index >= n is ignored (treated as zero); B >= positions +
                max_match (the padded compressor block)
    n         : (M,) int32 true block lengths
    positions : position count P (P % pws == 0)

    Returns ``(cand, lengths)``: (M, P) int32 candidate position (-1 where
    none/invalid) and full match length (0 where no valid match, else in
    [MIN_MATCH, max_match]).
    """
    P = positions
    M, B = block.shape
    dev = block.device
    idx = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    block = torch.where(idx < n.to(torch.int64)[:, None], block,
                        torch.zeros_like(block))
    words, hashes = fibhash_ref(block[:, :P], block[:, 1: P + 1],
                                block[:, 2: P + 2], block[:, 3: P + 3],
                                hash_bits)
    p = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    cand = scatter_candidates_ref(hashes, n, hash_bits, pws)
    wc = torch.gather(words, 1, torch.clamp(cand.to(torch.int64), 0, P - 1))
    valid4 = (cand >= 0) & (wc == words) \
        & (p <= n.to(torch.int64)[:, None] - MF_LIMIT)
    lengths = match_extend_ref(block, cand, valid4, n, max_match)
    return cand, lengths


def emit_bytes_ref(block, seg, fields, total):
    """LZ4 byte materialization: (output position -> byte) via gathers.

    The inverse-scatter formulation of block emission: instead of scattering
    each sequence's ragged pieces into the output (variable-length writes),
    every output position k looks up its covering sequence `seg[k]` and
    derives its byte from the relative offset r = k - start alone:

        r == 0                         -> token
        1 <= r <= lit_ext              -> literal-length extension byte
        lit_ext < r <= lit_ext + lit   -> literal (one gather from the input)
        r == 1 + lit_ext + lit         -> offset low byte
        r == 2 + lit_ext + lit         -> offset high byte
        r beyond                       -> match-length extension byte

    block  : (M, B) input byte values (uint8 or any integer dtype)
    seg    : (M, K) int32 covering-sequence index per output position
    fields : (M, N_FIELDS, S) int32 per-sequence layout (see F_* rows above)
    total  : (M,) int32 exact compressed size; positions >= total emit 0

    Returns (M, K) uint8, bit-identical to `core.emitter.emit_block` on
    ``out[:total]``.
    """
    M, K = seg.shape
    B = block.shape[1]
    S = fields.shape[2]
    k = torch.arange(K, dtype=torch.int64, device=seg.device)[None, :]
    sg = torch.clamp(seg.to(torch.int64), 0, S - 1)
    f = fields.to(torch.int64)
    st, anc, lit, le, mlx, me, off, hm = (
        torch.gather(f[:, row], 1, sg) for row in range(N_FIELDS))

    r = k - st
    zero = torch.zeros_like(r)
    token = (torch.clamp(lit, max=15) << 4) \
        | torch.where(hm > 0, torch.clamp(mlx, max=15), zero)
    # Extension runs are (count-1) bytes of 255 followed by (value-15) % 255
    # (torch's % floors, like the reference's).
    ff = torch.full_like(r, 255)
    lit_ext_byte = torch.where(r < le, ff, (lit - 15) % 255)
    src = torch.clamp(anc + r - 1 - le, 0, B - 1)
    lit_byte = torch.gather(block, 1, src).to(torch.int64)
    lit_end = 1 + le + lit
    mext_byte = torch.where(r - (lit_end + 2) < me - 1, ff, (mlx - 15) % 255)
    b = torch.where(r == 0, token,
        torch.where(r <= le, lit_ext_byte,
        torch.where(r <= le + lit, lit_byte,
        torch.where(r == lit_end, off & 0xFF,
        torch.where(r == lit_end + 1, (off >> 8) & 0xFF, mext_byte)))))
    b = torch.where(k < total.to(torch.int64)[:, None], b, zero)
    return (b & 0xFF).to(torch.uint8)


def window_select_ref(valid, lengths, pws: int):
    """Paper-faithful window scan: one step per window, free-pointer carry.

    The plain version of `csrc/window_select.cu`: a Python loop over the
    W = P // pws windows, vectorized over the batch.  Per window the
    earliest eligible position (valid and >= the free pointer) is selected
    and the free pointer jumps past its match; a window with no eligible
    position reports its base position and the raw length there.

    valid   : (M, P) bool   position carries a usable match
    lengths : (M, P) int32  match length per position
    Returns ``(emit (M, W) bool, pos (M, W) int32, length (M, W) int32)``.
    """
    M, P = valid.shape
    W = P // pws
    dev = valid.device
    validw = valid.to(torch.bool).reshape(M, W, pws)
    lenw = lengths.to(torch.int32).reshape(M, W, pws)
    rel = torch.arange(pws, dtype=torch.int32, device=dev)[None, :]
    emit = torch.zeros((M, W), dtype=torch.bool, device=dev)
    pos = torch.zeros((M, W), dtype=torch.int32, device=dev)
    length = torch.zeros((M, W), dtype=torch.int32, device=dev)
    fp = torch.zeros((M,), dtype=torch.int32, device=dev)
    for w in range(W):
        base = w * pws
        elig = validw[:, w] & (rel + base >= fp[:, None])
        any_e = elig.any(dim=1)
        idx = torch.argmax(elig.to(torch.uint8), dim=1)
        sel_pos = (idx + base).to(torch.int32)
        sel_len = torch.gather(lenw[:, w], 1, idx[:, None])[:, 0]
        fp = torch.where(any_e, sel_pos + sel_len, fp)
        emit[:, w] = any_e
        pos[:, w] = sel_pos
        length[:, w] = sel_len
    return emit, pos, length
